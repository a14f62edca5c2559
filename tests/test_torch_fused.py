"""K5 and the fused multi-query driver of the port against ``repro``.

* ``frontier_fused_masks_plain`` equals ``repro``'s oracle
  ``ref.frontier_fused_masks_ref`` and its Pallas kernel run in interpret
  mode, on inputs made from a seed with numpy (mixed k, PAD rows, a member
  with zero fan-out, a hub row past the first 8-row block); every value is
  an integer, so equality is exact (tolerance 0).
* ``ops.frontier_expand_fused`` equals ``repro``'s array for array.
* K5's hop entry: its plain version ``frontier_fused_hop_plain`` equals
  the CPU route the fused expand ran before the entry existed (masks,
  ``compact``, ``children``, per-member ``scatter_add_``, ``wantc``
  suppression), output for output, and a step-by-step emulation of the
  CUDA write launch's order (block totals, block scan, ballots) and of
  the count launch's per-member sums equals the plain version.
* ``enumerate_fused_device`` on the CPU equals ``repro``'s solo host
  ``enumerate_paths_idx`` per member: paths and order, count, every stats
  field (``chunks`` included) and ``exhausted``, on the full, count-only,
  ``first_n`` and expired-deadline legs, and with fan-out segments forced.
* A fused run dispatches fewer times than the members' solo chunks.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.frontier_expand import frontier_fused_masks as jax_fused
from repro_torch.core import clock as tclock
from repro_torch.core import enumerate as ten
from repro_torch.core import fused as tfused
from repro_torch.core.index import LightweightIndex
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PAD = -1
CHUNK = 7
T = torch.from_numpy


def _port_index(jidx):
    return LightweightIndex.from_numpy(dataclasses.asdict(jidx),
                                       device="cpu")


def _assert_result(want, got, tag=""):
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag
    assert got.as_tuples() == want.as_tuples(), tag
    np.testing.assert_array_equal(got.paths, want.paths, err_msg=tag)
    np.testing.assert_array_equal(got.lengths, want.lengths, err_msg=tag)


def _synthetic(m, seed):
    """Packed rows of ``m`` members with mixed k, a zero-fan-out member, a
    hub row in the second 8-row block and trailing PAD rows."""
    rng = np.random.default_rng(seed)
    n, max_deg = 16, 8
    ks = [int(rng.integers(2, 6)) for _ in range(m)]
    k1max = max(ks) + 1
    begins, ends, dsts = [], [], []
    for i, k in enumerate(ks):
        mf = int(rng.integers(max_deg, 40))
        b = rng.integers(0, mf, n).astype(np.int32)
        steps = np.sort(rng.integers(0, max_deg, (n, k + 1)), axis=1)
        e = np.minimum(b[:, None] + steps, mf).astype(np.int32)
        if i == m - 1 and m > 1:
            e[:] = b[:, None]                  # zero fan-out member
        begins.append(b)
        ends.append(e)
        dsts.append(rng.integers(0, n, mf).astype(np.int32))
    rows = 12
    C = 16
    paths = np.full((C, k1max), PAD, np.int32)
    rank = np.zeros(C, np.int32)
    rank[:rows] = np.sort(rng.integers(0, m, rows))
    depthv = np.array([rng.integers(0, k) for k in ks], np.int32)
    tvec = rng.integers(0, n, m).astype(np.int32)
    for r in range(rows):
        i = rank[r]
        d = depthv[i]
        paths[r, :d + 1] = rng.integers(0, n, d + 1)
        if r % 3 == 0 and d > 0:
            paths[r, d] = paths[r, 0]          # a prefix duplicate
    # the hub row: the first row past the first 8-row block of a member
    # with fan-out, given the widest fan-out (max_deg candidates)
    r = next(r for r in range(8, rows) if m == 1 or rank[r] != m - 1)
    i, v = int(rank[r]), 5
    begins[i][v] = 0
    ends[i][v, :] = max_deg
    paths[r, depthv[i]] = v
    return paths, rank, tvec, depthv, begins, ends, dsts, max_deg


@pytest.mark.parametrize("m,seed", [(1, 0), (3, 1), (5, 2), (5, 3)])
def test_fused_masks_plain_equals_repro(m, seed):
    paths, rank, tvec, depthv, begins, ends, dsts, max_deg = \
        _synthetic(m, seed)
    got = fe.frontier_fused_masks(
        T(paths), T(rank), T(tvec), T(depthv), [T(x) for x in begins],
        [T(x) for x in ends], [T(x) for x in dsts], max_deg=max_deg)
    plain = fe.frontier_fused_masks_plain(
        T(paths), T(rank), T(tvec), T(depthv), [T(x) for x in begins],
        [T(x) for x in ends], [T(x) for x in dsts], max_deg=max_deg)
    flat = fe.fused_flat_tables(T(depthv), [T(x) for x in begins],
                                [T(x) for x in ends], [T(x) for x in dsts])
    args = tuple(jnp.asarray(a) for a in
                 (paths, rank, tvec, depthv, *(x.numpy() for x in flat)))
    want = ref.frontier_fused_masks_ref(*args, max_deg=max_deg)
    refs = [want]
    if m == 3:
        refs.append(jax_fused(*args, max_deg=max_deg, interpret=True))
    for w in refs:
        for name, a, b, c in zip(("vnew", "emit", "cont", "counters"),
                                 w, got, plain):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
            np.testing.assert_array_equal(np.asarray(a), c.numpy(), name)
    counters = got[3].numpy()
    assert counters.shape == (m, 4)
    assert counters[:, 0].sum() > 0
    if m > 1:
        assert (counters[m - 1, :2] == 0).all()   # the zero-fan-out member


def _members(jg, queries):
    jidxs = [rc.build_index(jg, s, t, k) for s, t, k in queries]
    return jidxs, [_port_index(j) for j in jidxs]


def _graph():
    return rc.erdos_renyi(40, 5.0, seed=17)


QUERIES = [(0, 39, 4), (1, 38, 4), (2, 37, 3), (3, 36, 5)]


def test_expand_fused_equals_repro():
    """One fused hop of mixed-depth, mixed-k chunks, array for array."""
    jidxs, idxs = _members(_graph(), QUERIES)
    chunks, depths = [], []
    for idx, d in zip(idxs, (0, 1, 1, 2)):
        paths = np.full((1, idx.k + 1), PAD, np.int32)
        paths[0, 0] = idx.s
        for dd in range(d):
            exp = ten._expand_chunk(idx, paths, dd, ten.EnumStats())
            parent, _pos, vnew, _emit, cont = exp
            sel = np.nonzero(cont)[0]
            paths = paths[parent[sel]].copy()
            paths[:, dd + 1] = vnew[sel]
        chunks.append(paths[:5])
        depths.append(d)
    k1max = max(i.k for i in idxs) + 1
    packed = np.concatenate([np.pad(c, ((0, 0), (0, k1max - c.shape[1])),
                                    constant_values=PAD) for c in chunks])
    rank = np.concatenate([np.full(c.shape[0], i, np.int32)
                           for i, c in enumerate(chunks)])
    tvec = np.array([i.t for i in idxs], np.int32)
    depthv = np.array(depths, np.int32)
    wantc = np.array([d + 1 < i.k for d, i in zip(depths, idxs)])
    wantc[0] = False                  # a suppressed continue leg
    devs = [i.device_arrays() for i in idxs]
    begins = [d.begin for d in devs]
    ends = [d.end for d in devs]
    dsts = [d.dst for d in devs]
    max_deg = max(int((idx.fwd_end[c[:, d], idx.k - d - 1]
                       - idx.fwd_begin[c[:, d]]).max())
                  for idx, c, d in zip(idxs, chunks, depths))
    got = ops.frontier_expand_fused(packed, rank, tvec, depthv, begins, ends,
                                    dsts, wantc, max_deg=max_deg)
    flat = fe.fused_flat_tables(torch.from_numpy(depthv), begins, ends, dsts)
    want = jops.frontier_expand_fused(
        packed, rank, tvec, depthv, *(jnp.asarray(x.numpy()) for x in flat),
        wantc, max_deg=max_deg)
    for name, a, b in zip(("emit_rows", "cont_rows", "n_emit_m", "n_cont_m",
                           "counters"), want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
    assert int(got[3][0]) == 0 and int(got[2].sum()) + int(got[3].sum()) > 0


# ---------------------------------------------------------------------------
# K5's hop entry: the plain version and the kernel's order, on the CPU
# ---------------------------------------------------------------------------

HOP_THREADS = 256     # csrc/frontier_fused.cu kThreads


def _next_pow2(x):
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


def _fused_hop_case(m, max_deg, rows=200, pad=9, seed=0):
    """Packed rows of ``m`` members over synthetic indexes whose fan-out
    reaches ``max_deg``: mixed k and depths, prefixes drawn from few
    vertices (so candidates repeat them), rows of zero fan-out, a t that
    many candidates hit, ``pad`` PAD rows of rank 0 after the members'
    rows, and the last of two or more members with ``wantc`` off.
    Returns torch tensors ``(paths, rank, tvec, depthv, wantc, begins,
    ends, dsts)`` and the pow2 fan-out bound."""
    rng = np.random.default_rng(seed + 31 * m + max_deg)
    n = 60
    ks = [int(rng.integers(3, 7)) for _ in range(m)]
    k1max = max(ks) + 1
    begins, ends, dsts = [], [], []
    for k in ks:
        deg = rng.integers(0, max_deg + 1, n)
        deg[:2] = (max_deg, 0)
        b = np.concatenate([[0], np.cumsum(deg)[:-1]])
        budget = np.minimum(deg[:, None],
                            np.arange(1, k + 2)[None, :] * -(-max_deg // 2))
        begins.append(b.astype(np.int32))
        ends.append((b[:, None] + budget).astype(np.int32))
        dsts.append(rng.integers(0, 12, max(int(deg.sum()), 1))
                    .astype(np.int32))
    depthv = np.array([rng.integers(0, k - 1) for k in ks], np.int32)
    tvec = rng.integers(0, 12, m).astype(np.int32)
    wantc = np.ones(m, np.int32)
    if m > 1:
        wantc[-1] = 0
    rank = np.concatenate([np.sort(rng.integers(0, m, rows)),
                           np.zeros(pad, np.int64)]).astype(np.int32)
    paths = np.full((rows + pad, k1max), PAD, np.int32)
    for r in range(rows):
        d = depthv[rank[r]]
        paths[r, :d + 1] = rng.integers(0, 12, d + 1)
        paths[r, d] = rng.integers(0, n)
    for i in range(m):                        # each member's widest row
        first = np.flatnonzero(rank[:rows] == i)
        if first.size:
            paths[first[0], depthv[i]] = 0
    return (T(paths), T(rank), T(tvec), T(depthv), T(wantc),
            [T(x) for x in begins], [T(x) for x in ends],
            [T(x) for x in dsts]), _next_pow2(max_deg)


def _pre_hop_route(p, rk, tv, dv, wc, begins, ends, dsts, md):
    """The fused expand's CPU route before K5's hop entry, as it was:
    the masks, two ``compact``s and ``children``, and the per-member
    ``scatter_add_``s, the ``wantc`` suppression after the masks."""
    m = len(begins)
    vnew, emit, cont, counters = fe.frontier_fused_masks(
        p, rk, tv, dv, begins, ends, dsts, max_deg=md)
    vflat = vnew.view(-1)
    rankflat = rk.long().repeat_interleave(md)
    depth_rows = dv.long().index_select(0, rk.long())

    def per_member(flat):
        out = torch.zeros(m, dtype=torch.int32, device=p.device)
        return out.scatter_add_(0, rankflat, flat.to(torch.int32))

    flat_emit = emit.view(-1) != 0
    eidx, _ = fe.compact(flat_emit)
    emit_rows = fe.children(p, vflat, eidx, depth_rows, md)
    flat_cont = (cont.view(-1) != 0) & (wc != 0).index_select(0, rankflat)
    cidx, _ = fe.compact(flat_cont)
    cont_rows = fe.children(p, vflat, cidx, depth_rows, md)
    return (emit_rows, cont_rows, per_member(flat_emit),
            per_member(flat_cont), counters)


@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("max_deg", [1, 8, 64])
def test_fused_hop_plain_equals_pre_hop_route(m, max_deg):
    """``frontier_fused_hop_plain`` and the fused expand's CPU route equal
    the route before the hop entry, output for output (every row of both
    blocks, past the children too), on rows padded as the expand pads
    them."""
    args, md = _fused_hop_case(m, max_deg)
    paths, rank, tvec, depthv, wantc, begins, ends, dsts = args
    C = _next_pow2(max(paths.shape[0], 8))
    p = torch.full((C, paths.shape[1]), PAD, dtype=torch.int32)
    p[:paths.shape[0]] = paths
    rk = torch.zeros(C, dtype=torch.int32)
    rk[:rank.shape[0]] = rank
    want = _pre_hop_route(p, rk, tvec, depthv, wantc, begins, ends, dsts, md)
    emit_rows, cont_rows, head = fe.frontier_fused_hop_plain(
        p, rk, tvec, depthv, wantc, begins, ends, dsts, max_deg=md)
    got = (emit_rows, cont_rows, head[:m], head[m:2 * m],
           head[2 * m:].view(m, 4))
    assert head.dtype == torch.int32 and head.shape == (6 * m,)
    via_ops = ops.frontier_expand_fused(
        paths.numpy(), rank.numpy(), tvec.numpy(), depthv.numpy(), begins,
        ends, dsts, wantc.numpy().astype(bool), max_deg=max_deg)
    for name, w, a, b in zip(("emit_rows", "cont_rows", "n_emit_m",
                              "n_cont_m", "counters"), want, got, via_ops):
        assert torch.equal(w, a), name
        assert torch.equal(w, b), name
    n_emit_m, n_cont_m, counters = via_ops[2:]
    assert torch.equal(n_emit_m.as_strided((6 * m,), (1,)), head)
    assert int(counters[:, 0].sum()) > 0
    assert int(n_emit_m.sum()) + int(n_cont_m.sum()) > 0
    if m > 1:
        assert int(n_cont_m[-1]) == 0 and int(counters[-1, 0]) > 0


def _fused_hop_emulated(args, *, max_deg, grid):
    """K5's hop kernels in plain torch, step by step as they take the rows:
    rows cut into ``grid`` blocks (at most the steps) of whole steps of
    256 / W rows; per block, its rows' emit and continue children (the
    count launch's block totals) and its per-member sums, added to the
    head once a member and block; the write launch's base, the exclusive
    prefix of the block totals; within a block, an exclusive scan of each
    step's row counts; within a row, each child's rank among its row's
    children (the ballots); each child row written at its rank, with the
    candidate at its member's depth + 1.  Returns the children and the
    head."""
    paths, rank, tvec, depthv, wantc, begins, ends, dsts = args
    m = tvec.shape[0]
    vnew, emit, cont, _ = fe.frontier_fused_masks_plain(
        paths, rank, tvec, depthv, begins, ends, dsts, max_deg=max_deg)
    rows = paths.shape[0]
    cont = cont * (wantc != 0).long().index_select(0, rank.long())[:, None]
    width = min(_next_pow2(max_deg), 32)
    per_step = HOP_THREADS // width
    steps = -(-rows // per_step)
    grid = min(grid, steps)
    ec, cc = emit.sum(1), cont.sum(1)
    bounds = [(steps * b // grid * per_step,
               min(steps * (b + 1) // grid * per_step, rows))
              for b in range(grid)]
    head = torch.zeros(6 * m, dtype=torch.int32)
    for r0, r1 in bounds:
        # the count launch: this block's per-member sums, added once
        _, _, _, ctr = fe.frontier_fused_masks_plain(
            paths[r0:r1], rank[r0:r1], tvec, depthv, begins, ends, dsts,
            max_deg=max_deg)
        rk = rank[r0:r1].long()
        head[:m].index_add_(0, rk, ec[r0:r1].to(torch.int32))
        head[m:2 * m].index_add_(0, rk, cc[r0:r1].to(torch.int32))
        head[2 * m:] += ctr.view(-1)
    totals = torch.stack([torch.stack([ec[r0:r1].sum(), cc[r0:r1].sum()])
                          for r0, r1 in bounds])
    base = torch.cumsum(totals, 0) - totals          # exclusive, by block
    n = [int(x) for x in totals.sum(0)]
    out = [torch.full((n[0], paths.shape[1]), -7, dtype=torch.int32),
           torch.full((n[1], paths.shape[1]), -7, dtype=torch.int32)]
    for b, (r0, r1) in enumerate(bounds):
        run = base[b].clone()
        for s0 in range(r0, r1, per_step):
            s1 = min(s0 + per_step, r1)
            counts = torch.stack([ec[s0:s1], cc[s0:s1]], 1)
            offs = run + torch.cumsum(counts, 0) - counts
            for r in range(s0, s1):
                col = int(depthv[rank[r]]) + 1
                for which, mask in enumerate((emit, cont)):
                    sel = torch.nonzero(mask[r]).view(-1)
                    if sel.numel() == 0:
                        continue
                    at = offs[r - s0, which] + torch.arange(sel.numel())
                    child = paths[r].repeat(sel.numel(), 1)
                    child[:, col] = vnew[r, sel]
                    out[which][at] = child
            run += counts.sum(0)
    for o in out:
        assert not (o == -7).any(), "a child slot was never written"
    return out[0], out[1], head


@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("max_deg", [1, 8, 64])
def test_fused_hop_emulation_equals_plain(m, max_deg):
    """The kernels' order, emulated, against ``frontier_fused_hop_plain``
    on unpadded rows (as the card takes them) with PAD rows of rank 0
    after the members' rows, for one block, a few and more blocks than
    steps."""
    args, md = _fused_hop_case(m, max_deg)
    emit_p, cont_p, head = fe.frontier_fused_hop_plain(*args, max_deg=md)
    ne, nc = int(head[:m].sum()), int(head[m:2 * m].sum())
    assert ne + nc > 0 and int(head[2 * m:].view(m, 4)[:, 2].sum()) > 0
    for grid in (1, 3, 64):
        emit_e, cont_e, head_e = _fused_hop_emulated(args, max_deg=md,
                                                     grid=grid)
        assert torch.equal(head_e, head)
        assert torch.equal(emit_e, emit_p[:ne])
        assert torch.equal(cont_e, cont_p[:nc])
    # each member's rows form one segment: its emit rows end at its t
    e_lo = np.concatenate([[0], np.cumsum(head[:m].numpy())])
    for i in range(m):
        seg = emit_p[e_lo[i]:e_lo[i + 1]]
        col = int(args[3][i]) + 1
        assert (seg[:, col] == int(args[2][i])).all()


@pytest.mark.parametrize("leg", ["full", "count_only", "first_n", "segments"])
def test_fused_enumerate_equals_solo(leg, monkeypatch):
    jidxs, idxs = _members(_graph(), QUERIES)
    kw = {"count_only": {"count_only": True},
          "first_n": {"first_n": 3}}.get(leg, {})
    if leg == "segments":
        # a budget below one chunk's slots: every round splits into
        # several dispatches, as a hub member's solo chunk would
        monkeypatch.setattr(tfused, "DEVICE_SLOT_BUDGET", 16)
    got = tfused.enumerate_fused_device(idxs, chunk_size=CHUNK, **kw)
    for jidx, res in zip(jidxs, got):
        want = rc.enumerate_paths_idx(jidx, backend="host", chunk_size=CHUNK,
                                      **kw)
        _assert_result(want, res, f"{leg} s={jidx.s} t={jidx.t}")
        if leg == "count_only":
            assert res.paths.shape[0] == 0


def test_fused_expired_deadline():
    _jidxs, idxs = _members(_graph(), QUERIES)
    res = tfused.enumerate_fused_device(idxs, deadline=tclock.now() - 1.0)
    for r in res:
        assert not r.exhausted and r.count == 0


def test_fused_rejects_mixed_graphs():
    a = _port_index(rc.build_index(rc.erdos_renyi(20, 4.0, seed=1), 0, 19, 3))
    b = _port_index(rc.build_index(rc.erdos_renyi(30, 4.0, seed=2), 0, 29, 3))
    with pytest.raises(ValueError):
        tfused.enumerate_fused_device([a, b])


def test_fused_dispatches_fewer_than_solo_chunks(monkeypatch):
    """``tests/test_fused_launch.py``'s assertion on the port's counter:
    one dispatch per round serves every member."""
    monkeypatch.setenv("REPRO_DEVICE_DEQUE", "off")
    _jidxs, idxs = _members(_graph(), QUERIES)
    solo_chunks = solo_dispatches = 0
    for idx in idxs:
        before = ops.device_dispatch_count()
        r = ten.enumerate_paths_idx(idx, backend="device", chunk_size=CHUNK,
                                    device="cpu")
        solo_dispatches += ops.device_dispatch_count() - before
        solo_chunks += r.stats.chunks
    before = ops.device_dispatch_count()
    tfused.enumerate_fused_device(idxs, chunk_size=CHUNK)
    fused_dispatches = ops.device_dispatch_count() - before
    assert 1 <= fused_dispatches < solo_dispatches
    assert fused_dispatches < solo_chunks


def test_fused_driver_passes_member_table_rows(monkeypatch):
    """The fused driver builds each member's row of K5's member table once
    and hands the stacked rows to every dispatch: they equal the table
    ``fused_member_table`` builds from that dispatch's arrays.  A table of
    the wrong shape is refused."""
    _jidxs, idxs = _members(_graph(), QUERIES)
    calls = []
    orig = ops.frontier_expand_fused

    def spy(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)
    monkeypatch.setattr(ops, "frontier_expand_fused", spy)
    tfused.enumerate_fused_device(idxs, chunk_size=CHUNK)
    assert calls
    for args, kw in calls:
        paths, begins, ends, dsts = args[0], args[4], args[5], args[6]
        want = fe.fused_member_table(begins, ends, dsts,
                                     k1max=paths.shape[1], device="cpu")
        np.testing.assert_array_equal(kw["member_table"], want)
    args, kw = calls[0]
    with pytest.raises(ValueError, match="member_table"):
        orig(*args, max_deg=kw["max_deg"],
             member_table=kw["member_table"][:-1])


def test_batch_fused_ranked_batches_never_fuse():
    """Ranked batches keep the solo path on the device backend: no fused
    dispatch, every item equal to repro's in rank order."""
    jg = rc.erdos_renyi(60, 4.0, seed=3)
    tg = tc.erdos_renyi(60, 4.0, seed=3)
    qs = [(0, 59, 4), (1, 58, 4), (2, 57, 5), (3, 56, 4)]
    want = rc.BatchPathEnum(backend="host").run(
        jg, qs, count_only=False, order="hops", first_n=3)
    out = tc.BatchPathEnum(device="cpu", fused="auto").run(
        tg, qs, count_only=False, order="hops", first_n=3)
    assert out.fused_queries == out.fused_dispatches == 0
    assert not any(i.fused for i in out.items)
    assert any(i.result.count for i in out.items)
    for a, b in zip(want.items, out.items):
        assert b.result.as_tuples() == a.result.as_tuples()
        assert (b.result.count, b.result.exhausted) == \
            (a.result.count, a.result.exhausted)
