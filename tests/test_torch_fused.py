"""K5 and the fused multi-query driver of the port against ``repro``.

* ``frontier_fused_masks_plain`` equals ``repro``'s oracle
  ``ref.frontier_fused_masks_ref`` and its Pallas kernel run in interpret
  mode, on inputs made from a seed with numpy (mixed k, PAD rows, a member
  with zero fan-out, a hub row past the first 8-row block); every value is
  an integer, so equality is exact (tolerance 0).
* ``ops.frontier_expand_fused`` equals ``repro``'s array for array.
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
