"""The port's kernels against the JAX package's Pallas kernels.

Each plain PyTorch version is held against its Pallas kernel run as the
JAX package's own tests run it on the CPU (``interpret=True``), on the
same inputs made from a seed with numpy.  Every value is an integer (or
a float32 holding a small integer), so equality is exact: tolerance 0.
One deque round of the port is held against ``repro``'s on the same
state, every returned array equal.  The CUDA kernels are held against
these plain versions on the card by tests/test_torch_cuda.py.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as rc
from repro.kernels import ops as jops
from repro.kernels.frontier_expand import frontier_expand_masks
from repro.kernels.semiring_spmm import counting_spmm as jax_counting
from repro.kernels.semiring_spmm import minplus_spmv as jax_minplus
from repro_torch.core.enumerate import EnumStats, _expand_chunk
from repro_torch.core.index import LightweightIndex
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import ops
from repro_torch.kernels import semiring_spmm as sr

PAD = -1


def _next_pow2(x):
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


def _port_index(jidx, device="cpu"):
    return LightweightIndex.from_numpy(dataclasses.asdict(jidx),
                                       device=device)


def _chunk(idx, depth):
    """A real chunk of the port's host walk, ``depth`` hops from s."""
    paths = np.full((1, idx.k + 1), PAD, np.int32)
    paths[0, 0] = idx.s
    for d in range(depth):
        exp = _expand_chunk(idx, paths, d, EnumStats())
        if exp is None:
            return None
        parent, _pos, vnew, _emit, cont = exp
        sel = np.nonzero(cont)[0]
        paths = paths[parent[sel]].copy()
        paths[:, d + 1] = vnew[sel]
        if paths.shape[0] == 0:
            return None
    return paths


def _mask_inputs(idx, paths, depth):
    """Padded chunk plus both packages' argument forms."""
    rows, k1 = paths.shape
    C = _next_pow2(max(rows, 8))
    padded = np.full((C, k1), PAD, np.int32)
    padded[:rows] = paths
    # a synthetic duplicate row exercises the prefix check
    if rows < C:
        padded[rows] = paths[0]
    last = padded[:, depth].astype(np.int64)
    b = idx.k - depth - 1
    cnt = np.where(last >= 0, idx.fwd_end[np.maximum(last, 0), b]
                   - idx.fwd_begin[np.maximum(last, 0)], 0)
    max_deg = _next_pow2(max(int(cnt.max()), 1))
    mf = max(idx.fwd_dst.shape[0], 1)
    dst = np.full(_next_pow2(mf), PAD, np.int32)
    dst[:idx.fwd_dst.shape[0]] = idx.fwd_dst
    return padded, dst, max_deg


CASES = [("er_small", 0, 63, 4), ("er_dense", 1, 40, 5), ("dag", 32, 33, 4),
         ("grid", 0, 35, 6)]


@pytest.mark.parametrize("name,s,t,k", CASES)
def test_frontier_masks_plain_equals_pallas(name, s, t, k):
    g = rc.graph.random_graph_suite(0)[name]
    jidx = rc.build_index(g, s, t, k)
    idx = _port_index(jidx)
    checked = 0
    for depth in range(k - 1):
        paths = _chunk(idx, depth)
        if paths is None:
            break
        padded, dst, max_deg = _mask_inputs(idx, paths, depth)
        b = k - depth - 1
        want = frontier_expand_masks(
            jnp.asarray(padded), jnp.asarray(jidx.fwd_begin.astype(np.int32)),
            jnp.asarray(jidx.fwd_end[:, b].astype(np.int32)),
            jnp.asarray(dst), jnp.asarray([depth, t], jnp.int32),
            max_deg=max_deg, interpret=True)
        got = fe.frontier_masks(
            torch.from_numpy(padded),
            torch.from_numpy(idx.fwd_begin.astype(np.int32)),
            torch.from_numpy(idx.fwd_end.astype(np.int32)),
            torch.from_numpy(dst), torch.tensor([depth, t], dtype=torch.int32),
            max_deg=max_deg)
        for w, g_ in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g_.numpy())
        checked += 1
    assert checked >= 1


def test_minplus_plain_equals_pallas():
    rng = np.random.default_rng(11)
    n, inf = 128, 1e9
    adj = np.where(rng.random((n, n)) < 0.05, 1.0, inf).astype(np.float32)
    dist = np.full(n, inf, np.float32)
    dist[rng.choice(n, 6, replace=False)] = rng.integers(0, 4, 6)
    for _ in range(3):
        want = np.asarray(jax_minplus(jnp.asarray(adj), jnp.asarray(dist),
                                      inf=inf, interpret=True))
        got = sr.minplus_spmv(torch.from_numpy(adj), torch.from_numpy(dist),
                              inf=inf).numpy()
        np.testing.assert_array_equal(want, got)
        dist = want.copy()


def test_counting_plain_equals_pallas():
    rng = np.random.default_rng(12)
    n = 128
    adj = rng.integers(0, 3, (n, n)).astype(np.float32)
    counts = rng.integers(0, 50, (n, n)).astype(np.float32)
    want = np.asarray(jax_counting(jnp.asarray(adj), jnp.asarray(counts),
                                   interpret=True))
    got = sr.counting_spmm(torch.from_numpy(adj),
                           torch.from_numpy(counts)).numpy()
    np.testing.assert_array_equal(want, got)
    # the DP's shape: q = 1 (repro pads q to the tile inside its wrapper)
    got1 = sr.counting_spmm(torch.from_numpy(adj),
                            torch.from_numpy(counts[:, :1].copy())).numpy()
    np.testing.assert_array_equal(want[:, :1], got1)


def _deque_state_np(state):
    return [np.asarray(x) for x in state]


@pytest.mark.parametrize("chunk_size,round_pops", [(5, 3), (16, 64)])
def test_deque_round_equals_repro(chunk_size, round_pops):
    g = rc.erdos_renyi(40, 4.0, seed=7)
    jidx = rc.build_index(g, 0, 39, 4)
    idx = _port_index(jidx)
    max_deg = int((idx.fwd_end[:, idx.k] - idx.fwd_begin).max(initial=0))
    jcfg = jops.deque_config(idx.k + 1, chunk_size, max_deg, round_pops)
    cfg = ops.deque_config(idx.k + 1, chunk_size, max_deg, round_pops)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    root = np.full(idx.k + 1, PAD, np.int32)
    root[0] = idx.s
    jstate = jops.frontier_deque_init(root, cfg=jcfg)
    state = ops.frontier_deque_init(root, cfg=cfg, device="cpu")
    for a, b in zip(_deque_state_np(jstate), _deque_state_np(state)):
        np.testing.assert_array_equal(a, b)
    jdev = jidx.device_arrays()
    dev = idx.device_arrays()
    for _ in range(2):                       # a fresh and a mid-walk round
        jout = jops.frontier_deque_round(*jstate, jdev.begin, jdev.end,
                                         jdev.dst, idx.t, cfg=jcfg)
        out = ops.frontier_deque_round(*state, dev.begin, dev.end, dev.dst,
                                       idx.t, cfg=cfg)
        for i, (a, b) in enumerate(zip(_deque_state_np(jout),
                                       _deque_state_np(out))):
            np.testing.assert_array_equal(a, b, err_msg=f"output {i}")
        jstate, state = jout[:5], out[:5]


# ---------------------------------------------------------------------------
# K1's hop entry: the kernel's compaction order, emulated on the CPU
# ---------------------------------------------------------------------------

HOP_THREADS = 256     # csrc/frontier.cu kThreads


def _hop_emulated(paths, begin, end, dst, meta, *, max_deg, want_cont,
                  grid):
    """The hop kernel's compaction in plain torch, step by step as the
    kernel takes it: rows cut into ``grid`` blocks of whole steps of
    256 / W rows; per-row emit and continue counts; the blocks' totals
    and their exclusive prefix (the write launch's base); within a block,
    an exclusive scan of each step's row counts; within a row, each
    child's rank among its row's children; each child row written at its
    rank.  Returns the children and ``[n_emit, n_cont]``."""
    vnew, emit, cont, _ = fe.frontier_masks_plain(paths, begin, end, dst,
                                                  meta, max_deg=max_deg)
    rows, k1 = paths.shape
    depth = int(meta[0])
    cont = cont * int(want_cont)
    width = min(_next_pow2(max_deg), 32)
    per_step = HOP_THREADS // width
    steps = -(-rows // per_step)
    ec, cc = emit.sum(1), cont.sum(1)
    bounds = [(steps * b // grid * per_step,
               min(steps * (b + 1) // grid * per_step, rows))
              for b in range(grid)]
    totals = torch.stack([torch.stack([ec[r0:r1].sum(), cc[r0:r1].sum()])
                          for r0, r1 in bounds])
    base = torch.cumsum(totals, 0) - totals          # exclusive, by block
    n = [int(x) for x in totals.sum(0)]
    out = [torch.full((n[0], k1), -7, dtype=torch.int32),
           torch.full((n[1], k1), -7, dtype=torch.int32)]
    for b, (r0, r1) in enumerate(bounds):
        run = base[b].clone()
        for s0 in range(r0, r1, per_step):
            s1 = min(s0 + per_step, r1)
            counts = torch.stack([ec[s0:s1], cc[s0:s1]], 1)
            offs = run + torch.cumsum(counts, 0) - counts
            for r in range(s0, s1):
                for which, mask in enumerate((emit, cont)):
                    rank = torch.cumsum(mask[r], 0) - mask[r]
                    for j in torch.nonzero(mask[r]).view(-1).tolist():
                        child = paths[r].clone()
                        child[depth + 1] = vnew[r, j]
                        out[which][offs[r - s0, which] + rank[j]] = child
            run += counts.sum(0)
    for o in out:
        assert not (o == -7).any(), "a child slot was never written"
    return out[0], out[1], n


def _hop_cases():
    """(name, padded chunk, begin, end, dst, depth, t, max_deg) over the
    fixtures of test_frontier_masks_plain_equals_pallas."""
    for name, s, t, k in CASES:
        g = rc.graph.random_graph_suite(0)[name]
        idx = _port_index(rc.build_index(g, s, t, k))
        for depth in range(k - 1):
            paths = _chunk(idx, depth)
            if paths is None:
                break
            padded, dst, max_deg = _mask_inputs(idx, paths, depth)
            yield (f"{name}-{depth}", padded, idx.fwd_begin.astype(np.int32),
                   idx.fwd_end.astype(np.int32), dst, depth, t, max_deg)


def _synthetic_hop(rows, max_deg, *, k=6, depth=3, n=300, all_pad=False,
                   seed=0):
    """A chunk over a synthetic index whose fan-out reaches ``max_deg``:
    prefixes drawn from few vertices (so candidates repeat them), rows of
    zero fan-out, PAD rows, and a t that many candidates hit."""
    rng = np.random.default_rng(seed + rows + 7 * max_deg)
    deg = rng.integers(0, max_deg + 1, n)
    deg[:2] = (max_deg, 0)
    begin = np.concatenate([[0], np.cumsum(deg)[:-1]])
    budget = np.minimum(deg[:, None],
                        np.arange(k + 1)[None, :] * -(-max_deg // 2))
    end = begin[:, None] + budget
    dst = rng.integers(0, 24, max(int(deg.sum()), 1))
    paths = np.full((rows, k + 1), PAD, np.int32)
    paths[:, :depth + 1] = rng.integers(0, 24, (rows, depth + 1))
    paths[:, depth] = rng.integers(0, n, rows)
    paths[0, depth] = 0                                 # the widest row
    paths[rng.random(rows) < 0.1] = PAD
    if all_pad:
        paths[:] = PAD
    return (paths, begin.astype(np.int32), end.astype(np.int32),
            dst.astype(np.int32), depth, 5, _next_pow2(max_deg))


def _hop_against_all(paths, begin, end, dst, depth, t, max_deg, want_cont):
    """The emulation against ``compact`` + ``children`` (the plain hop),
    the port's ``ops.frontier_expand`` on the CPU and ``repro``'s
    ``ops.frontier_expand`` (Pallas in interpret mode)."""
    rows = paths.shape[0]
    args = (torch.from_numpy(paths), torch.from_numpy(begin),
            torch.from_numpy(end), torch.from_numpy(dst),
            torch.tensor([depth, t], dtype=torch.int32))
    emit_p, cont_p, head = fe.frontier_hop_plain(*args, max_deg=max_deg,
                                                 want_cont=want_cont)
    ne, nc = int(head[4]), int(head[5])
    assert head[6:].tolist() == [0, 0] and (want_cont or nc == 0)
    for grid in (1, 3, 64):
        emit_e, cont_e, n = _hop_emulated(*args, max_deg=max_deg,
                                          want_cont=want_cont, grid=grid)
        assert n == [ne, nc]
        assert torch.equal(emit_e, emit_p[:ne])
        assert torch.equal(cont_e, cont_p[:nc])
    got = ops.frontier_expand(paths, *args[1:4], depth=depth, t=t,
                              max_deg=max_deg, want_cont=want_cont)
    want = jops.frontier_expand(paths, begin, end, dst, depth=depth, t=t,
                                max_deg=max_deg, want_cont=want_cont)
    assert [int(got[2]), int(got[3])] == [int(want[2]), int(want[3])] \
        == [ne, nc]
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_array_equal(got[4].numpy(), head[:4].numpy())
    np.testing.assert_array_equal(np.asarray(want[0])[:ne],
                                  emit_p[:ne].numpy())
    np.testing.assert_array_equal(np.asarray(want[1])[:nc],
                                  cont_p[:nc].numpy())
    np.testing.assert_array_equal(got[0][:ne].numpy(), emit_p[:ne].numpy())
    np.testing.assert_array_equal(got[1][:nc].numpy(), cont_p[:nc].numpy())
    host = ops.frontier_expand_readback(paths, *args[1:4], depth=depth, t=t,
                                        max_deg=max_deg, want_cont=want_cont)
    assert host[2] == head[:3].tolist()
    for rows_host, n_rows, block in ((host[0], ne, emit_p),
                                     (host[1], nc, cont_p)):
        if n_rows == 0:
            assert rows_host is None
        else:
            np.testing.assert_array_equal(rows_host, block[:n_rows].numpy())
    return rows, ne, nc


@pytest.mark.parametrize("want_cont", [True, False])
def test_hop_emulation_equals_compaction_and_repro(want_cont):
    seen = 0
    for _name, padded, begin, end, dst, depth, t, max_deg in _hop_cases():
        _rows, ne, nc = _hop_against_all(padded, begin, end, dst, depth, t,
                                         max_deg, want_cont)
        seen += ne + nc
    assert seen > 0


@pytest.mark.parametrize("rows,max_deg,all_pad", [
    (300, 1, False), (37, 64, False), (16, 4, True), (9, 64, True)])
@pytest.mark.parametrize("want_cont", [True, False])
def test_hop_emulation_fanouts_and_pad_chunks(rows, max_deg, all_pad,
                                              want_cont):
    paths, begin, end, dst, depth, t, md = _synthetic_hop(
        rows, max_deg, all_pad=all_pad)
    _rows, ne, nc = _hop_against_all(paths, begin, end, dst, depth, t, md,
                                     want_cont)
    assert (ne + nc == 0) == all_pad


def test_minplus_transposed_plain_equals_pallas():
    """The transposed read (reduce along adj's rows) against ``repro``'s
    kernel on the transposed copy."""
    rng = np.random.default_rng(13)
    n, inf = 128, 1e9
    adj = np.where(rng.random((n, n)) < 0.05, 1.0, inf).astype(np.float32)
    dist = np.full(n, inf, np.float32)
    dist[rng.choice(n, 6, replace=False)] = rng.integers(0, 4, 6)
    for _ in range(3):
        want = np.asarray(jax_minplus(jnp.asarray(adj.T.copy()),
                                      jnp.asarray(dist), inf=inf,
                                      interpret=True))
        got = sr.minplus_spmv(torch.from_numpy(adj), torch.from_numpy(dist),
                              inf=inf, transposed=True).numpy()
        np.testing.assert_array_equal(want, got)
        dist = want.copy()


@pytest.mark.parametrize("transposed", [False, True])
def test_bfs_dense_equals_repro(transposed):
    rng = np.random.default_rng(14)
    n, inf, k = 80, 1e9, 4
    adj = np.where(rng.random((n, n)) < 0.03, 1.0, inf).astype(np.float32)
    for src in (0, 41):
        jadj = adj.T.copy() if transposed else adj
        want = np.asarray(jops.bfs_dense(jnp.asarray(jadj), src, k, inf=inf))
        got = ops.bfs_dense(torch.from_numpy(adj), src, k, inf=inf,
                            transposed=transposed).numpy()
        np.testing.assert_array_equal(want, got)
        assert (got < inf).sum() > 1


def test_bfs_levels_without_transposed_copy():
    """``_bfs_levels`` runs the reverse BFS on the adjacency itself and
    gives the dist_s / dist_t of the BFS over its transposed copy."""
    from repro_torch.core import estimator as est
    from repro_torch.core.graph import power_law
    from repro_torch.core.index import build_index
    g = power_law(2000, 6.0, seed=3)
    for s, t, k in ((1104, 997, 4), (1947, 1579, 5)):
        idx = build_index(g, s, t, k, device="cpu")
        wadj, _amat, inf = est._dense_adjacency(idx)
        got_s, got_t = est._bfs_levels(idx, wadj, inf)
        for src, got, a in ((s, got_s, wadj), (t, got_t,
                                                wadj.T.contiguous())):
            d = sr.bfs_dense_plain(a, src, k, inf=inf)
            want = torch.clamp(d, max=k + 1).to(torch.int64).numpy()
            np.testing.assert_array_equal(got, want)
        assert (got_t <= k).sum() > 1
