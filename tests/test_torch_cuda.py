"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpreter, so these tests need a CUDA device and
skip without one (the decision is made inside the ``cuda`` fixture).
They import only ``repro_torch`` (the machine with the card has no JAX):
run them there with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
The PathEnum kernels' values are integers or float32s holding small
integers, so equality is exact.  The attention kernels K6 and K7 are
held within ``repro``'s own tolerances, 2e-5 in float32 (the online
softmax sums in another order) and 2e-2 in bfloat16, on O(1) inputs.
The plain versions themselves are held against the JAX package's Pallas
kernels by tests/test_torch_kernels.py and tests/test_torch_attention.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (PathEnum, build_index, build_index_device,
                              enumerate_paths_idx, erdos_renyi, power_law,
                              random_graph_suite, walk_count_dp)
from repro_torch.configs.base import ArchConfig
from repro_torch.core.enumerate import EnumStats, _expand_chunk
from repro_torch.kernels import decode_attention as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import ops
from repro_torch.kernels import semiring_spmm as sr
from repro_torch.models import transformer as ttf
from repro_torch.serving import Request, ServeEngine

PAD = -1

CASES = [("er_small", 0, 63, 4), ("er_dense", 1, 40, 5), ("dag", 32, 33, 4),
         ("grid", 0, 35, 6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the "
                    "card")
    return torch.device("cuda")


def _next_pow2(x):
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


def _chunk(idx, depth):
    """A real chunk of the host walk, ``depth`` hops from s, plus a
    duplicate of its first row and PAD rows up to a power of two."""
    paths = np.full((1, idx.k + 1), PAD, np.int32)
    paths[0, 0] = idx.s
    for d in range(depth):
        exp = _expand_chunk(idx, paths, d, EnumStats())
        if exp is None:
            return None, 0
        parent, _pos, vnew, _emit, cont = exp
        sel = np.nonzero(cont)[0]
        paths = paths[parent[sel]].copy()
        paths[:, d + 1] = vnew[sel]
        if paths.shape[0] == 0:
            return None, 0
    rows = paths.shape[0]
    padded = np.full((_next_pow2(max(rows + 1, 8)), idx.k + 1), PAD,
                     np.int32)
    padded[:rows] = paths
    padded[rows] = paths[0]
    last = paths[:, depth].astype(np.int64)
    cnt = idx.fwd_end[last, idx.k - depth - 1] - idx.fwd_begin[last]
    return padded, _next_pow2(max(int(cnt.max()), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name,s,t,k", CASES)
def test_cuda_frontier_masks_equal_plain(cuda, name, s, t, k):
    g = random_graph_suite(0)[name]
    idx = build_index(g, s, t, k, device=cuda)
    dev = idx.device_arrays()
    checked = 0
    for depth in range(k - 1):
        padded, max_deg = _chunk(idx, depth)
        if padded is None:
            break
        p = torch.from_numpy(padded).to(cuda)
        meta = torch.tensor([depth, t], dtype=torch.int32).to(cuda)
        before = fe.launches
        got = fe.frontier_masks(p, dev.begin, dev.end, dev.dst, meta,
                                max_deg=max_deg)
        assert fe.launches == before + 1
        want = fe.frontier_masks_plain(p, dev.begin, dev.end, dev.dst, meta,
                                       max_deg=max_deg)
        torch.cuda.synchronize()
        for w, g_ in zip(want, got):
            assert torch.equal(w, g_)
        checked += 1
    assert checked >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(128, 1), (301, 1), (2048, 1), (130, 37),
                                 (256, 128)])
def test_cuda_counting_equals_plain(cuda, n, q):
    rng = np.random.default_rng(n + q)
    adj = torch.from_numpy(rng.integers(0, 3, (n, n)).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, 60, (n, q)).astype(np.float32))
    got = sr.counting_spmm(adj.to(cuda), counts.to(cuda))
    want = sr.counting_spmm_plain(adj, counts)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 2000, 2048])
@pytest.mark.parametrize("q", [1, 2, 3, 33, 128, 129])
def test_cuda_counting_ragged_equals_plain(cuda, n, q):
    """Ragged n and q: the GEMV (q = 1), the 4-byte and 16-byte copy
    paths of the SGEMM, one and several K slices."""
    rng = np.random.default_rng(7 * n + q)
    adj = torch.from_numpy(rng.integers(0, 3, (n, n)).astype(np.float32))
    counts = torch.from_numpy(rng.integers(0, 60, (n, q)).astype(np.float32))
    got = sr.counting_spmm(adj.to(cuda), counts.to(cuda))
    want = sr.counting_spmm_plain(adj, counts)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,q", [(2000, 1), (2048, 1), (2048, 128),
                                 (2000, 129)])
def test_cuda_counting_exact_at_2_24_minus_1(cuda, n, q):
    """Row 0 of every column sums to exactly 2^24 - 1, the largest value
    the DP keeps on the card: every partial sum stays exact."""
    top = 2 ** 24 - 1
    rng = np.random.default_rng(n + q)
    # 0/1 edge counts and columns that sum to 2^24 - 1: row 0 (all ones)
    # reaches it, every other row stays below
    adj = rng.integers(0, 2, (n, n)).astype(np.float32)
    adj[0] = 1.0
    counts = np.full((n, q), top // n, np.float32)
    counts[0] += top - n * (top // n)
    want = sr.counting_spmm_plain(torch.from_numpy(adj),
                                  torch.from_numpy(counts))
    exact = adj.astype(np.float64) @ counts.astype(np.float64)
    assert (want[0] == top).all()
    np.testing.assert_array_equal(want.numpy(), exact)
    got = sr.counting_spmm(torch.from_numpy(adj).to(cuda),
                           torch.from_numpy(counts).to(cuda))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 333, 2048])
def test_cuda_minplus_equals_plain(cuda, n):
    rng = np.random.default_rng(n)
    inf = 1e9
    adj = np.where(rng.random((n, n)) < 0.01, 1.0, inf).astype(np.float32)
    dist = np.full(n, inf, np.float32)
    dist[rng.choice(n, 5, replace=False)] = rng.integers(0, 4, 5)
    a, d = torch.from_numpy(adj).to(cuda), torch.from_numpy(dist).to(cuda)
    got = sr.minplus_spmv(a, d, inf=inf)
    want = sr.minplus_spmv_plain(a, d, inf=inf)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 2000, 2048])
@pytest.mark.parametrize("transposed", [False, True])
def test_cuda_minplus_ragged_both_layouts(cuda, n, transposed):
    """One relaxation at ragged n, forward and over the transpose (read
    along adj's rows), against the plain relaxation on the CPU."""
    rng = np.random.default_rng(3 * n + transposed)
    inf = 1e9
    adj = np.where(rng.random((n, n)) < 0.02, 1.0, inf).astype(np.float32)
    dist = np.full(n, inf, np.float32)
    dist[rng.choice(n, min(n, 5), replace=False)] = rng.integers(
        0, 4, min(n, 5))
    a, d = torch.from_numpy(adj), torch.from_numpy(dist)
    before = sr.minplus_launches
    got = sr.minplus_spmv(a.to(cuda), d.to(cuda), inf=inf,
                          transposed=transposed)
    assert sr.minplus_launches == before + 1
    want = sr.minplus_spmv_plain(a, d, inf=inf, transposed=transposed)
    assert torch.equal(got.cpu(), want)
    if transposed:
        assert torch.equal(want, sr.minplus_spmv_plain(a.T.contiguous(), d,
                                                       inf=inf))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1, 3), (33, 0), (33, 1), (300, 5),
                                 (2000, 4), (2048, 8)])
@pytest.mark.parametrize("transposed", [False, True])
def test_cuda_bfs_dense_one_launch(cuda, n, k, transposed):
    """A whole bounded BFS is one launch of K4 and equals k plain
    relaxations, level for level."""
    rng = np.random.default_rng(n + k)
    inf = 1e9
    adj = torch.from_numpy(np.where(rng.random((n, n)) < 3.0 / n, 1.0, inf)
                           .astype(np.float32))
    src = int(rng.integers(0, n))
    launches, bfs = sr.minplus_launches, sr.bfs_launches
    got = ops.bfs_dense(adj.to(cuda), src, k, inf=inf,
                        transposed=transposed)
    torch.cuda.synchronize()
    assert (sr.minplus_launches, sr.bfs_launches) == (launches + 1, bfs + 1)
    want = torch.full((n,), inf)
    want[src] = 0.0
    for _ in range(k):
        want = sr.minplus_spmv_plain(adj, want, inf=inf,
                                     transposed=transposed)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(want, sr.bfs_dense_plain(adj, src, k, inf=inf,
                                                  transposed=transposed))


def _hop_inputs(dev, rows, max_deg, *, k=6, depth=3, n=300, seed=0):
    """A chunk of ``rows`` rows over a synthetic index whose fan-out
    reaches ``max_deg``: prefixes drawn from few vertices (so candidates
    repeat them), rows of zero fan-out, PAD rows, a t that many candidates
    hit.  Returns the host chunk, the index arrays on ``dev`` and the
    kernel's arguments."""
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
    paths[0, depth] = 0
    paths[rng.random(rows) < 0.1] = PAD
    arrays = [torch.from_numpy(x.astype(np.int32)).to(dev)
              for x in (begin, end, dst)]
    meta = torch.tensor([depth, 5], dtype=torch.int32).to(dev)
    return paths, arrays, meta, depth, _next_pow2(max_deg)


def _hop_equal(got, want):
    """The hop's outputs against the plain hop's: the head, and the
    defined rows of each block."""
    ge, gc, gh = got
    we, wc, wh = want
    assert torch.equal(gh.cpu(), wh.cpu())
    ne, nc = int(wh[4]), int(wh[5])
    assert torch.equal(ge[:ne].cpu(), we[:ne].cpu())
    assert torch.equal(gc[:nc].cpu(), wc[:nc].cpu())
    return ne, nc


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 1000, 3001])
@pytest.mark.parametrize("max_deg", [1, 4, 32, 64])
@pytest.mark.parametrize("want_cont", [True, False])
def test_cuda_frontier_hop_and_masks_fanouts(cuda, rows, max_deg,
                                             want_cont):
    """K1's hop entry and masks entry against their plain versions at
    rows that are not a multiple of a block's step and at every group
    width (1 lane a row up to a warp a row, and wider rows)."""
    paths, (b, e, d), meta, _depth, md = _hop_inputs(cuda, rows, max_deg)
    p = torch.from_numpy(paths).to(cuda)
    before = (fe.launches, fe.hop_launches)
    got = fe.frontier_hop(p, b, e, d, meta, max_deg=md, want_cont=want_cont)
    assert (fe.launches, fe.hop_launches) == (before[0] + 1, before[1] + 1)
    want = fe.frontier_hop_plain(p, b, e, d, meta, max_deg=md,
                                 want_cont=want_cont)
    ne, nc = _hop_equal(got, want)
    assert want_cont or nc == 0
    if rows >= 1000:
        assert ne + nc > 0
    got_m = fe.frontier_masks(p, b, e, d, meta, max_deg=md)
    want_m = fe.frontier_masks_plain(p, b, e, d, meta, max_deg=md)
    for x, y in zip(got_m, want_m):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name,s,t,k", CASES)
@pytest.mark.parametrize("want_cont", [True, False])
def test_cuda_frontier_hop_equals_plain(cuda, name, s, t, k, want_cont):
    """The hop entry on the K1 test's indexes, padded and unpadded, and
    ``ops.frontier_expand`` / ``frontier_expand_readback`` on the card
    against the same calls on the CPU."""
    g = random_graph_suite(0)[name]
    idx = build_index(g, s, t, k, device=cuda)
    cpu = build_index(g, s, t, k, device="cpu")
    dev, hdev = idx.device_arrays(), cpu.device_arrays()
    checked = 0
    for depth in range(k - 1):
        padded, max_deg = _chunk(idx, depth)
        if padded is None:
            break
        meta = torch.tensor([depth, t], dtype=torch.int32).to(cuda)
        rows = int((padded[:, 0] != PAD).sum())
        for chunk in (padded, padded[:rows]):
            p = torch.from_numpy(np.ascontiguousarray(chunk)).to(cuda)
            got = fe.frontier_hop(p, dev.begin, dev.end, dev.dst, meta,
                                  max_deg=max_deg, want_cont=want_cont)
            want = fe.frontier_hop_plain(p, dev.begin, dev.end, dev.dst,
                                         meta, max_deg=max_deg,
                                         want_cont=want_cont)
            _hop_equal(got, want)
            kw = dict(depth=depth, t=t, max_deg=max_deg, want_cont=want_cont)
            a = ops.frontier_expand(chunk, dev.begin, dev.end, dev.dst, **kw)
            c = ops.frontier_expand(chunk, hdev.begin, hdev.end, hdev.dst,
                                    **kw)
            ne, nc = int(c[2]), int(c[3])
            assert (int(a[2]), int(a[3])) == (ne, nc)
            assert torch.equal(a[4].cpu(), c[4])
            assert torch.equal(a[0][:ne].cpu(), c[0][:ne])
            assert torch.equal(a[1][:nc].cpu(), c[1][:nc])
            ra = ops.frontier_expand_readback(chunk, dev.begin, dev.end,
                                              dev.dst, **kw)
            rc_ = ops.frontier_expand_readback(chunk, hdev.begin, hdev.end,
                                               hdev.dst, **kw)
            assert ra[2] == rc_[2]
            for x, y in zip(ra[:2], rc_[:2]):
                assert (x is None) == (y is None)
                if x is not None:
                    np.testing.assert_array_equal(x, y)
        checked += 1
    assert checked >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["first_n", "max_results"])
def test_cuda_solo_anytime_query_equals_host(cuda, monkeypatch, mode):
    """A solo ``first_n`` or ``max_results`` query walks on K1's hop entry
    (the host loop) and equals the host backend: paths in order, counts,
    stats, EngineLimit; with a slot budget small enough that
    ``_fanout_segments`` cuts chunks into several hops."""
    from repro_torch.core import enumerate as en
    g = power_law(2000, 6.0, seed=3)
    idx = build_index(g, 1104, 997, 4, device=cuda)
    total = enumerate_paths_idx(idx, backend="host", device=cuda).count
    assert total > 20
    for budget in (en.DEVICE_SLOT_BUDGET, 64):
        monkeypatch.setattr(en, "DEVICE_SLOT_BUDGET", budget)
        for limit in (1, total // 3, total + 5):
            kw = {"first_n": limit} if mode == "first_n" \
                else {"max_results": limit}
            outs = []
            for backend in ("device", "host"):
                hops = fe.hop_launches
                dispatches = ops.device_dispatch_count()
                try:
                    r = enumerate_paths_idx(idx, backend=backend,
                                            chunk_size=16, device=cuda, **kw)
                except en.EngineLimit:
                    r = None
                outs.append((r, fe.hop_launches - hops,
                             ops.device_dispatch_count() - dispatches))
            (got, hops, calls), (want, _, _) = outs
            assert hops == calls > 0
            assert (got is None) == (want is None)
            if want is not None:
                assert got.count == want.count and got.stats == want.stats
                assert got.exhausted == want.exhausted
                assert got.as_tuples() == want.as_tuples()


def _deque_contract_equal(got, want, cfg):
    """A CUDA round against the plain round on the regions the host
    reads back (``DequeConfig``): the scalars, ``arena[:arena_cap]``, meta
    slots below ``max_chunks``, ``emitbuf``/``emitlen[:n_emit]``.  The
    kernel leaves the scratch regions alone; the plain version's masked
    scatters write there."""
    arena, md, ml, top, nc, eb, el, ne, ctr, pops = got
    warena, wmd, wml, wtop, wnc, web, wel, wne, wctr, wpops = want
    for a, b in ((top, wtop), (nc, wnc), (ne, wne), (ctr, wctr),
                 (pops, wpops)):
        assert a.dtype == b.dtype == torch.int32
        assert torch.equal(a.reshape(-1), b.reshape(-1))
    assert torch.equal(arena[:cfg.arena_cap], warena[:cfg.arena_cap])
    assert torch.equal(md[:cfg.max_chunks], wmd[:cfg.max_chunks])
    assert torch.equal(ml[:cfg.max_chunks], wml[:cfg.max_chunks])
    n = int(ne)
    assert torch.equal(eb[:n], web[:n])
    assert torch.equal(el[:n], wel[:n])


def _deque_rounds_vs_plain(cuda, idx, cfg, max_rounds=10_000):
    """Rounds from a fresh deque until it empties or stalls, kernel and
    plain side by side; each round is one launch and at most pops + 1
    loop iterations.  Returns the pops of every round."""
    root = np.full(idx.k + 1, PAD, np.int32)
    root[0] = idx.s
    dev = idx.device_arrays()
    s1 = list(ops.frontier_deque_init(root, cfg=cfg, device=cuda))
    s2 = [x.clone() for x in s1]
    pops_seen = []
    for _ in range(max_rounds):
        before = ops.deque_rounds
        got = ops.frontier_deque_round(*s1, dev.begin, dev.end, dev.dst,
                                       idx.t, cfg=cfg)
        assert ops.deque_rounds == before + 1
        want = ops.frontier_deque_round_plain(*s2, dev.begin, dev.end,
                                              dev.dst, idx.t, cfg=cfg)
        _deque_contract_equal(got, want, cfg)
        pops = int(got[9])
        assert ops.last_round_iterations() == pops + 1
        pops_seen.append(pops)
        if int(got[4]) == 0 or pops == 0:
            break
        s1, s2 = list(got[:5]), list(want[:5])
    return pops_seen


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_size,round_pops", [(5, 3), (16, 64), (1, 1)])
def test_cuda_deque_round_equals_plain(cuda, chunk_size, round_pops):
    idx = build_index(erdos_renyi(40, 4.0, seed=7), 0, 39, 4, device=cuda)
    max_deg = int((idx.fwd_end[:, idx.k] - idx.fwd_begin).max(initial=0))
    cfg = ops.deque_config(idx.k + 1, chunk_size, max_deg, round_pops)
    pops = _deque_rounds_vs_plain(cuda, idx, cfg)
    assert pops[-1] > 0 and sum(pops) >= 2
    assert max(pops) <= round_pops


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_size", [5, 16])
def test_cuda_deque_round_capacity_stall_equals_plain(cuda, chunk_size):
    """An arena one push too small: the round stops on the capacity
    guard (zero pops with chunks left) exactly where the plain one does."""
    idx = build_index(erdos_renyi(30, 6.0, seed=5), 0, 29, 5, device=cuda)
    max_deg = int((idx.fwd_end[:, idx.k] - idx.fwd_begin).max(initial=0))
    cfg = ops.deque_config(idx.k + 1, chunk_size, max_deg)
    cfg = dataclasses.replace(cfg, arena_cap=cfg.cap + 2,
                              arena_rows=2 * cfg.cap + 2)
    pops = _deque_rounds_vs_plain(cuda, idx, cfg)
    assert pops[-1] == 0, "the capacity guard never tripped"


@pytest.mark.cuda
def test_cuda_deque_round_empty_deque(cuda):
    idx = build_index(erdos_renyi(40, 4.0, seed=7), 0, 39, 4, device=cuda)
    max_deg = int((idx.fwd_end[:, idx.k] - idx.fwd_begin).max(initial=0))
    cfg = ops.deque_config(idx.k + 1, 16, max_deg)
    root = np.full(idx.k + 1, PAD, np.int32)
    root[0] = idx.s
    dev = idx.device_arrays()
    state = list(ops.frontier_deque_init(root, cfg=cfg, device=cuda))
    state[4] = torch.zeros((), dtype=torch.int32, device=cuda)
    plain = [x.clone() for x in state]
    before = ops.deque_rounds
    got = ops.frontier_deque_round(*state, dev.begin, dev.end, dev.dst,
                                   idx.t, cfg=cfg)
    assert ops.deque_rounds == before + 1
    want = ops.frontier_deque_round_plain(*plain, dev.begin, dev.end,
                                          dev.dst, idx.t, cfg=cfg)
    _deque_contract_equal(got, want, cfg)
    assert int(got[9]) == 0 and int(got[7]) == 0 and int(got[3]) == 1
    assert not got[8].any()
    assert ops.last_round_iterations() == 1


@pytest.mark.cuda
@pytest.mark.parametrize("graph,s,t,k", [
    ("erdos_renyi", 0, 299, 5), ("power_law", 1104, 997, 4)])
def test_cuda_resident_query_equals_host(cuda, monkeypatch, graph, s, t, k):
    """The whole resident walk on the card (one kernel launch per round)
    equals the host backend: paths in order, counts, Fig.-6 stats and
    chunks, for full paths and for count_only."""
    monkeypatch.delenv("REPRO_DEVICE_DEQUE", raising=False)
    g = erdos_renyi(300, 6.0, seed=4) if graph == "erdos_renyi" \
        else power_law(2000, 6.0, seed=3)
    idx = build_index(g, s, t, k, device=cuda)
    for chunk_size in (7, 256):
        for count_only in (False, True):
            before = ops.deque_rounds
            got = enumerate_paths_idx(idx, backend="device",
                                      chunk_size=chunk_size,
                                      count_only=count_only, device=cuda)
            assert ops.deque_rounds > before, "the resident deque never ran"
            want = enumerate_paths_idx(idx, backend="host",
                                       chunk_size=chunk_size,
                                       count_only=count_only, device=cuda)
            assert got.count == want.count > 0
            assert got.stats == want.stats
            np.testing.assert_array_equal(got.paths, want.paths)
            np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["host", "device"])
def test_cuda_query_equals_cpu(cuda, backend):
    """The whole query on the card equals the same query on the CPU:
    paths, stats, plan and DP tables (device DP and device index)."""
    g = power_law(2000, 6.0, seed=3)
    for mode in ("auto", "dfs", "join"):
        outs = [PathEnum(tau=1.0, device=d, backend=backend,
                         use_device_index=True).query(g, 1104, 997, 4,
                                                      mode=mode)
                for d in (cuda, "cpu")]
        a, b = (o.result for o in outs)
        assert a.count == b.count and a.stats == b.stats
        assert a.as_tuples() == b.as_tuples()
        pa, pb = (o.plan for o in outs)
        assert (pa.method, pa.cut, pa.t_dfs, pa.t_join) == \
            (pb.method, pb.cut, pb.t_dfs, pb.t_join)
        if pa.dp is not None:
            assert pa.dp.backend_used == pb.dp.backend_used
            np.testing.assert_array_equal(pa.dp.c_to, pb.dp.c_to)
            np.testing.assert_array_equal(pa.dp.c_from, pb.dp.c_from)


@pytest.mark.cuda
def test_cuda_device_index_and_dp_equal_host(cuda):
    g = erdos_renyi(300, 5.0, seed=4)
    host = build_index(g, 3, 250, 5, device=cuda)
    dev = build_index_device(g, 3, 250, 5, device=cuda)
    for f in ("dist_s", "dist_t", "fwd_dst", "fwd_eid", "fwd_begin",
              "fwd_end", "rev_src", "rev_begin", "rev_end", "level_count",
              "gamma"):
        np.testing.assert_array_equal(getattr(host, f), getattr(dev, f))
    a = walk_count_dp(dev, backend="device", device=cuda)
    b = walk_count_dp(dev, backend="host", device=cuda)
    assert a.backend_used == "device"
    np.testing.assert_array_equal(a.c_to, b.c_to)
    np.testing.assert_array_equal(a.c_from, b.c_from)
    r_dev = enumerate_paths_idx(dev, backend="device", chunk_size=7,
                                device=cuda)
    r_host = enumerate_paths_idx(dev, backend="host", chunk_size=7,
                                 device=cuda)
    assert r_dev.stats == r_host.stats
    assert r_dev.as_tuples() == r_host.as_tuples()


def _fused_inputs(dev, queries, depths, rows_each=5, seed=0):
    """A packed fused hop over real indexes on ``dev``: one chunk per
    member at its own depth (mixed k), plus PAD rows to a power of two."""
    g = erdos_renyi(40, 5.0, seed=17)
    idxs = [build_index(g, s, t, k, device=dev) for s, t, k in queries]
    k1max = max(i.k for i in idxs) + 1
    chunks, cnts = [], []
    for idx, d in zip(idxs, depths):
        paths = np.full((1, idx.k + 1), PAD, np.int32)
        paths[0, 0] = idx.s
        for dd in range(d):
            parent, _pos, vnew, _emit, cont = _expand_chunk(
                idx, paths, dd, EnumStats())
            sel = np.nonzero(cont)[0]
            paths = paths[parent[sel]].copy()
            paths[:, dd + 1] = vnew[sel]
        paths = paths[:rows_each]
        last = paths[:, d].astype(np.int64)
        cnts.append(idx.fwd_end[last, idx.k - d - 1] - idx.fwd_begin[last])
        chunks.append(np.pad(paths, ((0, 0), (0, k1max - paths.shape[1])),
                             constant_values=PAD))
    packed = np.concatenate(chunks)
    rank = np.concatenate([np.full(c.shape[0], i, np.int32)
                           for i, c in enumerate(chunks)])
    C = _next_pow2(max(packed.shape[0] + 3, 8))
    pp = np.full((C, k1max), PAD, np.int32)
    pp[:packed.shape[0]] = packed
    rr = np.zeros(C, np.int32)
    rr[:rank.shape[0]] = rank
    max_deg = _next_pow2(max(int(np.concatenate(cnts).max()), 1))
    devs = [i.device_arrays() for i in idxs]
    args = (torch.from_numpy(pp).to(dev), torch.from_numpy(rr).to(dev),
            torch.tensor([i.t for i in idxs], dtype=torch.int32).to(dev),
            torch.tensor(depths, dtype=torch.int32).to(dev),
            [d.begin for d in devs], [d.end for d in devs],
            [d.dst for d in devs])
    return args, max_deg


@pytest.mark.cuda
@pytest.mark.parametrize("queries,depths", [
    ([(0, 39, 4)], [1]),
    ([(0, 39, 4), (1, 38, 4), (2, 37, 3)], [0, 1, 2]),
    ([(0, 39, 4), (1, 38, 5), (2, 37, 3), (3, 36, 4), (4, 35, 2)],
     [2, 3, 1, 1, 0])])
def test_cuda_frontier_fused_masks_equal_plain(cuda, queries, depths):
    args, max_deg = _fused_inputs(cuda, queries, depths)
    before = fe.fused_launches
    got = fe.frontier_fused_masks(*args, max_deg=max_deg)
    assert fe.fused_launches == before + 1
    want = fe.frontier_fused_masks_plain(*args, max_deg=max_deg)
    torch.cuda.synchronize()
    for w, g_ in zip(want, got):
        assert torch.equal(w, g_)
    assert got[3].shape == (len(queries), 4) and int(got[3][:, 0].sum()) > 0


# K5 gives a row max_deg lanes (rounded up to a power of two) below 32 and
# a whole warp from 32 on; the members' k differ, so some rows are
# narrower than the packed matrix
@pytest.mark.cuda
@pytest.mark.parametrize("max_deg", [1, 8, 64])
def test_cuda_frontier_fused_masks_group_widths(cuda, max_deg):
    args, _ = _fused_inputs(cuda, [(0, 39, 4), (1, 38, 5), (2, 37, 3)],
                            [1, 2, 0], rows_each=9)
    got = fe.frontier_fused_masks(*args, max_deg=max_deg)
    want = fe.frontier_fused_masks_plain(*args, max_deg=max_deg)
    torch.cuda.synchronize()
    for w, g_ in zip(want, got):
        assert torch.equal(w, g_)


@pytest.mark.cuda
def test_cuda_frontier_fused_masks_table_repeat_and_pad_rows(cuda):
    """The table entry twice on the same inputs (the launch zeroes the
    counters itself: the second call's counters come from the blocks the
    first call freed) and a member whose rows are all PAD."""
    args, max_deg = _fused_inputs(cuda, [(0, 39, 4), (1, 38, 5),
                                         (2, 37, 3)], [1, 2, 1])
    paths, rank = args[0].clone(), args[1]
    paths[rank == 1] = PAD
    args = (paths,) + args[1:]
    p, rk, tv, dv, begins, ends, dsts = args
    table = torch.from_numpy(fe.fused_member_table(
        begins, ends, dsts, k1max=p.shape[1], device=p.device)).to(cuda)
    want = fe.frontier_fused_masks_plain(*args, max_deg=max_deg)
    assert want[3][1].tolist() == [0, 0, 0, 0]
    before = fe.fused_launches
    for _ in range(2):
        got = fe.frontier_fused_masks_table(p, rk, tv, dv, table,
                                            max_deg=max_deg)
        torch.cuda.synchronize()
        for w, g_ in zip(want, got):
            assert torch.equal(w, g_)
        del got
    assert fe.fused_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("sharing", ["auto", "off"])
def test_cuda_fused_batch_equals_solo(cuda, sharing):
    """The batch engine on the card (fused K5 launches) against solo host
    runs of the same indexes, item by item."""
    from repro_torch.core import BatchPathEnum
    g = erdos_renyi(40, 5.0, seed=17)
    qs = [(0, 39, 4), (1, 38, 4), (2, 37, 3), (3, 36, 5), (0, 38, 4),
          (1, 38, 4)]
    eng = BatchPathEnum(chunk_size=7, sharing=sharing, device=cuda)
    before = fe.fused_launches
    for kw in ({"count_only": False}, {"count_only": False, "first_n": 3}):
        out = eng.run(g, qs, mode="dfs", **kw)
        assert out.fused_queries >= 2 and out.fused_dispatches >= 1
        for item in out.items:
            idx = build_index(g, item.s, item.t, item.k, device=cuda)
            want = enumerate_paths_idx(idx, backend="host", chunk_size=7,
                                       device=cuda, **kw)
            got = item.result
            assert got.count == want.count and got.stats == want.stats
            assert got.as_tuples() == want.as_tuples()
            assert got.exhausted == want.exhausted
    assert fe.fused_launches > before


@pytest.mark.cuda
def test_cuda_stacked_bfs_equals_cpu(cuda):
    from repro_torch.core import batched_index_distances
    g = power_law(2000, 6.0, seed=3)
    rng = np.random.default_rng(9)
    qs = [(int(s), int(t), int(k)) for (s, t), k in
          zip(rng.choice(g.n, (9, 2), replace=False),
              rng.integers(2, 8, 9))]
    got = batched_index_distances(g, qs, block=4, device=cuda)
    want = batched_index_distances(g, qs, block=4, device="cpu")
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# ---------------------------------------------------------------------------
# K6 and K7, the LM attention kernels
# ---------------------------------------------------------------------------

ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _k6_launches():
    """K6's launches, both kernels (float32 split TF32, bfloat16 wgmma)."""
    return kf.f32_launches + kf.wgmma_launches


def _normal(shape, seed, dtype, device):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,D,window", [
    (2, 100, 100, 4, 2, 32, None),      # ragged
    (1, 64, 200, 8, 1, 64, None),       # Lq < Lk, ragged Lk
    (1, 257, 257, 16, 8, 128, 64),      # window, ragged
    (2, 130, 130, 4, 4, 256, None),     # D = 256
    (1, 33, 90, 2, 1, 16, 8),           # Lq < Lk with a window
    (1, 512, 512, 16, 8, 128, None),    # tile-aligned, engine-like GQA
    # float32 tile edges: 128 query rows, 32 keys (64 and 16 at D = 256)
    (1, 63, 63, 4, 2, 16, None),        # one row short of half a tile
    (1, 65, 129, 4, 1, 32, None),       # Lq < Lk, one past the edges
    (2, 127, 127, 8, 2, 64, 40),        # window across a KV tile
    (1, 129, 255, 4, 4, 128, None),     # one row past a query tile
    (1, 255, 255, 4, 2, 256, 100),      # D = 256, window
    (1, 200, 200, 8, 4, 96, None),      # D = 96 (phi3-vision)
    (1, 129, 300, 4, 2, 96, 100),       # D = 96, Lq < Lk with a window
    (1, 129, 129, 2, 1, 128, 33),       # window one past a KV tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_equals_plain(cuda, B, Lq, Lk, H, Hkv, D,
                                           window, dtype):
    q = _normal((B, Lq, H, D), 1, dtype, cuda)
    k = _normal((B, Lk, Hkv, D), 2, dtype, cuda)
    v = _normal((B, Lk, Hkv, D), 3, dtype, cuda)
    before = _k6_launches()
    got = kf.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert _k6_launches() == before + 1
    want = kf.flash_attention_plain(q, k, v, causal=True, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[dtype], err


# q and k x8 put the logits 64x past O(1), where the float32 plain version
# is itself about 1e-4 from the float64 answer (tests/test_torch_attention.py
# shows it on the CPU); kernel and plain version are both held to the
# float64 answer, the kernel's error at most this multiple of the plain
# version's
SPLIT_LARGE_RATIO = 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("D", kf.HEAD_DIMS)
def test_cuda_flash_attention_float32_large_logits(cuda, D):
    q = _normal((1, 129, 4, D), 21, torch.float32, cuda) * 8
    k = _normal((1, 255, 2, D), 22, torch.float32, cuda) * 8
    v = _normal((1, 255, 2, D), 23, torch.float32, cuda)
    got = kf.flash_attention(q, k, v)
    exact = kf.flash_attention_plain(q.double(), k.double(), v.double())
    plain_err = (kf.flash_attention_plain(q, k, v) - exact).abs().max()
    err = (got - exact).abs().max()
    assert bool(torch.isfinite(got).all())
    assert err <= SPLIT_LARGE_RATIO * plain_err, (err.item(),
                                                  plain_err.item())


@pytest.mark.cuda
def test_cuda_flash_attention_not_causal(cuda):
    q = _normal((2, 70, 4, 64), 4, torch.float32, cuda)
    k = _normal((2, 150, 2, 64), 5, torch.float32, cuda)
    v = _normal((2, 150, 2, 64), 6, torch.float32, cuda)
    got = kf.flash_attention(q, k, v, causal=False, scale=0.2)
    want = kf.flash_attention_plain(q, k, v, causal=False, scale=0.2)
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D,lens", [
    (3, 777, 8, 2, 32, [3, 500, 777]),
    (2, 1024, 16, 8, 128, [1, 1000]),
    (4, 300, 8, 8, 16, [300, 17, 64, 299]),
    (2, 129, 16, 1, 256, [129, 33]),
    (1, 5000, 4, 2, 64, [4999]),
    (3, 777, 8, 4, 96, [3, 500, 777]),  # D = 96: lanes past D idle
    (2, 1500, 32, 32, 96, [1500, 700]),  # phi3-vision's heads, G = 1
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_equals_plain(cuda, B, S, H, Hkv, D, lens,
                                            dtype):
    q = _normal((B, H, D), 7, dtype, cuda)
    kc = _normal((B, S, Hkv, D), 8, dtype, cuda)
    vc = _normal((B, S, Hkv, D), 9, dtype, cuda)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = kd.launches
    got = kd.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert kd.launches == before + 1
    want = kd.decode_attention_plain(q, kc, vc, lengths)
    assert got.dtype == dtype and got.shape == q.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[dtype], err


@pytest.mark.cuda
def test_cuda_decode_attention_empty_row_is_zero(cuda):
    q = _normal((2, 4, 32), 1, torch.float32, cuda)
    kc = _normal((2, 50, 2, 32), 2, torch.float32, cuda)
    lengths = torch.tensor([0, 50], dtype=torch.int32, device=cuda)
    got = kd.decode_attention(q, kc, kc, lengths)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = kd.decode_attention_plain(q[1:], kc[1:], kc[1:], lengths[1:])
    assert (got[1:] - want).abs().max().item() <= ATTN_TOL[torch.float32]


# bfloat16 K6 runs on the wgmma kernel: 128-row query tiles of two 64-row
# warpgroups, KV tiles of 128 positions (64 for D = 256)
@pytest.mark.cuda
@pytest.mark.parametrize("B,Lq,Lk,H,Hkv,D,window,causal", [
    (1, 200, 200, 2, 1, 16, None, True),     # D 16, G 2, Lq off the tile
    (2, 129, 129, 8, 1, 32, None, True),     # D 32, G 8, one row past a tile
    (1, 300, 300, 4, 4, 64, 100, True),      # G 1, window across KV tiles
    (1, 64, 333, 16, 2, 128, None, True),    # Lq < Lk, Lk off the tile
    (1, 100, 260, 8, 8, 128, 130, True),     # Lq < Lk with a window
    (2, 190, 190, 4, 2, 256, 70, True),      # D 256 (64-position tiles)
    (1, 257, 500, 4, 1, 256, None, False),   # not causal, Lq < Lk
    (2, 77, 150, 16, 8, 64, None, False),    # not causal, ragged both
    (1, 1, 1, 2, 1, 16, None, True),         # one row, one column
    (1, 300, 300, 4, 4, 96, None, True),     # D 96: three 32-column blocks
    (1, 100, 333, 4, 2, 96, 70, True),       # D 96, Lq < Lk with a window
    (1, 129, 200, 8, 8, 96, None, False),    # D 96, not causal
])
def test_cuda_flash_attention_bf16_tile_edges(cuda, B, Lq, Lk, H, Hkv, D,
                                              window, causal):
    q = _normal((B, Lq, H, D), 11, torch.bfloat16, cuda)
    k = _normal((B, Lk, Hkv, D), 12, torch.bfloat16, cuda)
    v = _normal((B, Lk, Hkv, D), 13, torch.bfloat16, cuda)
    before, f32 = kf.wgmma_launches, kf.f32_launches
    got = kf.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kf.wgmma_launches == before + 1 and kf.f32_launches == f32
    want = kf.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert bool(torch.isfinite(got).all())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= ATTN_TOL[torch.bfloat16], err


@pytest.mark.cuda
def test_cuda_flash_attention_float32_takes_f32_kernel(cuda):
    q = _normal((1, 70, 4, 32), 14, torch.float32, cuda)
    k = _normal((1, 70, 2, 32), 15, torch.float32, cuda)
    before, wgmma = kf.f32_launches, kf.wgmma_launches
    kf.flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert kf.f32_launches == before + 1 and kf.wgmma_launches == wgmma


def _split_lengths(S, chunk, B):
    """Lengths 0, 1, exactly one chunk, one past it, S, and S - 1 (S is
    not a multiple of the chunk below), cycled over B rows."""
    picks = [0, 1, chunk, chunk + 1, S, S - 1]
    return [picks[i % len(picks)] for i in range(B)]


# K7 across the split: on a card of 114 to 132 SMs, B * Hkv = 4 gives 4
# chunks of 1251 and B * Hkv = 96 three of 1025; no S is a multiple of
# its chunk
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (2, 5001, 8, 2, 64),      # B * Hkv small: many splits
    (12, 3073, 16, 8, 128),   # B * Hkv large: few splits
    (6, 2501, 8, 1, 256),     # one KV head, G = 8
    (6, 4101, 12, 4, 32),     # G = 3
    (6, 2049, 4, 4, 16),      # G = 1, D = 16
    (2, 5001, 8, 4, 96),      # D = 96
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_split_boundaries(cuda, B, S, H, Hkv, D,
                                                dtype):
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, chunk = kd.decode_splits(B, Hkv, S, sms)
    assert splits > 1, (splits, chunk)
    q = _normal((B, H, D), 21, dtype, cuda)
    kc = _normal((B, S, Hkv, D), 22, dtype, cuda)
    vc = _normal((B, S, Hkv, D), 23, dtype, cuda)
    lens = _split_lengths(S, chunk, B)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = kd.launches
    got = kd.decode_attention(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert kd.launches == before + 1
    empty = lengths == 0
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))
    want = kd.decode_attention_plain(q, kc, vc, lengths)
    err = (got[~empty].float() - want[~empty].float()).abs().max().item()
    assert err <= ATTN_TOL[dtype], err
    split_ref = kd.decode_attention_split_plain(q, kc, vc, lengths,
                                                chunk=chunk)
    err = (got.float() - split_ref.float()).abs().max().item()
    assert err <= ATTN_TOL[dtype], err


# bfloat16 error in units of each element's own size: |got - want| over
# |want| + the rms of want's row (chip_smoke.py's scaled check, limit
# 2^-4): the absolute 2e-2 alone cannot see a dropped block of columns.
# Against the plain version in float32 on the same inputs the kernel may
# be at most BF16_ERR_RATIO times as far as the plain bfloat16 version
BF16_SCALED_TOL = 2.0 ** -4
BF16_ERR_RATIO = 1.5


def _scaled_err(got, want):
    w = want.double()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    return ((got.double() - w).abs() / (w.abs() + rms)).max().item()


@pytest.mark.cuda
def test_cuda_attention_head_dim_96(cuda):
    """phi3-vision's head dim on both K6 kernels and K7: float32 within
    2e-5 of the plain version; bfloat16 within 2e-2 and the scaled
    check of chip_smoke.py (both limits)."""
    B, L, H, D = 1, 520, 8, 96
    for dtype in (torch.float32, torch.bfloat16):
        q = _normal((B, L, H, D), 31, dtype, cuda)
        k = _normal((B, L, H, D), 32, dtype, cuda)
        v = _normal((B, L, H, D), 33, dtype, cuda)
        got = kf.flash_attention(q, k, v, causal=True)
        want = kf.flash_attention_plain(q, k, v, causal=True)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= ATTN_TOL[dtype], (dtype, err)
        lengths = torch.tensor([L - 7], dtype=torch.int32, device=cuda)
        dgot = kd.decode_attention(q[:, -1].contiguous(), k, v, lengths)
        dwant = kd.decode_attention_plain(q[:, -1].contiguous(), k, v,
                                          lengths)
        derr = (dgot.float() - dwant.float()).abs().max().item()
        assert derr <= ATTN_TOL[dtype], (dtype, derr)
        if dtype == torch.bfloat16:
            exact = (kf.flash_attention_plain(q.float(), k.float(),
                                              v.float(), causal=True),
                     kd.decode_attention_plain(
                         q[:, -1].float().contiguous(), k.float(),
                         v.float(), lengths))
            for g, w, e in zip((got, dgot), (want, dwant), exact):
                assert _scaled_err(g, w) <= BF16_SCALED_TOL
                assert _scaled_err(g, e) <= BF16_ERR_RATIO * _scaled_err(
                    w, e)


@pytest.mark.cuda
def test_cuda_attention_wrappers_raise(cuda):
    q = _normal((1, 16, 2, 48), 1, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        kf.flash_attention(q, q[:, :, :1].contiguous(),
                           q[:, :, :1].contiguous())
    q = _normal((1, 16, 2, 32), 1, torch.float32, cuda)
    k = q[:, :, :1].contiguous()
    with pytest.raises(TypeError):
        kf.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(TypeError):
        kf.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError):
        kf.flash_attention(q, k.cpu(), k)
    lengths = torch.tensor([16], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kd.decode_attention(q[:, 0].contiguous(), k.double(), k.double(),
                            lengths)
    with pytest.raises(ValueError):
        kd.decode_attention(q[:, 0].contiguous(), k, k, lengths.cpu())


TINY = ArchConfig(name="tiny_serve", family="dense", num_layers=2,
                  d_model=64, num_heads=4, kv_heads=2, d_ff=128, vocab=97,
                  head_dim=16, attn_chunk=16, tie_embeddings=True)


@pytest.mark.cuda
def test_cuda_lm_path_launches_per_layer_and_equals_plain(cuda):
    params = ttf.init_params(TINY, 0, device=cuda)
    toks = torch.tensor([[5, 9, 13, 2, 7, 40]], device=cuda)
    before = _k6_launches()
    logits, cache, lens = ttf.prefill(params, TINY, {"tokens": toks})
    assert _k6_launches() == before + TINY.num_layers
    plain, _ = ttf.forward(params, TINY, {"tokens": toks}, impl="xla")
    assert (logits[:, 0] - plain[:, -1]).abs().max().item() < 2e-3
    big = ttf.init_cache(TINY, 1, 16, device=cuda)
    big["k"][:, :, :6] = cache["k"]
    big["v"][:, :, :6] = cache["v"]
    before = kd.launches
    lg, big = ttf.decode_step(params, TINY, torch.tensor([41], device=cuda),
                              big, lens)
    assert kd.launches == before + TINY.num_layers
    full, _ = ttf.forward(params, TINY, {"tokens": torch.cat(
        [toks, torch.tensor([[41]], device=cuda)], 1)}, impl="xla")
    assert (lg - full[:, -1]).abs().max().item() < 2e-3


@pytest.mark.cuda
def test_cuda_serve_engine_equals_cpu(cuda):
    params = ttf.init_params(TINY, 1, device="cpu")
    on_card = {k: v for k, v in params.items() if k != "layers"}
    on_card = {k: v.to(cuda) for k, v in on_card.items()}
    on_card["layers"] = [{k: ({n: w.to(cuda) for n, w in v.items()}
                              if isinstance(v, dict) else v.to(cuda))
                          for k, v in blk.items()}
                         for blk in params["layers"]]
    prompts = [[5, 9, 13], [2, 7], [40, 41, 42, 43], [3]]
    outs = []
    for p, dev in ((params, "cpu"), (on_card, cuda)):
        eng = ServeEngine(TINY, p, batch_slots=2, max_len=32, device=dev)
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=np.asarray(pr, np.int32),
                               max_tokens=6))
        outs.append((eng.run(), eng.steps_run))
    assert outs[0] == outs[1]


def _serving_requests(g, n_req, seed, k=4, **kw):
    from repro_torch.serving import PathQueryRequest
    rng = np.random.default_rng(seed)
    reqs = []
    while len(reqs) < n_req:
        s, t = (int(x) for x in rng.choice(g.n, 2, replace=False))
        reqs.append(PathQueryRequest(uid=len(reqs), s=s, t=t, k=k,
                                     graph_id="g", **kw))
    return reqs


def _response_key(r):
    return (r.uid, r.status, r.count, r.plan_method, r.index_cached,
            r.deduplicated, r.exhausted, r.graph_id, r.slo_met,
            None if r.paths is None else r.paths.tolist())


@pytest.mark.cuda
def test_cuda_hcpe_servers_equal_cpu_and_survive_mutation(cuda):
    """``HcPEServer`` and ``AsyncHcPEServer`` on the card (their default
    engine: the device backend, K1, K2 and K5) answer exactly as the same
    servers on the CPU, before and after a streaming mutation; the
    mutation purges the tenant's indexes on the card."""
    import asyncio

    from repro_torch.core.batch import BatchPathEnum
    from repro_torch.serving import (AsyncHcPEServer, GraphRegistry,
                                     HcPEServer)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    g = erdos_renyi(300, 6.0, seed=2)
    reqs = (_serving_requests(g, 6, 0, count_only=False)
            + _serving_requests(g, 4, 1, first_n=5)
            + _serving_requests(g, 6, 2))
    for i, r in enumerate(reqs):
        r.uid = i
    solo = PathEnum(backend="host", device="cpu")
    lone_full = next(q for q in reqs[:6] if solo.count(g, q.s, q.t, q.k))
    lone_first = next(q for q in reqs[6:10]
                      if solo.count(g, q.s, q.t, q.k) > q.first_n)
    drop = g.edge_list()[:3]
    add = np.array([[0, 1], [1, 0], [5, 9]])
    outs = {}
    for dev in ("cpu", cuda):
        reg = GraphRegistry()
        reg.register("g", g)
        sync = HcPEServer(reg, device=dev)
        eng = BatchPathEnum(device=dev)
        reset_launch_counts()
        r0, rep0 = sync.serve(reqs)
        # lone requests with results run solo: a full walk (K2) and a
        # first_n walk (K1's hop)
        r0 += sync.serve([lone_full])[0] + sync.serve([lone_first])[0]

        async def drive():
            async with AsyncHcPEServer(reg, eng, batch_window_ms=1.0) as srv:
                first = await srv.serve(reqs)
                reg.mutate("g", add=add, remove=drop)
                second = await srv.serve(reqs)
                return first, second, srv.metrics_snapshot()
        r1, r2, snap = asyncio.run(drive())
        counts = launch_counts()
        assert sync.engine.cache.tenant_len("g") == 0
        assert eng.cache.tenant_len("g") == len({(q.s, q.t, q.k)
                                                 for q in reqs})
        assert snap.violations() == [] and snap.tenants["g"].graph_version == 1
        assert not any(r.index_cached for r in r2[:6])
        outs[str(dev)] = ([_response_key(r) for r in r0 + r1 + r2],
                          vars(rep0.enum_stats), counts)
    cpu_out, card_out = outs["cpu"], outs[str(cuda)]
    assert card_out[0] == cpu_out[0]
    assert card_out[1] == cpu_out[1]
    assert all(v == 0 for v in cpu_out[2].values())
    for name in ("frontier_fused_masks", "frontier_deque_round",
                 "frontier_hop"):
        assert card_out[2][name] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("first_n", [None, 50])
def test_cuda_ranked_hops_equals_host_heap(cuda, first_n):
    """``order="hops"`` on the card (the bucketed driver on K1's hop
    entry) returns the host heap's rows in the host heap's order on a
    mid-sized graph; ``order="weight"`` resolves to the heap and equals
    the CPU port's costs bit for bit."""
    from repro_torch.core import rank
    from repro_torch.kernels import launch_counts, reset_launch_counts
    g = erdos_renyi(3000, 8.0, seed=4)
    w = np.random.default_rng(4).integers(0, 4, size=g.m).astype(np.float64)
    checked = 0
    for s, t in ((0, 2999), (5, 1700), (11, 42)):
        idx = build_index_device(g, s, t, 5, device=cuda)
        cpu = build_index(g, s, t, 5, device="cpu")
        want = enumerate_paths_idx(cpu, backend="host", device="cpu",
                                   order="hops", first_n=first_n)
        reset_launch_counts()
        got = enumerate_paths_idx(idx, backend="device", device=cuda,
                                  order="hops", first_n=first_n)
        hops = launch_counts()["frontier_hop"]
        assert got.as_tuples() == want.as_tuples(), (s, t)
        assert (got.count, got.exhausted) == (want.count, want.exhausted)
        if got.count:
            assert hops > 0, (s, t)
            checked += 1
        assert launch_counts()["frontier_deque_round"] == 0
        wt = enumerate_paths_idx(idx, backend="device", device=cuda,
                                 order="weight", weights=w, first_n=first_n)
        wc = enumerate_paths_idx(cpu, backend="host", device="cpu",
                                 order="weight", weights=w, first_n=first_n)
        assert wt.as_tuples() == wc.as_tuples()
        spec = rank.make_rank_spec("weight", w)
        assert rank.path_costs(idx, wt.paths, wt.lengths, spec).tobytes() \
            == rank.path_costs(cpu, wc.paths, wc.lengths, spec).tobytes()
    assert checked > 0


@pytest.mark.cuda
def test_cuda_ranked_batch_launches_k1_not_k5(cuda):
    """A ranked batch on the card takes the solo ranked drivers: K1's hop
    entry launches, K5 (fused) and K2 (resident deque) never do, and the
    answers equal the CPU port's."""
    from repro_torch.core.batch import BatchPathEnum
    from repro_torch.kernels import launch_counts, reset_launch_counts
    g = erdos_renyi(2000, 8.0, seed=6)
    rng = np.random.default_rng(6)
    qs = [(int(a), int(b), 5) for a, b in
          (rng.choice(g.n, 2, replace=False) for _ in range(6))]
    outs = {}
    for dev in ("cpu", cuda):
        reset_launch_counts()
        out = BatchPathEnum(device=dev, fused="auto").run(
            g, qs, count_only=False, order="hops", first_n=20, mode="dfs")
        outs[str(dev)] = ([it.result.as_tuples() for it in out.items],
                          out.fused_queries, launch_counts())
    cpu, card = outs["cpu"], outs[str(cuda)]
    assert card[0] == cpu[0] and any(card[0])
    assert card[1] == 0
    assert card[2]["frontier_hop"] > 0
    assert card[2]["frontier_fused_masks"] == 0
    assert card[2]["frontier_deque_round"] == 0


@pytest.mark.cuda
def test_cuda_constrained_query_equals_cpu(cuda):
    """A constrained query on an index built on the card (the walk runs
    on the host, as in ``repro``) answers exactly as the CPU port, in dfs
    and join mode, with the Fig.-6 counters."""
    from repro_torch.core import constraints
    g = erdos_renyi(1500, 6.0, seed=8)
    rng = np.random.default_rng(8)
    w = rng.uniform(0.0, 3.0, size=g.m)
    labels = rng.integers(0, 2, size=g.m)
    makers = [
        lambda: constraints.AccumulativeValue(w, accept=lambda b: b <= 6.0,
                                              monotone_upper=6.0),
        lambda: constraints.ActionSequence(np.array([[0, 1], [-1, 1]]),
                                           labels, 0, np.array([True, True])),
    ]
    found = 0
    for s, t in ((0, 1499), (3, 700)):
        for make in makers:
            for mode in ("dfs", "join"):
                outs = []
                for dev in ("cpu", cuda):
                    pe = PathEnum(device=dev, use_device_index=dev != "cpu")
                    r = pe.query(g, s, t, 5, mode=mode, cut=2,
                                 constraint=make()).result
                    outs.append((r.as_tuples(), r.count, r.exhausted,
                                 dataclasses.asdict(r.stats)))
                assert outs[0] == outs[1], (s, t, mode)
                found += outs[0][1] > 0
    assert found > 0


# ---------------------------------------------------------------------------
# the mesh engine on the card: a 1 x 1 NCCL mesh, and a 1 x 2 gloo mesh of
# two processes sharing the one card (tests/torch_mesh_parity.py, ``cuda``)
# ---------------------------------------------------------------------------

MESH_RUNS = {"nccl_1x1": (1, 1, "nccl"), "gloo_1x2": (1, 2, "gloo"),
             "gloo_2x1": (2, 1, "gloo")}


@pytest.fixture(scope="module")
def cuda_mesh_runs(tmp_path_factory):
    """Both meshes' ranks, started together; each rank's pickled result
    in rank order."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.compat import free_port
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh runs on the card")
    here = Path(__file__).resolve().parent
    tmp = tmp_path_factory.mktemp("cuda_mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here)]))
    procs, outs = [], {}
    for name, (rows, cols, backend) in MESH_RUNS.items():
        init = f"tcp://127.0.0.1:{free_port()}"
        outs[name] = str(tmp / f"{name}_%d.pkl")
        procs += [subprocess.Popen(
            [sys.executable, str(here / "torch_mesh_parity.py"), "cuda",
             str(rows), str(cols), str(r), init, backend, outs[name]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(rows * cols)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = {}
    for name, (rows, cols, _b) in MESH_RUNS.items():
        res[name] = []
        for r in range(rows * cols):
            with open(outs[name] % r, "rb") as fh:
                res[name].append(pickle.load(fh))
    return res


@pytest.mark.cuda
def test_cuda_mesh_nccl_equals_host_path(cuda_mesh_runs):
    """The 1 x 1 NCCL mesh on the card: distances equal the host BFS of
    each query's index; DP tables equal ``repro``'s mesh recurrence
    written out in float64 numpy (float32 integers below 2^24: exact)
    and are at or above the index's host walk-count DP (the mesh keeps
    the edges into s and out of t); every item equals the port's host
    engine on the CPU; the default engine fused its queries on K5."""
    import torch_mesh_parity as mp
    from repro_torch.core import BatchPathEnum
    got = cuda_mesh_runs["nccl_1x1"][0]
    assert got["wire"] == "device" and got["edge_device"].startswith("cuda")
    g = erdos_renyi(mp.CUDA_GRAPH["n"], mp.CUDA_GRAPH["avg_degree"],
                    seed=mp.CUDA_GRAPH["seed"])
    qs = mp.stats_queries(g.n)
    st = got["stats"]
    qp, qsx, tot = mp.plain_mesh_dp(g, mp.CUDA_K, st["ds"], st["dt"])
    assert np.array_equal(st["qp"], qp) and np.array_equal(st["qs"], qsx)
    assert np.array_equal(st["tot"], tot)
    for i, (s, t) in enumerate(qs):
        idx = build_index(g, s, t, mp.CUDA_K, device="cpu")
        dp = walk_count_dp(idx, device="cpu")
        assert np.array_equal(st["ds"][i], idx.dist_s)
        assert np.array_equal(st["dt"][i], idx.dist_t)
        assert (st["qp"][i] >= dp.q_prefix).all()
        assert (st["qs"][i] >= dp.q_suffix).all()
        assert st["tot"][i] >= dp.q_total
    host = mp.summarize_output(BatchPathEnum(device="cpu", backend="host").run(
        g, [(s, t, mp.CUDA_K) for s, t in qs], count_only=False))
    assert [i["result"] for i in got["enum"]["items"]] == \
        [i["result"] for i in host["items"]]
    assert got["enum"]["counters"]["fused_queries"] > 0
    assert got["k5_launches"] > 0


@pytest.mark.cuda
def test_cuda_mesh_gloo_two_ranks_equal_nccl(cuda_mesh_runs):
    """Two processes on the one card, a 1 x 2 gloo mesh (the wire goes
    through the host): each rank holds half the edges, and both return
    the 1 x 1 mesh's tables and items exactly."""
    import torch_mesh_parity as mp
    one = cuda_mesh_runs["nccl_1x1"][0]
    g = erdos_renyi(mp.CUDA_GRAPH["n"], mp.CUDA_GRAPH["avg_degree"],
                    seed=mp.CUDA_GRAPH["seed"])
    for got in cuda_mesh_runs["gloo_1x2"]:
        assert got["wire"] == "host" and got["edge_device"].startswith("cuda")
        assert got["edge_rows"] == -(-g.m // 2)
        for key in ("ds", "dt", "qp", "qs", "tot"):
            assert np.array_equal(got["stats"][key], one["stats"][key]), key
        assert got["enum"] == one["enum"]


@pytest.mark.cuda
def test_cuda_mesh_gloo_two_rows_equal_nccl(cuda_mesh_runs):
    """Two processes on the one card as a 2 x 1 gloo mesh: each data row
    enumerates the queries whose source it owns (s mod 2) on its own
    default engine, and after the gather both ranks return the 1 x 1
    mesh's items (fused flags apart: they describe each row's own K5
    launch) and its non-fused counters and cache stats."""
    one = cuda_mesh_runs["nccl_1x1"][0]["enum"]
    rows = cuda_mesh_runs["gloo_2x1"]
    assert sum(got["owned_queries"] for got in rows) == len(one["items"])
    drop = ("fused_queries", "fused_dispatches")
    for got in rows:
        assert got["wire"] == "host" and got["edge_device"].startswith("cuda")
        for key in ("ds", "dt", "qp", "qs", "tot"):
            assert np.array_equal(
                got["stats"][key], cuda_mesh_runs["nccl_1x1"][0]["stats"][key])
        b = got["enum"]
        assert [{**i, "flags": i["flags"][:3]} for i in b["items"]] == \
            [{**i, "flags": i["flags"][:3]} for i in one["items"]]
        assert b["cache_stats"] == one["cache_stats"]
        assert {k: v for k, v in b["counters"].items() if k not in drop} == \
            {k: v for k, v in one["counters"].items() if k not in drop}
        assert b == rows[0]["enum"]


@pytest.mark.cuda
def test_cuda_compressed_sums_exact(cuda_mesh_runs):
    """``compressed_all_reduce`` on CUDA tensors over every mesh (NCCL on
    the card, gloo through the host): each rank's sum bit-identical to
    the int64 sum of every rank's quantized values, rebuilt on the CPU
    from the seeds (``mp.exact_compressed_sum``)."""
    import torch_mesh_parity as mp
    for name, runs in cuda_mesh_runs.items():
        want = mp.exact_compressed_sum(
            torch, [mp.rank_tree(*got["coords"]) for got in runs])
        for got in runs:
            assert got["compressed_device"].startswith("cuda")
            assert got["compressed"]["w"].tobytes() == want["w"].tobytes()
            assert got["compressed"]["b"][0].tobytes() == \
                want["b"][0].tobytes()


# the five families past dense: each reduced config (and a tailed hybrid)
FAMILY_CASES = ["phi3_vision_4p2b", "musicgen_large", "qwen3_moe_30b_a3b",
                "llama4_maverick_400b_a17b", "mamba2_780m",
                "recurrentgemma_9b", "recurrentgemma_9b_tail"]
FAMILY_TOL = 2e-3            # logits of order 1, float32, a few layers


def _family_cfg(case):
    from repro_torch.configs import get_arch
    if case == "recurrentgemma_9b_tail":
        return dataclasses.replace(get_arch("recurrentgemma_9b").reduced(),
                                   num_layers=5)
    return get_arch(case).reduced()


def _params_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _params_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_params_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FAMILY_CASES)
def test_cuda_family_kernel_path_equals_plain(cuda, case):
    """Forward, prefill (with the frontend's prefix where there is one)
    and a decode chain past the reduced window on the kernel path (K6,
    K7) against the plain path on the card; K6 and K7 launch once per
    attention layer, and never for mamba2."""
    cfg = _family_cfg(case)
    params = ttf.init_params(cfg, 0, device=cuda)
    n_attn = sum(k in ttf.ATTN_KINDS for k in ttf.layer_kinds(cfg))
    assert (n_attn == 0) == (cfg.family == "ssm")
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen, device=cuda)
    batch = {"tokens": toks}
    if cfg.frontend != "none":
        batch["prefix_emb"] = torch.randn((2, 4, cfg.d_model), generator=gen,
                                          device=cuda)
    plain, paux = ttf.forward(params, cfg, batch, impl="xla")
    before = _k6_launches()
    got, gaux = ttf.forward(params, cfg, batch, impl="flash")
    assert _k6_launches() == before + n_attn
    assert (got - plain).abs().max().item() <= FAMILY_TOL
    assert abs(float(gaux["moe_balance"]) - float(paux["moe_balance"])) \
        <= 1e-5
    logits, _, _ = ttf.prefill(params, cfg, batch)
    assert (logits[:, 0] - plain[:, -1]).abs().max().item() <= FAMILY_TOL
    caches = [ttf.init_cache(cfg, 2, 32, device=cuda) for _ in range(2)]
    lens = torch.tensor([0, 3], dtype=torch.int32, device=cuda)
    for i in range(20):
        before = kd.launches
        lg_k, _ = ttf.decode_step(params, cfg, toks[:, i], caches[0], lens,
                                  impl="flash")
        assert kd.launches == before + n_attn
        lg_p, _ = ttf.decode_step(params, cfg, toks[:, i], caches[1], lens,
                                  impl="xla")
        assert (lg_k - lg_p).abs().max().item() <= FAMILY_TOL
        lens = lens + 1
    for a, b in zip(ttf.cache_tensors(caches[0]),
                    ttf.cache_tensors(caches[1])):
        assert (a - b).abs().max().item() <= FAMILY_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("case", FAMILY_CASES)
def test_cuda_family_serve_engine_equals_cpu(cuda, case):
    """The same weights served on the card (kernels) and on the CPU
    (plain path): the same greedy tokens and engine steps at 2 slots."""
    cfg = _family_cfg(case)
    params = ttf.init_params(cfg, 1, device="cpu")
    prompts = [[5, 9, 13, 7, 3], [2, 7, 11], [40, 41, 42, 43], [3]]
    outs = []
    for p, dev in ((params, "cpu"), (_params_to(params, cuda), cuda)):
        eng = ServeEngine(cfg, p, batch_slots=2, max_len=32, device=dev)
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=np.asarray(pr, np.int32),
                               max_tokens=6))
        outs.append((eng.run(), eng.steps_run))
    assert outs[0] == outs[1]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mamba2_780m", "recurrentgemma_9b_tail"])
def test_cuda_replay_leaves_other_slots_state_bit_identical(cuda, case):
    """A replay step on the card leaves every other slot's conv window
    and h bit for bit as they were, and advances its own."""
    cfg = _family_cfg(case)
    eng = ServeEngine(cfg, ttf.init_params(cfg, 2, device=cuda),
                      batch_slots=3, max_len=32, device=cuda)
    for slot, tok in ((0, 5), (1, 9), (2, 13)):
        eng._step_single_slot(slot, tok)
    kind = "ssm" if cfg.family == "ssm" else "rec"
    before = [x.clone() for x in eng.cache[kind]]
    eng._step_single_slot(1, 21)
    for x, y in zip(eng.cache[kind], before):
        assert torch.equal(x[:, 0], y[:, 0])
        assert torch.equal(x[:, 2], y[:, 2])
        assert not torch.equal(x[:, 1], y[:, 1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_d256_one_kv_head_windowed(cuda, dtype):
    """recurrentgemma's attention: 16 query heads over one KV head of
    256, a window; K6 causal with the window across KV tiles, and K7
    over a ring buffer of S = window positions, rows past the window
    (valid length min(pos + 1, S)) and inside it."""
    H, D, W = 16, 256, 100
    q = _normal((1, 333, H, D), 1, dtype, cuda)
    k = _normal((1, 333, 1, D), 2, dtype, cuda)
    v = _normal((1, 333, 1, D), 3, dtype, cuda)
    got = kf.flash_attention(q, k, v, causal=True, window=W)
    want = kf.flash_attention_plain(q, k, v, causal=True, window=W)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    pos = torch.tensor([5, 99, 100, 250], dtype=torch.int32, device=cuda)
    lengths = torch.clamp(pos + 1, max=W)
    qd = _normal((4, H, D), 4, dtype, cuda)
    kc = _normal((4, W, 1, D), 5, dtype, cuda)
    vc = _normal((4, W, 1, D), 6, dtype, cuda)
    got = kd.decode_attention(qd, kc, vc, lengths)
    want = kd.decode_attention_plain(qd, kc, vc, lengths)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


# training (queue 1, items 9.4-9.5): a train step on the card against the
# CPU; the attention kernels refuse autograd; checkpoints and PathCorpus
TRAIN_CASES = ["tiny"] + [
    "internlm2_1p8b", "llama3p2_1b", "mistral_large_123b", "starcoder2_7b"
] + FAMILY_CASES
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_G_FLOOR = 1e-3


def _train_cfg(case):
    return TINY if case == "tiny" else _family_cfg(case)


def _train_batch(cfg, dev, B=2, S=32):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = toks.copy()
    labels[0, S - 5:] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.frontend != "none":
        batch["prefix_emb"] = (rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_CASES)
def test_cuda_train_step_equals_cpu(cuda, case):
    """Loss, gradients and one AdamW step on the card against the CPU on
    the same weights and batch, TF32 off.  Tolerances as the CPU's
    against ``repro`` (tests/torch_train_parity.py): float32 sums in
    other orders, and the embedding's backward accumulates with atomics
    on the card; the updated parameters within 1e-2 of lr where the
    gradient is at least ``TRAIN_G_FLOOR`` of its leaf's largest, within
    3 lr elsewhere (AdamW's step is lr · sign(g) for a tiny g)."""
    from repro_torch import tree as tree_mod
    from repro_torch.optim import adamw
    from repro_torch.training import step as tstep

    cfg = _train_cfg(case)
    params = ttf.init_params(cfg, 0, device="cpu")
    out = {}
    for dev in ("cpu", cuda):
        p = _params_to(params, dev)
        batch = _train_batch(cfg, dev)
        loss, _, grads = tstep._value_and_grad(tstep.make_loss_fn(cfg), p,
                                               batch)
        p2, _, m = tstep.make_train_step(
            cfg, adamw.OptimizerConfig(total_steps=10))(
                p, adamw.init(p), batch)
        out[str(dev)] = (float(loss), _params_to(grads, "cpu"),
                         _params_to(p2, "cpu"),
                         {k: float(v) for k, v in m.items()})
    (l0, g0, p0, m0), (l1, g1, p1, m1) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(l1, l0, rtol=TRAIN_LOSS_RTOL)
    np.testing.assert_allclose(m1["grad_norm"], m0["grad_norm"], rtol=1e-4)
    lr = m0["lr"]
    assert m1["lr"] == lr
    for (path, a), b, want, g in zip(tree_mod.leaves_with_path(p1),
                                     tree_mod.leaves(p0),
                                     tree_mod.leaves(g0),
                                     tree_mod.leaves(g1)):
        g, want = g.double(), want.double()
        assert torch.isfinite(g).all(), path
        assert float((g - want).abs().max()) \
            <= TRAIN_GRAD_RTOL * float(want.abs().max()) + 1e-30, path
        diff = (a.double() - b.double()).abs()
        slack = 1e-6 * float(b.abs().max())
        strong = want.abs() >= TRAIN_G_FLOOR * want.abs().max()
        assert float(torch.where(strong, diff, 0).max()) <= 1e-2 * lr + slack
        assert float(diff.max()) <= 3 * lr + slack, path


@pytest.mark.cuda
def test_cuda_attention_kernels_refuse_autograd(cuda):
    """On CUDA inputs that require grad, K6 and K7 raise (they have no
    backward) instead of returning a result detached from the graph;
    under ``torch.no_grad`` they run, and the CPU's plain versions keep
    working under autograd."""
    q = _normal((1, 16, 2, 32), 1, torch.float32, cuda)
    k = _normal((1, 16, 1, 32), 2, torch.float32, cuda)
    v = _normal((1, 16, 1, 32), 3, torch.float32, cuda)
    lengths = torch.tensor([16], dtype=torch.int32, device=cuda)
    qd = q[:, 0].contiguous()
    for arg in range(3):
        xs = [q, k, v]
        xs[arg] = xs[arg].clone().requires_grad_(True)
        before = kf.f32_launches
        with pytest.raises(RuntimeError, match="no backward"):
            kf.flash_attention(*xs)
        assert kf.f32_launches == before
    with pytest.raises(RuntimeError, match="no backward"):
        kd.decode_attention(qd.clone().requires_grad_(True), k, v, lengths)
    with pytest.raises(RuntimeError, match="no backward"):
        kd.decode_attention(qd, k.clone().requires_grad_(True), v, lengths)
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        out = kf.flash_attention(qg, k, v)
        dec = kd.decode_attention(qd.clone().requires_grad_(True), k, v,
                                  lengths)
    assert (out - kf.flash_attention_plain(q, k, v, causal=True,
                                           scale=32 ** -0.5)).abs().max() \
        < 2e-5
    assert dec.shape == qd.shape
    cpu = qg.detach().cpu().requires_grad_(True)
    kf.flash_attention(cpu, k.cpu(), v.cpu()).sum().backward()
    assert cpu.grad is not None and torch.isfinite(cpu.grad).all()
    params = ttf.init_params(TINY, 0, device=cuda)
    toks = torch.tensor([[5, 9, 13, 2]], device=cuda)
    leaf = params["layers"][0]["attn"]["wq"].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ttf.forward(params, TINY, {"tokens": toks})
    loss, _ = ttf.loss_fn(params, TINY, {"tokens": toks, "labels": toks})
    (grad,) = torch.autograd.grad(loss, [leaf])
    assert float(grad.abs().max()) > 0


@pytest.mark.cuda
def test_cuda_checkpoint_bfloat16_round_trip(cuda, tmp_path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.optim import adamw

    params = {"w": torch.randn(64, 32, device=cuda).to(torch.bfloat16),
              "n": torch.zeros(32, device=cuda)}
    params["w"][0, 0] = float("nan")
    state = adamw.init(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"params": params, "opt": state})
    got, manifest = mgr.restore(3, {"params": params, "opt": state})
    assert manifest["step"] == 3
    w = got["params"]["w"]
    assert w.is_cuda and w.dtype == torch.bfloat16
    assert torch.equal(w.view(torch.int16), params["w"].view(torch.int16))
    assert got["opt"].step.is_cuda and got["opt"].mu["w"].is_cuda


@pytest.mark.cuda
def test_cuda_path_corpus_equals_cpu(cuda):
    """PathCorpus on the card (K1's hop entry) gives the CPU's batches
    bit for bit."""
    from repro_torch import kernels
    from repro_torch.data.pipeline import PathCorpus

    g = power_law(200, 5.0, seed=4)
    kw = dict(k=4, seq_len=16, global_batch=4)
    on_card = PathCorpus(graph=g, device=cuda, **kw)
    cpu = PathCorpus(graph=g, device="cpu", **kw)
    before = kernels.launch_counts()["frontier_hop"]
    for step in range(3):
        a, b = on_card.batch_at(step), cpu.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].tobytes() == b[key].tobytes()
    assert kernels.launch_counts()["frontier_hop"] > before


# ---------------------------------------------------------------------------
# the LM's mesh layout on the card (tests/torch_shard_parity.py cuda)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_shard_run(tmp_path_factory):
    """One process on the card with a 1 x 1 NCCL mesh; its pickled
    results."""
    import os
    import pickle
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mesh runs on the card")
    here = Path(__file__).resolve().parent
    out = tmp_path_factory.mktemp("cuda_shard") / "shard.pkl"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here)]))
    proc = subprocess.run(
        [sys.executable, str(here / "torch_shard_parity.py"), "cuda",
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:]
    with open(out, "rb") as fh:
        return pickle.load(fh)


def _max_diff(a, b):
    from repro_torch import tree as tree_mod
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(tree_mod.leaves(a), tree_mod.leaves(b)))


SHARD_CUDA_ARCHS = ["llama3p2_1b", "qwen3_moe_30b_a3b",
                    "llama4_maverick_400b_a17b", "mamba2_780m",
                    "recurrentgemma_9b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SHARD_CUDA_ARCHS)
def test_cuda_sharded_train_step_equals_unsharded(cuda_shard_run, arch):
    """A train step laid out on the 1 x 1 NCCL mesh (every leaf a
    DTensor) equals the unsharded step on the card: on one rank every
    redistribute is a no-op (within 1e-6 of each leaf's largest entry)."""
    assert cuda_shard_run["mesh"] == ((1, 1), "cuda", "nccl")
    got = cuda_shard_run[f"arch/{arch}"]
    want = cuda_shard_run[f"arch_plain/{arch}"]
    assert got["grads_on_param_placements"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-6)
    from repro_torch import tree as tree_mod
    for (path, a), b in zip(tree_mod.leaves_with_path(got["grads"]),
                            tree_mod.leaves(want["grads"])):
        assert float(np.abs(a - b).max()) <= 1e-6 * float(
            np.abs(b).max()) + 1e-12, path


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SHARD_CUDA_ARCHS)
def test_cuda_sharded_serve_runs_the_kernels_on_local_shards(
        cuda_shard_run, arch):
    """``impl=None`` on DTensors on the card: K6 and K7 through
    ``local_map`` in every attention call (mamba2 has none), equal to
    the unsharded kernel path within 2e-5 (the float32 kernels against
    themselves)."""
    got = cuda_shard_run[f"serve/{arch}"]
    want = cuda_shard_run[f"serve_plain/{arch}"]
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as ttf
    attn = sum(k in ttf.ATTN_KINDS
               for k in ttf.layer_kinds(get_arch(arch).reduced()))
    assert got["routes"] == {"local_kernel": 3 * attn, "plain": 0}
    launches = cuda_shard_run[f"serve_launches/{arch}"]
    assert launches["flash_attention"] == attn
    assert launches["decode_attention"] == 2 * attn
    assert _max_diff(got["prefill_logits"], want["prefill_logits"]) <= 2e-5
    assert _max_diff(got["decode_logits"], want["decode_logits"]) <= 2e-5
    assert _max_diff(got["cache"], want["cache"]) <= 2e-5


@pytest.mark.cuda
def test_cuda_kernel_wrappers_refuse_dtensors(cuda_shard_run):
    rec = cuda_shard_run["constrain"]
    assert rec["flash_raises"] == "TypeError"
    assert rec["decode_raises"] == "TypeError"
    assert rec["inside_plain_raises"] == "TypeError"


# ---------------------------------------------------------------------------
# the examples (repro_torch.examples) on the card, and the kernels
# package's surface
# ---------------------------------------------------------------------------

def test_launch_counts_read_every_counter_after_reexports(monkeypatch):
    """``repro_torch.kernels`` re-exports K3's and K4's wrappers, and
    ``launch_counts()`` still reads every counter of the kernel
    submodules (a CPU test: no kernel runs)."""
    import inspect

    from repro_torch import kernels

    assert kernels.bfs_dense is sr.bfs_dense
    assert kernels.counting_spmm is sr.counting_spmm
    assert kernels.minplus_spmv is sr.minplus_spmv
    for mod in (kernels.decode_attention, kernels.flash_attention,
                kernels.frontier_expand, kernels.ops, kernels.semiring_spmm):
        assert inspect.ismodule(mod)
    counters = {"frontier_masks": (fe, "launches"),
                "frontier_hop": (fe, "hop_launches"),
                "frontier_fused_masks": (fe, "fused_launches"),
                "frontier_deque_round": (ops, "deque_rounds"),
                "counting_spmm": (sr, "counting_launches"),
                "minplus_spmv": (sr, "minplus_launches"),
                "bfs_dense": (sr, "bfs_launches"),
                "flash_attention": (kf, "f32_launches"),
                "flash_attention_sm90": (kf, "wgmma_launches"),
                "decode_attention": (kd, "launches")}
    for i, (mod, attr) in enumerate(counters.values()):
        monkeypatch.setattr(mod, attr, 100 + i)
    assert kernels.launch_counts() == {
        name: 100 + i for i, name in enumerate(counters)}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(counters, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["quickstart", "fraud_detection",
                                  "batch_serving", "multi_tenant_serving",
                                  "async_serving", "streaming_serving"])
def test_cuda_example_equals_cpu(cuda, name):
    """A PathEnum example on the card returns the values of its
    ``--device cpu`` run (the plain versions), but for the wall-clock
    values ``examples.CLOCK_BOUND`` names."""
    import importlib

    from repro_torch import examples

    assert name in examples.PATHENUM
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    got = mod.main(["--device", "cuda"])
    want = mod.main(["--device", "cpu"])
    assert set(got) == set(want)
    for key in set(got) - set(examples.CLOCK_BOUND.get(name, {})):
        assert got[key] == want[key], key
