"""The port's CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpreter, so these tests need a CUDA device and
skip without one (the decision is made inside the ``cuda`` fixture).
They import only ``repro_torch`` (the machine with the card has no JAX):
run them there with ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Every compared value is an integer or a float32 holding a small integer,
so equality is exact.  The plain versions themselves are held against
the JAX package's Pallas kernels by tests/test_torch_kernels.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (PathEnum, build_index, build_index_device,
                              enumerate_paths_idx, erdos_renyi, power_law,
                              random_graph_suite, walk_count_dp)
from repro_torch.core.enumerate import EnumStats, _expand_chunk
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import ops
from repro_torch.kernels import semiring_spmm as sr

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
@pytest.mark.parametrize("chunk_size,round_pops", [(5, 3), (16, 64)])
def test_cuda_deque_round_equals_plain(cuda, chunk_size, round_pops):
    idx = build_index(erdos_renyi(40, 4.0, seed=7), 0, 39, 4, device=cuda)
    max_deg = int((idx.fwd_end[:, idx.k] - idx.fwd_begin).max(initial=0))
    cfg = ops.deque_config(idx.k + 1, chunk_size, max_deg, round_pops)
    root = np.full(idx.k + 1, PAD, np.int32)
    root[0] = idx.s
    dev = idx.device_arrays()
    s1 = ops.frontier_deque_init(root, cfg=cfg, device=cuda)
    s2 = [x.clone() for x in s1]
    for _ in range(2):
        out = ops.frontier_deque_round(*s1, dev.begin, dev.end, dev.dst,
                                       idx.t, cfg=cfg)
        want = ops.frontier_deque_round_plain(*s2, dev.begin, dev.end,
                                              dev.dst, idx.t, cfg=cfg)
        for a, b in zip(out, want):
            assert torch.equal(a, b)
        s1, s2 = out[:5], want[:5]


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
