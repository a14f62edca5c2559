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
