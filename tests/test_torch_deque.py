"""Two arguments the CUDA kernels of K2 and K3 rest on, checked on the CPU.

* The resident deque's output contract (``ops.DequeConfig``): the host
  reads back only ``arena[:arena_cap]``, the meta slots below
  ``max_chunks``, ``emitbuf``/``emitlen[:n_emit]`` and the scalars.  The
  CUDA round writes only those, so on the card it is held to the plain
  round there and nowhere else.  Here every round's scratch regions are
  overwritten with garbage before ``_drive_resident`` or the next round sees
  them, and the walk must come out unchanged: paths in order, count and
  every Fig.-6 stat, through a capacity stall too.
* The reordering argument of K3's split-K: on non-negative integer
  inputs whose results stay below 2^24, every partial sum is an exact
  float32 integer, so a sum cut into K slices and added slice by slice
  equals the plain product bit for bit.  The slices are cut as the
  kernel cuts them (``semiring_spmm.counting_splits``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.kernels import ops
from repro_torch.kernels import semiring_spmm as sr

GARBAGE = 1 << 20           # no vertex of these graphs, no sane length


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _poison_scratch(monkeypatch):
    """Wrap the round so that after it returns, every region outside the
    output contract holds garbage.  Returns the list of rounds seen."""
    real = ops.frontier_deque_round
    rounds = []

    def poisoned(*args, cfg, **kw):
        out = real(*args, cfg=cfg, **kw)
        arena, meta_depth, meta_len, _top, _nc, emitbuf, emitlen, n_emit, \
            _ctr, _pops = out
        n = int(n_emit)
        arena[cfg.arena_cap:] = GARBAGE
        meta_depth[cfg.max_chunks:] = GARBAGE
        meta_len[cfg.max_chunks:] = GARBAGE
        emitbuf[n:] = GARBAGE
        emitlen[n:] = GARBAGE
        rounds.append(n)
        return out

    monkeypatch.setattr(ops, "frontier_deque_round", poisoned)
    return rounds


def _assert_same_walk(want, got):
    assert got.count == want.count
    assert got.exhausted == want.exhausted
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    np.testing.assert_array_equal(got.paths, want.paths)
    np.testing.assert_array_equal(got.lengths, want.lengths)


@pytest.mark.parametrize("chunk_size", [1, 5, 16])
@pytest.mark.parametrize("stall", [False, True])
def test_resident_walk_reads_only_the_contract(monkeypatch, chunk_size,
                                                 stall):
    monkeypatch.delenv("REPRO_DEVICE_DEQUE", raising=False)
    g = tc.erdos_renyi(30, 6.0, seed=5)
    idx = tc.build_index(g, 0, 29, 5, device="cpu")
    if stall:
        real_cfg = ops.deque_config

        def tiny(k1, cs, max_deg, round_pops=64):
            cfg = real_cfg(k1, cs, max_deg, round_pops)
            return dataclasses.replace(cfg, arena_cap=cfg.cap + 2,
                                       arena_rows=2 * cfg.cap + 2)

        monkeypatch.setattr(ops, "deque_config", tiny)
    host = tc.enumerate_paths_idx(idx, backend="host",
                                  chunk_size=chunk_size, device="cpu")
    clean = tc.enumerate_paths_idx(idx, backend="device",
                                   chunk_size=chunk_size, device="cpu")
    _assert_same_walk(host, clean)
    rounds = _poison_scratch(monkeypatch)
    for count_only in (False, True):
        got = tc.enumerate_paths_idx(idx, backend="device",
                                     chunk_size=chunk_size,
                                     count_only=count_only, device="cpu")
        if count_only:
            assert got.count == host.count
            assert got.stats == host.stats
        else:
            _assert_same_walk(host, got)
    assert rounds, "the resident deque never ran"


def _split_k_sum(adj, counts, splits):
    """``adj @ counts`` as K3's q > 1 kernel sums it: K cut into slices of
    ``k_split`` columns (a multiple of the K step), each slice's product
    apart, the slices added in order, slice 0 first."""
    n = adj.shape[0]
    k_split = -(-(-(-n // splits)) // sr.GEMM_K_STEP) * sr.GEMM_K_STEP
    out = torch.zeros((n, counts.shape[1]), dtype=torch.float32)
    for z in range(splits):
        lo, hi = z * k_split, min(n, (z + 1) * k_split)
        if lo < hi:
            out = out + adj[:, lo:hi] @ counts[lo:hi]
    return out


@pytest.mark.parametrize("splits", [1, 2, 7, 16])
@pytest.mark.parametrize("n,q", [(2048, 1), (2000, 128), (129, 33)])
def test_split_k_sum_equals_plain(splits, n, q):
    top = 2 ** 24 - 1
    rng = np.random.default_rng(n * 31 + q * 7 + splits)
    # 0/1 edge counts and columns that sum to at most 2^24 - 1: every
    # result stays below 2^24; row 0 (all ones) reaches 2^24 - 1 in
    # column 0
    adj = rng.integers(0, 2, (n, n)).astype(np.float32)
    adj[0] = 1.0
    counts = rng.integers(0, top // n + 1, (n, q)).astype(np.float32)
    counts[:, 0] = top // n
    counts[0, 0] += top - n * (top // n)
    exact = adj.astype(np.float64) @ counts.astype(np.float64)
    assert exact.max() < 2 ** 24 and exact[0, 0] == top
    a, x = torch.from_numpy(adj), torch.from_numpy(counts)
    want = sr.counting_spmm_plain(a, x)
    np.testing.assert_array_equal(want.numpy(), exact)
    assert torch.equal(_split_k_sum(a, x, splits), want)


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_counting_splits_cover_k(sms):
    """The slices cover [0, n) with none empty, each a multiple of the K
    step and at least 128 deep when there are several, and the blocks of
    a launch (output tiles × slices) exceed the SM count only with one
    slice."""
    for n in (1, 15, 16, 17, 200, 1000, 2000, 2048, 5000):
        for q in (2, 3, 64, 65, 128, 129, 1000):
            splits, k_split = sr.counting_splits(n, q, sms)
            assert k_split % sr.GEMM_K_STEP == 0
            assert (splits - 1) * k_split < n <= splits * k_split
            tiles = -(-n // sr.GEMM_TILE_ROWS) * -(-q // sr.GEMM_TILE_COLS)
            if splits > 1:
                assert k_split >= 128 and tiles * splits <= sms
