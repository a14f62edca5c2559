"""``PathEnum.query`` of the port against ``repro``'s, end to end.

Same graph, same query, both packages: paths in order, lengths, count,
every stats field (``chunks`` included), ``exhausted``, the plan
(method, cut, T_DFS, T_JOIN) and the DP tables with ``backend_used``
must be equal for every mode × backend pair.  The port runs on the CPU
(its kernels' plain versions); ``repro``'s device backend runs its
Pallas kernels in interpret mode.  Where a leg would only add JAX
compile time, the reference is ``repro``'s host backend, which
``repro`` pins bit-identical to its device backend (``backend_used``
then differs by design and is not compared).  Further legs:
``first_n``, an expired deadline, the resident deque with a small
``chunk_size`` and a forced capacity stall, and the README quickstart
query with the device DP.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import clock as jclock
from repro_torch.core import clock as tclock
from repro_torch.core import enumerate as ten
from repro_torch.kernels import ops as tops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DP_FIELDS = ("c_to", "c_from", "q_prefix", "q_suffix")


def _assert_result(want, got, tag=""):
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag
    assert got.as_tuples() == want.as_tuples(), tag
    np.testing.assert_array_equal(got.paths, want.paths, err_msg=tag)
    np.testing.assert_array_equal(got.lengths, want.lengths, err_msg=tag)


def _assert_plan(want, got, tag="", same_backend=True):
    for f in ("method", "cut", "preliminary", "used_full_estimator",
              "t_dfs", "t_join", "est_results"):
        assert getattr(got, f) == getattr(want, f), f"{tag}: {f}"
    assert (got.dp is None) == (want.dp is None), tag
    if want.dp is not None:
        _assert_dp(want.dp, got.dp, tag, same_backend)


def _assert_dp(want, got, tag="", same_backend=True):
    if same_backend:
        assert got.backend_used == want.backend_used, tag
    assert (got.cut, got.t_dfs, got.t_join, got.q_total) == \
        (want.cut, want.t_dfs, want.t_join, want.q_total), tag
    for f in DP_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f"{tag}: {f}")


QUERIES = [("er", 0, 39, 4), ("dense", 0, 24, 4)]


def _graphs(name):
    if name == "er":
        return rc.erdos_renyi(40, 4.0, seed=7), tc.erdos_renyi(40, 4.0, seed=7)
    return rc.erdos_renyi(25, 8.0, seed=8), tc.erdos_renyi(25, 8.0, seed=8)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", ["auto", "dfs", "join"])
def test_query_equals_repro(mode, backend, monkeypatch):
    monkeypatch.delenv("REPRO_DEVICE_ENUM", raising=False)
    monkeypatch.delenv("REPRO_DEVICE_DEQUE", raising=False)
    for name, s, t, k in QUERIES:
        jg, tg = _graphs(name)
        # repro's device legs compile per shape in interpret mode, so the
        # second graph is held against repro's host backend, which repro
        # pins bit-identical to its device backend
        ref_backend = backend if name == "er" else "host"
        for tau in (1.0, 1e5):          # full estimator, and the τ gate
            want = rc.PathEnum(tau=tau, backend=ref_backend).query(
                jg, s, t, k, mode=mode)
            got = tc.PathEnum(tau=tau, backend=backend, device="cpu").query(
                tg, s, t, k, mode=mode)
            tag = f"{name} {mode} {backend} tau={tau}"
            _assert_result(want.result, got.result, tag)
            _assert_plan(want.plan, got.plan, tag,
                         same_backend=ref_backend == backend)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_first_n_and_count_only(backend):
    jg, tg = _graphs("dense")
    for mode in ("dfs", "join"):
        for first_n in (1, 7):
            want = rc.PathEnum(backend="host").query(
                jg, 0, 24, 4, mode=mode, first_n=first_n)
            got = tc.PathEnum(backend=backend, device="cpu").query(
                tg, 0, 24, 4, mode=mode, first_n=first_n)
            _assert_result(want.result, got.result, f"{mode} n={first_n}")
    want = rc.PathEnum(backend="host").query(jg, 0, 24, 4, mode="dfs",
                                             count_only=True)
    got = tc.PathEnum(backend=backend, device="cpu").query(
        tg, 0, 24, 4, mode="dfs", count_only=True)
    _assert_result(want.result, got.result, "count_only")
    assert got.result.paths.shape[0] == 0


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", ["dfs", "join"])
def test_expired_deadline(mode, backend):
    jg, tg = _graphs("er")
    want = rc.PathEnum(backend=backend).query(
        jg, 0, 39, 4, mode=mode, cut=2, deadline=jclock.now() - 1.0)
    got = tc.PathEnum(backend=backend, device="cpu").query(
        tg, 0, 39, 4, mode=mode, cut=2, deadline=tclock.now() - 1.0)
    _assert_result(want.result, got.result)
    assert got.result.count == 0 and not got.result.exhausted


@pytest.mark.parametrize("chunk_size", [5, 16])
def test_resident_deque_small_chunks_and_stall(chunk_size, monkeypatch):
    """The resident deque with a small chunk_size, and with an arena so
    small that the push guard trips mid-walk: the stall rebuilds the host
    work list and finishes on `_drive_from`, equal to repro's host walk."""
    monkeypatch.delenv("REPRO_DEVICE_DEQUE", raising=False)
    jg = rc.erdos_renyi(30, 6.0, seed=5)
    tg = tc.erdos_renyi(30, 6.0, seed=5)
    jidx = rc.build_index(jg, 0, 29, 5)
    idx = tc.build_index(tg, 0, 29, 5, device="cpu")
    want = rc.enumerate_paths_idx(jidx, backend="host", chunk_size=chunk_size)

    rounds = []
    real_round = tops.frontier_deque_round
    monkeypatch.setattr(tops, "frontier_deque_round",
                        lambda *a, **kw: rounds.append(1)
                        or real_round(*a, **kw))
    got = tc.enumerate_paths_idx(idx, backend="device",
                                 chunk_size=chunk_size, device="cpu")
    _assert_result(want, got, "resident")
    assert rounds, "the resident deque never ran"

    real_cfg = tops.deque_config

    def tiny(k1, cs, max_deg, round_pops=64):
        cfg = real_cfg(k1, cs, max_deg, round_pops)
        return dataclasses.replace(cfg, arena_cap=cfg.cap + 2,
                                   arena_rows=2 * cfg.cap + 2)

    monkeypatch.setattr(tops, "deque_config", tiny)
    resumed = []
    real_from = ten._drive_from
    monkeypatch.setattr(ten, "_drive_from",
                        lambda *a, **kw: resumed.append(1)
                        or real_from(*a, **kw))
    stalled = tc.enumerate_paths_idx(idx, backend="device",
                                     chunk_size=chunk_size, device="cpu")
    assert resumed, "the capacity stall never triggered"
    _assert_result(want, stalled, "stall")


def test_quickstart_join_runs_device_dp():
    """The README quickstart query, join plan: the port's device DP (plain
    versions on the CPU) equals repro's DP and both give the same paths."""
    jg = rc.power_law(2000, 6.0, seed=3)
    tg = tc.power_law(2000, 6.0, seed=3)
    want = rc.PathEnum(backend="host").query(jg, 1104, 997, 4, mode="join")
    got = tc.PathEnum(backend="device", device="cpu").query(
        tg, 1104, 997, 4, mode="join")
    _assert_result(want.result, got.result, "join")
    _assert_plan(want.plan, got.plan, "join")
    dp = tc.walk_count_dp(got.index, backend="device", device="cpu")
    assert dp.backend_used == "device"
    _assert_dp(rc.walk_count_dp(want.index, backend="host"), dp, "dp",
               same_backend=False)
    auto = tc.PathEnum(tau=1.0, backend="device", device="cpu").query(
        tg, 1104, 997, 4)
    assert auto.plan.dp.backend_used == "device"
    _assert_dp(dp, auto.plan.dp, "auto")


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("mode", ["dfs", "join"])
def test_ranked_and_constrained_wait_for_their_slice(mode, backend):
    """Ranked and constrained queries through ``PathEnum.query`` equal
    repro's (the slice that ports them has landed): ``order="hops"`` and
    ``"weight"``, with and without ``first_n``, and an
    ``AccumulativeValue`` constraint; an unknown order still raises."""
    from repro.core import constraints as jcons
    from repro.core import enumerate as jen
    from repro_torch.core import constraints as tcons
    jg, tg = _graphs("er")
    w = np.random.default_rng(7).integers(0, 4, size=tg.m).astype(float)
    pe = tc.PathEnum(backend=backend, device="cpu")
    for order in ("hops", "weight"):
        weights = w if order == "weight" else None
        for first_n in (None, 5):
            got = pe.query(tg, 0, 39, 4, mode=mode, cut=2, order=order,
                           weights=weights, first_n=first_n)
            if backend == "device" and mode == "dfs" and order == "hops":
                # repro's device leg: its bucketed driver on its host step
                jidx = rc.build_index(jg, 0, 39, 4)
                want = jen._drive_ranked_buckets(
                    jidx, jen._host_step(jidx, None),
                    chunk_size=16384, count_only=False, first_n=first_n,
                    max_results=None, deadline=None)
            else:
                want = rc.PathEnum(backend="host").query(
                    jg, 0, 39, 4, mode=mode, cut=2, order=order,
                    weights=weights, first_n=first_n).result
            _assert_result(want, got.result, f"{order} n={first_n}")
            assert got.result.as_tuples() == rc.oracle.enumerate_paths(
                jg, 0, 39, 4, order=order, weights=weights)[:first_n]
    want = rc.PathEnum(backend="host").query(
        jg, 0, 39, 4, mode=mode, cut=2,
        constraint=jcons.AccumulativeValue(w, accept=lambda b: b >= 4.0))
    got = pe.query(tg, 0, 39, 4, mode=mode, cut=2,
                   constraint=tcons.AccumulativeValue(
                       w, accept=lambda b: b >= 4.0))
    _assert_result(want.result, got.result, "constraint")
    assert 0 < got.result.count
    with pytest.raises(ValueError):
        pe.query(tg, 0, 39, 4, mode=mode, order="bogus")


def test_calibrate_tau_runs_the_paper_procedure():
    tg = tc.erdos_renyi(40, 4.0, seed=7)
    tau = tc.planner.calibrate_tau(tg, [(0, 39), (1, 38)], k=4,
                                   device="cpu")
    assert tau in (10.0 ** e for e in range(1, 8))
