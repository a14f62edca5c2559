"""The port's single deadline clock (``repro_torch.core.clock``) under
skew, mirroring tests/test_deadline_clock.py.

Serving mints an absolute deadline at admission and the enumeration
drivers compare against it between chunks.  The port's ``clock._source``
is skewed a million seconds away from ``time.perf_counter()``: every
deadline consumer (the host and device IDX-DFS drivers, the join, the
batch engine's shared walk and fused launch, the async server's enforced
deadlines) must still truncate exactly when the deadline has passed on
that clock.  A consumer reading ``time.perf_counter()`` directly would
see every deadline 1e6 s away and fail at once.  The ranked drivers
(heap, hop buckets, ranked join) must also return a rank-optimal prefix
when a deadline cuts them mid-run.  Untruncated results are held against
``repro``'s.
"""
import asyncio
import time

import numpy as np
import pytest
import torch

from torch_serving_parity import BACKENDS, assert_responses, side, sides

import repro.core as rc
import repro_torch.core as tc
from repro_torch.core import clock
from repro_torch.serving import STATUS_OK

SKEW = 1.0e6   # seconds between the skewed clock and time.perf_counter()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def skewed_clock(monkeypatch):
    """Shift the port's deadline clock far away from perf_counter."""
    monkeypatch.setattr(clock, "_source",
                        lambda: time.perf_counter() + SKEW)


def _case(seed=7, n=30, deg=3.0, k=4):
    g = tc.erdos_renyi(n, deg, seed=seed)
    rng = np.random.default_rng(seed)
    while True:
        s, t = map(int, rng.choice(n, 2, replace=False))
        idx = tc.build_index(g, s, t, k, device="cpu")
        if idx.num_index_edges:
            full = tc.enumerate_paths_idx(idx, backend="host", device="cpu")
            if full.count:
                return g, idx, full


def test_clock_primitives(monkeypatch):
    tick = [100.0]
    monkeypatch.setattr(clock, "_source", lambda: tick[0])
    assert clock.now() == 100.0
    assert clock.deadline_in(None) is None
    assert clock.deadline_in(2.5) == 102.5
    assert not clock.expired(None)
    assert not clock.expired(100.5)
    tick[0] = 100.5
    assert clock.expired(100.5)    # boundary: >= is expired
    assert clock.expired(100.0)


def test_drivers_truncate_on_skewed_clock(skewed_clock):
    g, idx, full = _case()
    want = rc.enumerate_paths_idx(rc.build_index(
        rc.erdos_renyi(30, 3.0, seed=7), idx.s, idx.t, idx.k))
    assert full.as_tuples() == want.as_tuples()
    past = clock.now() - 1.0
    future = clock.now() + 3600.0
    legs = [
        lambda dl: tc.enumerate_paths_idx(idx, backend="host", device="cpu",
                                          deadline=dl),
        lambda dl: tc.enumerate_paths_idx(idx, backend="device",
                                          device="cpu", deadline=dl),
        lambda dl: tc.enumerate_paths_idx(idx, backend="device",
                                          device="cpu", first_n=1,
                                          deadline=dl),
        lambda dl: tc.enumerate_paths_join(idx, cut=max(1, idx.k // 2),
                                           deadline=dl),
    ]
    for leg in legs:
        res = leg(past)
        assert res.count == 0 and not res.exhausted
        res = leg(future)
        assert 0 < res.count <= full.count
        if res.exhausted:
            assert sorted(res.as_tuples()) == sorted(want.as_tuples())


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_and_shared_walk_truncate_on_skewed_clock(skewed_clock,
                                                        backend):
    """Sharing on (the shared-walk leg), and on the device backend the
    fused K5 leg, both honour the skewed clock."""
    want_side, S = sides(backend)
    queries = [(0, 5, 4), (0, 6, 4), (1, 5, 3)]
    g = S.core.erdos_renyi(24, 3.0, seed=3)
    eng = S.engine()
    out = eng.run(g, queries, deadline=clock.now() - 1.0)
    assert all(not it.result.exhausted and it.result.count == 0
               for it in out.items)
    out = eng.run(g, queries, deadline=clock.now() + 3600.0,
                  count_only=False)
    ref = want_side.engine().run(want_side.core.erdos_renyi(24, 3.0, seed=3),
                                 queries, count_only=False)
    for a, b in zip(ref.items, out.items):
        assert b.result.exhausted
        assert b.result.as_tuples() == a.result.as_tuples()


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_server_slo_consistent_under_skew(skewed_clock, backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=5)
        reqs = [S.serving.PathQueryRequest(uid=i, s=0, t=5 + i, k=4,
                                           deadline_ms=60_000.0)
                for i in range(3)]

        async def drive():
            async with S.async_server(g, batch_window_ms=1.0,
                                      enforce_deadlines=True) as srv:
                return await srv.serve(reqs)
        return asyncio.run(drive())

    want = run(side("repro"))
    got = run(side("port", backend))
    assert_responses(want, got)
    for r in got:
        assert r.status == STATUS_OK and r.exhausted and r.slo_met


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_server_expired_deadline_truncates_under_skew(skewed_clock,
                                                            backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=5)
        reqs = [S.serving.PathQueryRequest(uid=0, s=0, t=5, k=4,
                                           deadline_ms=0.0)]

        async def drive():
            async with S.async_server(g, batch_window_ms=20.0,
                                      enforce_deadlines=True) as srv:
                return await srv.serve(reqs)
        return asyncio.run(drive())

    want = run(side("repro"))
    got = run(side("port", backend))
    assert_responses(want, got)
    (r,) = got
    assert r.status == STATUS_OK
    assert not r.exhausted and r.count == 0
    assert r.slo_met is False


# ---------------------------------------------------------------------------
# ranked drivers (DESIGN.md §10): a deadline cut is a rank-optimal prefix
# ---------------------------------------------------------------------------

def _ranked_runners(idx, w):
    """The port's ranked drivers as (label, fn(order, deadline))."""
    def weights(order):
        return w if order == "weight" else None
    return [
        ("heap", lambda order, dl: tc.enumerate_paths_idx(
            idx, backend="host", device="cpu", order=order,
            weights=weights(order), deadline=dl)),
        ("device", lambda order, dl: tc.enumerate_paths_idx(
            idx, backend="device", device="cpu", order=order,
            weights=weights(order), deadline=dl, chunk_size=4)),
        ("join", lambda order, dl: tc.enumerate_paths_join(
            idx, cut=max(1, idx.k // 2), order=order,
            weights=weights(order), deadline=dl)),
    ]


@pytest.mark.parametrize("order", ["hops", "weight"])
def test_ranked_drivers_truncate_on_skewed_clock(skewed_clock, order):
    """An expired deadline on the skewed clock returns an empty,
    unexhausted result; a live one returns repro's full ranked run."""
    g, idx, full = _case(seed=11, n=40, deg=4.0, k=5)
    w = np.random.default_rng(11).integers(0, 4, size=g.m).astype(float)
    jidx = rc.build_index(rc.erdos_renyi(40, 4.0, seed=11), idx.s, idx.t,
                          idx.k)
    want = rc.enumerate_paths_idx(jidx, order=order,
                                  weights=w if order == "weight" else None)
    for label, run in _ranked_runners(idx, w):
        res = run(order, clock.now() - 1.0)
        assert res.count == 0 and not res.exhausted, label
        assert res.paths.shape[0] == 0, label
        res = run(order, clock.now() + 3600.0)
        assert res.exhausted and res.as_tuples() == want.as_tuples(), label


@pytest.mark.parametrize("order", ["hops", "weight"])
def test_ranked_mid_run_deadline_is_rank_optimal_prefix(monkeypatch, order):
    """A clock that ticks once per read expires the deadline part way
    through each ranked driver, at a point that does not depend on the
    host's speed: whatever was emitted is exactly the best-ranked prefix
    of repro's sequence, and some cut lands strictly inside it."""
    g, idx, _full = _case(seed=11, n=40, deg=4.0, k=5)
    w = np.random.default_rng(11).integers(0, 4, size=g.m).astype(float)
    jidx = rc.build_index(rc.erdos_renyi(40, 4.0, seed=11), idx.s, idx.t,
                          idx.k)
    want = rc.enumerate_paths_idx(
        jidx, order=order,
        weights=w if order == "weight" else None).as_tuples()
    tick = [0.0]

    def ticking():
        tick[0] += 1.0
        return tick[0]
    monkeypatch.setattr(clock, "_source", ticking)
    for label, run in _ranked_runners(idx, w):
        inside = 0
        for reads in (1, 2, 3, 5, 8, 13, 40, 200):
            res = run(order, clock.now() + reads)
            seq = res.as_tuples()
            assert seq == want[:len(seq)], (label, reads)
            if res.exhausted:
                assert len(seq) == len(want), (label, reads)
            elif 0 < len(seq) < len(want):
                inside += 1
        assert inside > 0, label


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_ranked_expired_deadline_truncates_under_skew(skewed_clock,
                                                            backend):
    """Enforced 0 ms deadlines on ranked requests: empty, unexhausted
    responses, equal to repro's."""
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=5)
        w = np.random.default_rng(5).integers(0, 4, size=g.m).astype(float)
        reg = S.serving.GraphRegistry()
        reg.register("w", g, edge_weights=w)
        reqs = [S.serving.PathQueryRequest(uid=i, s=0, t=5, k=4,
                                           graph_id="w", order=order,
                                           count_only=False,
                                           deadline_ms=0.0)
                for i, order in enumerate(("hops", "weight"))]

        async def drive():
            async with S.async_server(reg, batch_window_ms=20.0,
                                      enforce_deadlines=True) as srv:
                return await srv.serve(reqs)
        return asyncio.run(drive())

    want = run(side("repro"))
    got = run(side("port", backend))
    assert_responses(want, got)
    for r in got:
        assert r.status == STATUS_OK
        assert not r.exhausted and r.count == 0
        assert r.slo_met is False
