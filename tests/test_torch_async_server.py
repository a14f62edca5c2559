"""The port's ``AsyncHcPEServer`` against ``repro``'s, test for test.

Mirrors tests/test_async_server.py: admission, EDF scheduling, deadlines
and parity with the sync server.  Each scenario runs on ``repro``'s
front-end (host backend) and on the port's on the CPU under both port
backends (``"device"`` runs the plain versions of K1, K2 and K5), and
the responses are held equal field by field, times masked
(tests/torch_serving_parity.py).  ``repro``'s wall-clock comparison of
light-query p99 against the sync server is a measurement of the card
(``chip_smoke.py``'s ``serve`` phase); here its deterministic part is
asserted: the tight-SLO requests complete before the heavy one, with
the sync server's counts.
"""
import asyncio
import time

import numpy as np
import pytest
import torch

from torch_serving_parity import (BACKENDS, assert_paths, assert_report,
                                  assert_responses, is_path,
                                  random_requests, ranked_registry,
                                  ranked_sides, resp_paths, side, sides)

import repro.core as rc
import repro_torch.core as tc
from repro.serving.hcpe import _merge_outputs as repro_merge
from repro_torch.core.batch import BatchOutput, BatchTiming, CacheStats
from repro_torch.serving import (STATUS_OK, STATUS_REJECTED_NO_WEIGHTS,
                                 STATUS_REJECTED_QUEUE_FULL,
                                 STATUS_REJECTED_QUOTA,
                                 STATUS_REJECTED_SHUTDOWN, PathQueryRequest)
from repro_torch.serving.hcpe import _merge_outputs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(backend, scenario, monkeypatch=None):
    """``scenario(side)`` on repro's side and on the port's (ranked
    scenarios pass ``monkeypatch`` and take `ranked_sides`)."""
    want_side, got_side = sides(backend) if monkeypatch is None \
        else ranked_sides(backend, monkeypatch)
    return scenario(want_side), scenario(got_side)


def _light(S, g, count, rng, k=3, deadline_ms=None, uid0=0):
    return random_requests(S.serving.PathQueryRequest, g, count, rng, k=k,
                           deadline_ms=deadline_ms, uid0=uid0)


# ---------------------------------------------------------------------------
# correctness: async == sync == sequential
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_async_counts_match_sync_engine(backend):
    def run(S):
        g = S.core.erdos_renyi(80, 4.0, seed=4)
        reqs = _light(S, g, 12, np.random.default_rng(0), k=4,
                      deadline_ms=60_000.0)

        async def drive():
            async with S.async_server(g, batch_window_ms=1.0) as srv:
                return await srv.serve(reqs), srv.drain_report()
        return g, reqs, *asyncio.run(drive())

    (_, _, want, want_rep), (g, reqs, got, got_rep) = _both(backend, run)
    assert_responses(want, got)
    assert_report(want_rep, got_rep)
    assert [r.uid for r in got] == [q.uid for q in reqs]
    seq = rc.PathEnum()
    gr = rc.erdos_renyi(80, 4.0, seed=4)
    for r, q in zip(got, reqs):
        assert r.status == STATUS_OK and r.exhausted
        assert r.count == seq.count(gr, q.s, q.t, q.k)


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_latency_split_and_slo_flag(backend):
    def run(S):
        g = S.core.erdos_renyi(50, 3.0, seed=1)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=0, s=0, t=1, k=3, deadline_ms=60_000.0),
                Q(uid=1, s=0, t=2, k=3)]

        async def drive():
            async with S.async_server(g, batch_window_ms=1.0) as srv:
                return await srv.serve(reqs)
        return asyncio.run(drive())

    want, got = _both(backend, run)
    assert_responses(want, got)
    with_slo, without_slo = got
    assert with_slo.slo_met is True
    assert without_slo.slo_met is None
    for r in (with_slo, without_slo):
        assert r.queue_ms >= 0.0 and r.service_ms > 0.0
        assert r.total_ms == pytest.approx(r.queue_ms + r.service_ms,
                                           rel=1e-6, abs=1e-6)


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_dedup_inside_micro_batch(backend):
    def run(S):
        g = S.core.erdos_renyi(60, 4.0, seed=2)
        reqs = [S.serving.PathQueryRequest(uid=i, s=0, t=1, k=4,
                                           deadline_ms=60_000.0)
                for i in range(4)]

        async def drive():
            async with S.async_server(g, batch_window_ms=5.0) as srv:
                return await srv.serve(reqs), srv.stats.micro_batches
        return asyncio.run(drive())

    (want, want_mb), (got, got_mb) = _both(backend, run)
    assert_responses(want, got)
    assert got_mb == want_mb == 1
    assert sum(r.deduplicated for r in got) == len(got) - 1
    assert len({r.count for r in got}) == 1


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_queue_depth_rejection_is_a_response(backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=3)
        reqs = _light(S, g, 6, np.random.default_rng(1), deadline_ms=60_000.0)

        async def drive():
            async with S.async_server(g, batch_window_ms=10.0,
                                      max_queue_depth=2) as srv:
                return await srv.serve(reqs), srv.stats
        return asyncio.run(drive())

    (want, want_stats), (got, stats) = _both(backend, run)
    assert_responses(want, got)
    assert stats.rejected_queue_full == want_stats.rejected_queue_full == 4
    assert stats.slo_missed == want_stats.slo_missed >= 4
    ok = [r for r in got if r.status == STATUS_OK]
    shed = [r for r in got if r.status == STATUS_REJECTED_QUEUE_FULL]
    assert len(ok) == 2 and len(shed) == 4
    for r in shed:
        assert r.rejected and r.count == 0 and r.paths is None
        assert r.slo_met is False


@pytest.mark.parametrize("backend", BACKENDS)
def test_per_uid_quota_rejection(backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=3)
        Q = S.serving.PathQueryRequest
        flood = [Q(uid=7, s=0, t=i, k=3) for i in range(1, 5)]
        fair = [Q(uid=8, s=0, t=5, k=3)]

        async def drive():
            async with S.async_server(g, batch_window_ms=10.0,
                                      max_pending_per_uid=1) as srv:
                return await srv.serve(flood + fair)
        return asyncio.run(drive())

    want, got = _both(backend, run)
    assert_responses(want, got)
    assert [r.status for r in got[:4]].count(STATUS_REJECTED_QUOTA) == 3
    assert got[0].status == STATUS_OK and got[4].status == STATUS_OK


@pytest.mark.parametrize("backend", BACKENDS)
def test_shutdown_rejects_new_but_drains_admitted(backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=5)
        Q = S.serving.PathQueryRequest

        async def drive():
            srv = S.async_server(g, batch_window_ms=30.0)
            await srv.start()
            admitted = asyncio.ensure_future(
                srv.submit(Q(uid=0, s=0, t=1, k=3)))
            await asyncio.sleep(0.005)
            stop = asyncio.ensure_future(srv.stop())
            await asyncio.sleep(0)
            late = await srv.submit(Q(uid=1, s=0, t=2, k=3))
            first = await admitted
            await stop
            return [first, late]
        return asyncio.run(drive())

    want, got = _both(backend, run)
    assert_responses(want, got)
    assert got[0].status == STATUS_OK
    assert got[1].status == STATUS_REJECTED_SHUTDOWN


@pytest.mark.parametrize("backend", BACKENDS)
def test_stop_drains_without_waiting_out_the_batch_window(backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=5)

        async def drive():
            srv = S.async_server(g, batch_window_ms=5_000.0)
            await srv.start()
            futs = [asyncio.ensure_future(srv.submit(
                S.serving.PathQueryRequest(uid=i, s=i, t=i + 3, k=3)))
                for i in range(4)]
            await asyncio.sleep(0.005)
            t0 = time.perf_counter()
            await srv.stop()
            drained_ms = (time.perf_counter() - t0) * 1e3
            return list(await asyncio.gather(*futs)), drained_ms
        return asyncio.run(drive())

    (want, _), (got, drained_ms) = _both(backend, run)
    assert_responses(want, got)
    assert all(r.status == STATUS_OK for r in got)
    assert drained_ms < 2_500.0              # half the 5 s window


@pytest.mark.parametrize("backend", BACKENDS)
def test_malformed_queries_raise_not_reject(backend):
    def run(S):
        g = S.core.erdos_renyi(20, 2.0, seed=0)
        Q = S.serving.PathQueryRequest

        async def drive():
            async with S.async_server(g, batch_window_ms=1.0) as srv:
                with pytest.raises(ValueError):
                    await srv.submit(Q(uid=0, s=0, t=1, k=1))
                with pytest.raises(ValueError):
                    await srv.submit(Q(uid=0, s=3, t=3, k=4))
                with pytest.raises(ValueError):
                    await srv.submit(Q(uid=0, s=999, t=1, k=4))
                with pytest.raises(ValueError, match="unknown order"):
                    await srv.submit(Q(uid=0, s=0, t=1, k=4, order="lex"))
                ok = await srv.submit(Q(uid=1, s=0, t=1, k=4))
                return [ok], srv.stats.submitted
        return asyncio.run(drive())

    (want, want_n), (got, got_n) = _both(backend, run)
    assert_responses(want, got)
    assert got[0].status == STATUS_OK
    assert got_n == want_n == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_cancelled_submit_does_not_kill_scheduler(backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=5)
        Q = S.serving.PathQueryRequest

        async def drive():
            async with S.async_server(g, batch_window_ms=5.0) as srv:
                doomed = asyncio.ensure_future(
                    srv.submit(Q(uid=0, s=0, t=1, k=3)))
                await asyncio.sleep(0.001)
                doomed.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await doomed
                resp = await asyncio.wait_for(
                    srv.submit(Q(uid=1, s=0, t=2, k=3)), timeout=30)
            return [resp], srv.stats
        return asyncio.run(drive())

    (want, want_stats), (got, stats) = _both(backend, run)
    assert_responses(want, got)
    assert got[0].status == STATUS_OK
    assert (stats.cancelled, stats.completed) == \
        (want_stats.cancelled, want_stats.completed) == (1, 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_submit_before_start_raises(backend):
    S = side("port", backend)
    srv = S.async_server(S.core.erdos_renyi(20, 2.0, seed=0))

    async def drive():
        with pytest.raises(RuntimeError, match="not started"):
            await srv.submit(PathQueryRequest(uid=0, s=0, t=1, k=3))

    asyncio.run(drive())
    assert srv.stats.submitted == 0


# ---------------------------------------------------------------------------
# deadline enforcement (cooperative chunk budget)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_enforce_deadlines_truncates_with_exhausted_false(backend):
    """A query that cannot finish in 1 ms stops at a chunk boundary (on
    the device backend: after a whole deque round), and what it returns
    is a subset of the full result.  The prefix's length depends on the
    host's speed, so it is checked for membership, not against repro's."""
    S = side("port", backend)
    g = S.core.erdos_renyi(200, 12.0, seed=3)
    req = PathQueryRequest(uid=0, s=0, t=1, k=8, count_only=False,
                           deadline_ms=1.0)

    async def drive():
        async with S.async_server(g, batch_window_ms=0.0,
                                  enforce_deadlines=True) as srv:
            return await srv.submit(req)

    resp = asyncio.run(drive())
    assert resp.status == STATUS_OK
    assert not resp.exhausted
    assert resp.slo_met is False
    full = rc.PathEnum().count(rc.erdos_renyi(200, 12.0, seed=3), 0, 1, 8)
    assert resp.count < full
    assert resp.paths.shape[0] == resp.count
    rows = resp.paths[:: max(1, resp.count // 64)]   # a spread sample
    assert all(is_path(g, row, 0, 1, 8) for row in rows)
    assert len({tuple(r) for r in resp.paths.tolist()}) == resp.count


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_deadline_noop_when_far_future(backend):
    """Deadline semantics are a backend contract: a far-future deadline
    changes nothing (paths, order and stats equal repro's)."""
    want_side, S = sides(backend)
    queries = [(0, 1, 4), (2, 3, 4)]
    g = S.core.erdos_renyi(60, 4.0, seed=9)
    far = S.engine().run(g, queries, count_only=False,
                         deadline=S.core.clock.now() + 3600.0)
    ref = want_side.engine().run(want_side.core.erdos_renyi(60, 4.0, seed=9),
                                 queries, count_only=False)
    for a, b in zip(ref.items, far.items):
        assert b.result.exhausted and b.result.count == a.result.count
        assert_paths(a.result.paths, b.result.paths)
        assert vars(b.result.stats) == vars(a.result.stats)


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_deadline_already_passed_yields_empty_unexhausted(backend):
    def run(S):
        g = S.core.erdos_renyi(60, 4.0, seed=9)
        return S.engine().run(g, [(0, 1, 4)], count_only=False,
                              deadline=S.core.clock.now() - 1.0).items[0]

    want, got = _both(backend, run)
    assert got.result.count == want.result.count == 0
    assert not got.result.exhausted and not want.result.exhausted
    assert got.result.paths.shape == want.result.paths.shape == (0, 5)
    assert vars(got.result.stats) == vars(want.result.stats)


# ---------------------------------------------------------------------------
# the mixed workload: EDF serves the tight-SLO requests first
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_light_requests_jump_heavy_under_mixed_workload(backend):
    """1 heavy + 20 light queries, the heavy one submitted first with a
    looser deadline: the lights complete before it (EDF), in one
    micro-batch, and every count equals the sync server's.  The p99
    comparison against the sync server is the card's ``serve`` phase."""
    def run(S):
        g = S.core.erdos_renyi(200, 12.0, seed=3)
        Q = S.serving.PathQueryRequest
        heavy = Q(uid=0, s=0, t=1, k=5, deadline_ms=120_000.0)
        lights = _light(S, g, 20, np.random.default_rng(11), k=3,
                        deadline_ms=60_000.0, uid0=1)
        workload = [heavy] + lights
        sync, _ = S.server(g).serve(workload)
        order = []

        async def drive():
            async with S.async_server(g, batch_window_ms=2.0) as srv:
                async def tracked(req):
                    resp = await srv.submit(req)
                    order.append(resp.uid)
                    return resp
                resps = await asyncio.gather(*(tracked(r) for r in workload))
                return list(resps), srv.stats.micro_batches
        resps, batches = asyncio.run(drive())
        return sync, resps, order, batches

    (w_sync, want, w_order, w_mb), (sync, got, order, mb) = \
        _both(backend, run)
    assert_responses(w_sync, sync)
    assert_responses(want, got)
    assert order == w_order and mb == w_mb == 2
    assert order[-1] == 0                    # the heavy query finished last
    assert [r.count for r in got] == [r.count for r in sync]


# ---------------------------------------------------------------------------
# _merge_outputs timing semantics (regression for the async scheduler)
# ---------------------------------------------------------------------------

def _span_output(start, end, cls=BatchOutput, timing=BatchTiming,
                 cache=CacheStats):
    return cls(items=[], cache_stats=cache(), distinct_queries=0,
               timing=timing(total_seconds=end - start, started_at=start,
                             ended_at=end))


def _merged_both(spans):
    from repro.core import batch as jb
    want = repro_merge([_span_output(a, b, jb.BatchOutput, jb.BatchTiming,
                                     jb.CacheStats) for a, b in spans])
    got = _merge_outputs([_span_output(a, b) for a, b in spans])
    assert vars(got.timing) == vars(want.timing)
    return got


def test_merge_outputs_overlapping_groups_use_union_span():
    merged = _merged_both([(10.0, 12.0), (11.0, 13.5)])
    assert merged.timing.total_seconds == pytest.approx(3.5)
    assert (merged.timing.started_at, merged.timing.ended_at) == (10.0, 13.5)


def test_merge_outputs_idle_gaps_not_billed_as_serving_time():
    merged = _merged_both([(10.0, 11.0), (20.0, 21.0)])
    assert merged.timing.total_seconds == pytest.approx(2.0)
    assert (merged.timing.started_at, merged.timing.ended_at) == (10.0, 21.0)


def test_merge_outputs_without_spans_falls_back_to_sum():
    a = BatchOutput(items=[], cache_stats=CacheStats(), distinct_queries=0,
                    timing=BatchTiming(total_seconds=1.0))
    b = BatchOutput(items=[], cache_stats=CacheStats(), distinct_queries=0,
                    timing=BatchTiming(total_seconds=2.0))
    assert _merge_outputs([a, b]).timing.total_seconds == pytest.approx(3.0)
    assert _merge_outputs([]).items == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_real_engine_outputs_carry_spans(backend):
    S = side("port", backend)
    out = S.engine().run(S.core.erdos_renyi(40, 3.0, seed=6), [(0, 1, 3)])
    assert out.timing.ended_at > out.timing.started_at > 0.0
    assert out.timing.total_seconds == pytest.approx(
        out.timing.ended_at - out.timing.started_at)


# ---------------------------------------------------------------------------
# ranked requests (DESIGN.md §10), mirroring tests/test_ranked.py's
# serving cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_ranked_request_raises_sync_and_fails_async_group(backend,
                                                          monkeypatch):
    """``order="hops"`` reaches the engine and is served: the sync server
    and the async server answer it in rank order, as repro's do, and no
    micro-batch fails (``stats.failed == 0``)."""
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=5)
        Q = S.serving.PathQueryRequest
        ranked = Q(uid=0, s=0, t=1, k=3, order="hops", count_only=False)
        sync, _ = S.server(g).serve([ranked])

        async def drive():
            async with S.async_server(g, batch_window_ms=1.0) as srv:
                got = await srv.submit(ranked)
                ok = await srv.submit(Q(uid=1, s=0, t=2, k=3))
                return [got, ok], srv.metrics_snapshot()
        return sync, *asyncio.run(drive())

    (want_sync, want, _), (got_sync, got, snap) = \
        _both(backend, run, monkeypatch)
    assert_responses(want_sync, got_sync)
    assert_responses(want, got)
    assert got_sync[0].status == got[0].status == STATUS_OK
    assert resp_paths(got_sync[0]) == resp_paths(got[0])
    assert (snap.serve.failed, snap.serve.completed) == (0, 2)
    assert snap.violations() == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_server_ranked_and_no_weights_rejection(backend, monkeypatch):
    def run(S):
        reg, g, s, t, k, w = ranked_registry(S, 600)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=0, s=s, t=t, k=k, count_only=False,
                  graph_id="weighted", order="weight"),
                Q(uid=1, s=s, t=t, k=k, count_only=False,
                  graph_id="plain", order="weight"),
                Q(uid=2, s=s, t=t, k=k, count_only=False,
                  graph_id="plain", order="hops"),
                Q(uid=3, s=s, t=t, k=k, count_only=False, first_n=2,
                  graph_id="weighted", order="weight")]
        resps, rep = S.server(reg).serve(reqs)
        return resps, rep, (g, s, t, k, w)

    (want, want_rep, _), (got, got_rep, (g, s, t, k, w)) = \
        _both(backend, run, monkeypatch)
    assert_responses(want, got)
    assert_report(want_rep, got_rep)
    want_w = tc.oracle.enumerate_paths(g, s, t, k, order="weight",
                                       weights=w)
    assert got[0].status == STATUS_OK and resp_paths(got[0]) == want_w
    # weight rank against a weightless tenant: a rejection, zero results
    assert got[1].status == STATUS_REJECTED_NO_WEIGHTS and got[1].count == 0
    assert got[2].status == STATUS_OK
    assert resp_paths(got[2]) == tc.oracle.enumerate_paths(g, s, t, k,
                                                           order="hops")
    assert resp_paths(got[3]) == want_w[:2]


@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_server_groups_by_order(backend, monkeypatch):
    """Same (graph, count_only, first_n) but different order never share
    an engine batch: each answers in its own order."""
    def run(S):
        reg, g, s, t, k, w = ranked_registry(S, 601)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=0, s=s, t=t, k=k, count_only=False,
                  graph_id="weighted", order="weight"),
                Q(uid=1, s=s, t=t, k=k, count_only=False,
                  graph_id="weighted", order="hops"),
                Q(uid=2, s=s, t=t, k=k, count_only=False,
                  graph_id="weighted")]
        resps, rep = S.server(reg).serve(reqs)
        return resps, rep, (g, s, t, k, w)

    (want, want_rep, _), (got, got_rep, (g, s, t, k, w)) = \
        _both(backend, run, monkeypatch)
    assert_responses(want, got)
    assert_report(want_rep, got_rep)
    assert resp_paths(got[0]) == tc.oracle.enumerate_paths(
        g, s, t, k, order="weight", weights=w)
    assert resp_paths(got[1]) == tc.oracle.enumerate_paths(g, s, t, k,
                                                           order="hops")
    assert tc.oracle.paths_as_set(resp_paths(got[2])) == \
        tc.oracle.paths_as_set(tc.oracle.enumerate_paths(g, s, t, k))


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_server_ranked_serving_and_admission(backend, monkeypatch):
    def run(S):
        reg, g, s, t, k, w = ranked_registry(S, 602)
        Q = S.serving.PathQueryRequest

        async def drive():
            async with S.async_server(reg, batch_window_ms=1.0) as srv:
                got = await asyncio.gather(
                    srv.submit(Q(uid=0, s=s, t=t, k=k, count_only=False,
                                 graph_id="weighted", order="weight")),
                    srv.submit(Q(uid=1, s=s, t=t, k=k, count_only=False,
                                 graph_id="plain", order="weight")),
                    srv.submit(Q(uid=2, s=s, t=t, k=k, count_only=False,
                                 first_n=2, graph_id="weighted",
                                 order="weight")),
                    srv.submit(Q(uid=3, s=s, t=t, k=k, count_only=False,
                                 first_n=2, graph_id="plain",
                                 order="hops")))
                return list(got), srv.stats
        return (*asyncio.run(drive()), (g, s, t, k, w))

    (want, want_stats, _), (got, stats, (g, s, t, k, w)) = \
        _both(backend, run, monkeypatch)
    assert_responses(want, got)
    want_w = tc.oracle.enumerate_paths(g, s, t, k, order="weight", weights=w)
    assert got[0].status == STATUS_OK and resp_paths(got[0]) == want_w
    assert got[1].status == STATUS_REJECTED_NO_WEIGHTS and got[1].count == 0
    assert stats.rejected_no_weights == want_stats.rejected_no_weights == 1
    assert stats.failed == 0
    # EDF front-end under order: first_n is the top n, not some n
    assert resp_paths(got[2]) == want_w[:2]
    assert resp_paths(got[3]) == tc.oracle.enumerate_paths(
        g, s, t, k, order="hops")[:2]


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_weights_dropped_mid_flight_reject_the_group(backend,
                                                          monkeypatch):
    """A tenant re-registered without weights between admission and
    dispatch: the accepted weight-ranked group settles as
    ``rejected_no_weights`` under ``rejected_mid_flight``."""
    def run(S):
        reg, g, s, t, k, w = ranked_registry(S, 603)
        Q = S.serving.PathQueryRequest

        async def drive():
            async with S.async_server(reg, batch_window_ms=30.0) as srv:
                fut = asyncio.ensure_future(srv.submit(
                    Q(uid=0, s=s, t=t, k=k, graph_id="weighted",
                      order="weight")))
                await asyncio.sleep(0)
                reg.register("weighted", g)          # weights dropped
                resp = await fut
                return [resp], srv.stats
        return asyncio.run(drive())

    (want, want_stats), (got, stats) = _both(backend, run, monkeypatch)
    assert_responses(want, got)
    assert got[0].status == STATUS_REJECTED_NO_WEIGHTS
    assert stats.rejected_mid_flight == want_stats.rejected_mid_flight == 1
    assert stats.failed == 0
