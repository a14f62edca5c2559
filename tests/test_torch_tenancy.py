"""Multi-graph tenancy of the port's front-ends against ``repro``'s.

Mirrors tests/test_tenancy.py (DESIGN.md §8): the registry's semantics,
two tenants served through ``HcPEServer`` and ``AsyncHcPEServer``,
per-tenant cache stats and quotas, and the single-graph compatibility
contract.  Every scenario runs on ``repro``'s front-ends (host backend)
and on the port's on the CPU under both port backends; responses and
reports are held equal field by field, times masked
(tests/torch_serving_parity.py).
"""
import asyncio

import numpy as np
import pytest
import torch

from torch_serving_parity import (BACKENDS, assert_report, assert_responses,
                                  cache_dict, random_requests, side, sides)

import repro.core as rc
from repro_torch.core import DEFAULT_GRAPH_ID
from repro_torch.core.graph import PAD
from repro_torch.serving import (STATUS_OK, STATUS_REJECTED_TENANT_QUOTA,
                                 STATUS_REJECTED_UNKNOWN_GRAPH, GraphRegistry)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(backend, scenario):
    want_side, got_side = sides(backend)
    return scenario(want_side), scenario(got_side)


def _requests(S, g, graph_id, count, rng, k=4, uid0=0, **kw):
    return random_requests(S.serving.PathQueryRequest, g, count, rng, k=k,
                           uid0=uid0, graph_id=graph_id, **kw)


def _two_tenants(S):
    return (S.core.erdos_renyi(70, 4.0, seed=3),
            S.core.power_law(90, 5.0, seed=8))


def _registry(S, **tenants):
    reg = S.serving.GraphRegistry()
    for gid, g in tenants.items():
        reg.register(gid, g)
    return reg


# ---------------------------------------------------------------------------
# registry semantics
# ---------------------------------------------------------------------------

def test_registry_register_retire_lookup():
    g_a, g_b = _two_tenants(side("port"))
    reg = GraphRegistry()
    reg.register("a", g_a)
    entry = reg.register("b", g_b, cache_quota=7, max_pending=3)
    assert reg.graph_ids() == ("a", "b")
    assert "a" in reg and len(reg) == 2
    assert reg.get("b") is g_b and reg.entry("b") is entry
    assert (entry.cache_quota, entry.max_pending) == (7, 3)
    retired = reg.retire("a")
    assert retired.graph is g_a
    assert "a" not in reg
    with pytest.raises(KeyError):
        reg.get("a")
    assert GraphRegistry.wrap(reg) is reg
    assert GraphRegistry.wrap(g_a).get(DEFAULT_GRAPH_ID) is g_a


def test_registry_empty_graph_id_and_bad_weights_rejected():
    g = side("port").core.erdos_renyi(10, 2.0, seed=0)
    with pytest.raises(ValueError, match="non-empty"):
        GraphRegistry().register("", g)
    with pytest.raises(ValueError, match="edge_weights"):
        GraphRegistry().register("w", g, edge_weights=np.ones(g.m + 1))


@pytest.mark.parametrize("backend", BACKENDS)
def test_registry_binds_quota_to_engine_cache(backend):
    def run(S):
        g_a, g_b = _two_tenants(S)
        reg = S.serving.GraphRegistry()
        reg.register("a", g_a, cache_quota=2)
        server = S.server(reg)
        quotas = [server.engine.cache.quota_for("a")]
        reg.register("b", g_b, cache_quota=5)
        quotas.append(server.engine.cache.quota_for("b"))
        reg.bind_engine(server.engine)         # idempotent
        return quotas, len(reg._engines)

    want, got = _both(backend, run)
    assert got == want == ([2, 5], 1)


@pytest.mark.parametrize("backend", BACKENDS)
def test_retire_drops_tenant_cache_entries(backend):
    def run(S):
        g_a, g_b = _two_tenants(S)
        reg = _registry(S, a=g_a, b=g_b)
        server = S.server(reg)
        rng = np.random.default_rng(0)
        resps, report = server.serve(
            _requests(S, g_a, "a", 4, rng)
            + _requests(S, g_b, "b", 4, rng, uid0=4))
        cache = server.engine.cache
        before = (cache.tenant_len("a"), cache.tenant_len("b"))
        reg.retire("a")
        return resps, report, before, (cache.tenant_len("a"),
                                       cache.tenant_len("b"),
                                       len(server.engine.group_cache))

    (w_resps, w_rep, w_before, w_after), (resps, rep, before, after) = \
        _both(backend, run)
    assert_responses(w_resps, resps)
    assert_report(w_rep, rep)
    assert before == w_before and min(before) > 0
    assert after == w_after and after[0] == 0 and after[1] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_reregister_same_id_invalidates_old_graph_entries(backend):
    def run(S):
        g_old, g_new = _two_tenants(S)
        reg = _registry(S, x=g_old)
        server = S.server(reg)
        rng = np.random.default_rng(1)
        server.serve(_requests(S, g_old, "x", 3, rng))
        held = server.engine.cache.tenant_len("x")
        reg.register("x", g_new)
        dropped = server.engine.cache.tenant_len("x")
        resps, report = server.serve(_requests(S, g_new, "x", 5, rng))
        return held, dropped, resps, report

    (w_held, _, want, w_rep), (held, dropped, got, rep) = _both(backend, run)
    assert held == w_held > 0 and dropped == 0
    assert_responses(want, got)
    assert_report(w_rep, rep)
    assert rep.cache.hits == 0


# ---------------------------------------------------------------------------
# sync server: two tenants == two single-tenant runs, byte-identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_two_tenants_byte_identical_to_single_tenant_runs(backend):
    def run(S):
        g_a, g_b = _two_tenants(S)
        rng = np.random.default_rng(7)
        reqs_a = _requests(S, g_a, "a", 8, rng, count_only=False)
        reqs_b = _requests(S, g_b, "b", 8, rng, uid0=8, count_only=False)
        interleaved = [r for pair in zip(reqs_a, reqs_b) for r in pair]
        resps, report = S.server(_registry(S, a=g_a, b=g_b)).serve(
            interleaved)
        Q = S.serving.PathQueryRequest
        solo = {}
        for g, reqs in ((g_a, reqs_a), (g_b, reqs_b)):
            out, _ = S.server(g).serve(
                [Q(uid=r.uid, s=r.s, t=r.t, k=r.k, count_only=False)
                 for r in reqs])
            solo.update({r.uid: r for r in out})
        return interleaved, resps, report, solo

    (_, want, w_rep, _), (reqs, got, rep, solo) = _both(backend, run)
    assert_responses(want, got)
    assert_report(w_rep, rep)
    for r, q in zip(got, reqs):
        assert r.status == STATUS_OK and r.graph_id == q.graph_id
        np.testing.assert_array_equal(r.paths, solo[r.uid].paths)
    assert set(rep.tenant_cache) == {"a", "b"}
    assert rep.tenant_cache["a"].misses + rep.tenant_cache["b"].misses \
        == rep.cache.misses


@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_unknown_graph_is_rejection_response(backend):
    def run(S):
        g_a, _ = _two_tenants(S)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=0, s=0, t=1, k=3, graph_id="a"),
                Q(uid=1, s=0, t=1, k=3, graph_id="ghost")]
        return S.server(_registry(S, a=g_a)).serve(reqs)

    (want, w_rep), (got, rep) = _both(backend, run)
    assert_responses(want, got)
    assert_report(w_rep, rep)
    assert got[0].status == STATUS_OK
    assert got[1].status == STATUS_REJECTED_UNKNOWN_GRAPH
    assert got[1].rejected and got[1].count == 0 and got[1].graph_id == "ghost"
    assert rep.batch_size == 1 and rep.distinct_queries == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_single_graph_caller_unchanged_default_graph_id(backend):
    def run(S):
        g = S.core.erdos_renyi(50, 4.0, seed=11)
        server = S.server(g)
        assert server.graph is g
        reqs = _requests(S, g, S.core.DEFAULT_GRAPH_ID, 5,
                         np.random.default_rng(2))
        return reqs, *server.serve(reqs)

    (_, want, w_rep), (reqs, got, rep) = _both(backend, run)
    assert_responses(want, got)
    assert_report(w_rep, rep)
    seq = rc.PathEnum()
    gr = rc.erdos_renyi(50, 4.0, seed=11)
    for r, q in zip(got, reqs):
        assert r.graph_id == DEFAULT_GRAPH_ID
        assert r.count == seq.count(gr, q.s, q.t, q.k)
    assert set(rep.tenant_cache) == {DEFAULT_GRAPH_ID}


@pytest.mark.parametrize("backend", BACKENDS)
def test_tenants_with_same_stk_do_not_share_cache_entries(backend):
    def run(S):
        g_a, g_b = _two_tenants(S)
        server = S.server(_registry(S, a=g_a, b=g_b))
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=0, s=2, t=5, k=4, graph_id="a"),
                Q(uid=1, s=2, t=5, k=4, graph_id="b")]
        cold = server.serve(reqs)
        return cold, server.serve(reqs)

    (w_cold, w_warm), (cold, warm) = _both(backend, run)
    for (want, w_rep), (got, rep) in ((w_cold, cold), (w_warm, warm)):
        assert_responses(want, got)
        assert_report(w_rep, rep)
    assert {g: cache_dict(c) for g, c in cold[1].tenant_cache.items()} == {
        "a": {"hits": 0, "misses": 1, "evictions": 0},
        "b": {"hits": 0, "misses": 1, "evictions": 0}}
    assert warm[1].tenant_cache["a"].hits == warm[1].tenant_cache["b"].hits \
        == 1
    assert warm[1].cache.misses == 0
    seq = rc.PathEnum()
    assert cold[0][0].count == seq.count(rc.erdos_renyi(70, 4.0, seed=3),
                                         2, 5, 4)
    assert cold[0][1].count == seq.count(rc.power_law(90, 5.0, seed=8),
                                         2, 5, 4)


# ---------------------------------------------------------------------------
# async server: tenancy through admission + micro-batching
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_async_two_tenants_byte_identical_to_single_tenant_runs(backend):
    def run(S):
        g_a, g_b = _two_tenants(S)
        rng = np.random.default_rng(9)
        reqs_a = _requests(S, g_a, "a", 6, rng, count_only=False)
        reqs_b = _requests(S, g_b, "b", 6, rng, uid0=6, count_only=False)
        interleaved = [r for pair in zip(reqs_a, reqs_b) for r in pair]

        async def drive():
            async with S.async_server(_registry(S, a=g_a, b=g_b),
                                      batch_window_ms=2.0) as srv:
                return await srv.serve(interleaved), srv.drain_report()
        return interleaved, *asyncio.run(drive())

    (_, want, w_rep), (reqs, got, rep) = _both(backend, run)
    assert_responses(want, got)
    assert_report(w_rep, rep)
    seq = rc.PathEnum()
    graphs = {"a": rc.erdos_renyi(70, 4.0, seed=3),
              "b": rc.power_law(90, 5.0, seed=8)}
    for r, q in zip(got, reqs):
        want_paths = sorted(seq.query(graphs[q.graph_id], q.s, q.t,
                                      q.k).result.as_tuples())
        got_paths = sorted(tuple(int(x) for x in row if x != PAD)
                           for row in r.paths)
        assert got_paths == want_paths and r.count == len(want_paths)
    assert set(rep.tenant_cache) == {"a", "b"}
    assert rep.tenant_cache["a"].lookups > 0
    assert rep.tenant_cache["b"].lookups > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_unknown_graph_rejected_at_admission(backend):
    def run(S):
        g_a, _ = _two_tenants(S)

        async def drive():
            async with S.async_server(g_a) as srv:
                resp = await srv.submit(S.serving.PathQueryRequest(
                    uid=0, s=0, t=1, k=3, graph_id="ghost"))
                return [resp], srv.stats.rejected_unknown_graph
        return asyncio.run(drive())

    (want, w_n), (got, n) = _both(backend, run)
    assert_responses(want, got)
    assert got[0].status == STATUS_REJECTED_UNKNOWN_GRAPH and n == w_n == 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_per_tenant_quota_rejection(backend):
    def run(S):
        g_a, g_b = _two_tenants(S)
        reg = S.serving.GraphRegistry()
        reg.register("flooded", g_a, max_pending=1)
        reg.register("calm", g_b)
        Q = S.serving.PathQueryRequest
        flood = [Q(uid=i, s=0, t=1 + i, k=3, graph_id="flooded")
                 for i in range(4)]
        calm = [Q(uid=10 + i, s=0, t=1 + i, k=3, graph_id="calm")
                for i in range(3)]

        async def drive():
            async with S.async_server(reg, batch_window_ms=10.0) as srv:
                return await srv.serve(flood + calm), \
                    srv.stats.rejected_tenant_quota
        return asyncio.run(drive())

    (want, w_n), (got, n) = _both(backend, run)
    assert_responses(want, got)
    statuses = [r.status for r in got[:4]]
    assert statuses[0] == STATUS_OK
    assert statuses.count(STATUS_REJECTED_TENANT_QUOTA) == 3
    assert all(r.status == STATUS_OK for r in got[4:])
    assert n == w_n == 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_server_wide_tenant_quota_default(backend):
    def run(S):
        g_a, _ = _two_tenants(S)
        Q = S.serving.PathQueryRequest

        async def drive():
            async with S.async_server(g_a, batch_window_ms=10.0,
                                      max_pending_per_graph=2) as srv:
                return await srv.serve([Q(uid=i, s=0, t=1 + i, k=3)
                                        for i in range(5)])
        return asyncio.run(drive())

    want, got = _both(backend, run)
    assert_responses(want, got)
    statuses = [r.status for r in got]
    assert statuses.count(STATUS_OK) == 2
    assert statuses.count(STATUS_REJECTED_TENANT_QUOTA) == 3


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_tenant_retired_mid_flight_fails_soft(backend):
    def run(S):
        g_a, g_b = _two_tenants(S)
        reg = _registry(S, doomed=g_a, stable=g_b)
        Q = S.serving.PathQueryRequest

        async def drive():
            async with S.async_server(reg, batch_window_ms=30.0) as srv:
                doomed = asyncio.ensure_future(srv.submit(
                    Q(uid=0, s=0, t=1, k=3, graph_id="doomed")))
                await asyncio.sleep(0.005)
                reg.retire("doomed")
                stable = await srv.submit(
                    Q(uid=1, s=0, t=1, k=3, graph_id="stable"))
                return [await doomed, stable], srv.stats.rejected_mid_flight
        return asyncio.run(drive())

    (want, w_n), (got, n) = _both(backend, run)
    assert_responses(want, got)
    assert got[0].status == STATUS_REJECTED_UNKNOWN_GRAPH
    assert got[1].status == STATUS_OK
    assert n == w_n == 1
