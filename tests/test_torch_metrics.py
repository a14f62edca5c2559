"""The port's metrics control plane against ``repro``'s.

Mirrors tests/test_metrics.py (DESIGN.md §12): a ``MetricsSnapshot``
bit-matches the live counters it copies and stays a value copy; its JSON
and Prometheus exports carry the same numbers; ``violations()`` is empty
on a healthy stack (a fuzzed async leg drives mixed accept / reject /
deadline traffic) and catches a broken identity.  Every scenario runs on
``repro``'s front-ends (host backend) and on the port's on the CPU under
both port backends, and the snapshots are held equal with their time
fields masked (tests/torch_serving_parity.py).  The fuzzed leg's
deadlines are none, 0 ms (always missed) and a minute or two (always
met), so its SLO counters do not depend on the host's speed.
"""
import asyncio
import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_serving_parity import (BACKENDS, assert_snapshot, masked, side,
                                  sides)

from repro_torch.core.batch import CacheStats
from repro_torch.core.enumerate import EnumStats
from repro_torch.serving import MetricsSnapshot, STATUS_OK, snapshot


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


def _requests(S, g, count, rng, graph_id, uid0=0, dup_every=3, **kw):
    reqs = []
    while len(reqs) < count:
        s, t = map(int, rng.choice(g.n, 2, replace=False))
        if reqs and len(reqs) % dup_every == 0:
            s, t = reqs[0].s, reqs[0].t
        reqs.append(S.serving.PathQueryRequest(
            uid=uid0 + len(reqs), s=s, t=t, k=int(rng.integers(2, 5)),
            graph_id=graph_id, **kw))
    return reqs


def _two_tenant_server(S):
    rng = np.random.default_rng(0)
    reg = S.serving.GraphRegistry()
    reg.register("a", S.core.erdos_renyi(40, 3.0, seed=1), cache_quota=8)
    reg.register("b", S.core.erdos_renyi(50, 4.0, seed=2))
    srv = S.server(reg)
    for gid in ("a", "b"):
        g = reg.get(gid)
        srv.serve(_requests(S, g, 9, rng, gid))
        srv.serve(_requests(S, g, 9, rng, gid))
    return srv


# ---------------------------------------------------------------------------
# exactness: the snapshot is the ground truth, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_sync_snapshot_bit_matches_engine_counters(backend):
    want_srv, srv = _both(backend, _two_tenant_server)
    want = want_srv.metrics_snapshot()
    snap = snapshot(srv)
    assert_snapshot(want, snap)
    cache = srv.engine.cache
    assert snap.serve is None and snap.queue_depth == 0
    assert dataclasses.asdict(snap.cache) == dataclasses.asdict(cache.stats)
    assert (snap.cache_entries, snap.cache_capacity) == (len(cache),
                                                         cache.capacity)
    assert dataclasses.asdict(snap.enum_stats) == \
        dataclasses.asdict(srv.enum_totals)
    assert set(snap.tenants) == {"a", "b"}
    for gid in ("a", "b"):
        tm = snap.tenants[gid]
        entry = srv.registry.entry(gid)
        assert tm.registered
        assert dataclasses.asdict(tm.cache) == \
            dataclasses.asdict(cache.stats_for(gid))
        assert tm.cache_entries == cache.tenant_len(gid)
        assert tm.cache_quota == entry.cache_quota
        assert (tm.graph_version, tm.vertices, tm.edges) == \
            (entry.graph.version, entry.graph.n, entry.graph.m)
    assert snap.violations() == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_snapshot_is_a_value_copy_not_a_view(backend):
    def run(S):
        srv = _two_tenant_server(S)
        snap = S.serving.snapshot(srv)
        frozen = snap.to_dict()
        srv.registry.register("c", S.core.erdos_renyi(30, 3.0, seed=3))
        srv.serve(_requests(S, srv.registry.get("c"), 6,
                            np.random.default_rng(9), "c"))
        assert snap.to_dict() == frozen and "c" not in snap.tenants
        return snap, srv.metrics_snapshot()

    (w_snap, w_later), (snap, later) = _both(backend, run)
    assert_snapshot(w_snap, snap)
    assert_snapshot(w_later, later)
    assert "c" in later.tenants and later.cache.misses > snap.cache.misses


@pytest.mark.parametrize("backend", BACKENDS)
def test_enum_totals_accumulate_across_serves(backend):
    def run(S):
        rng = np.random.default_rng(4)
        g = S.core.erdos_renyi(40, 3.0, seed=5)
        srv = S.server(g)
        want = EnumStats()
        for uid0 in (0, 100):
            reqs = _requests(S, g, 7, rng, "default", uid0=uid0,
                             count_only=False)
            srv.serve(reqs)
            ref = S.engine().run(g, [(q.s, q.t, q.k) for q in reqs],
                                 count_only=False)
            want.merge(ref.enum_stats)
        return srv.metrics_snapshot(), dataclasses.asdict(want)

    (w_snap, _), (snap, want) = _both(backend, run)
    assert_snapshot(w_snap, snap)
    assert dataclasses.asdict(snap.enum_stats) == want
    assert snap.enum_stats.results > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_retired_tenant_survives_as_unregistered_stats(backend):
    def run(S):
        srv = _two_tenant_server(S)
        misses = srv.engine.cache.stats_for("a").misses
        srv.registry.retire("a")
        return srv.metrics_snapshot(), misses

    (want, w_misses), (snap, misses) = _both(backend, run)
    assert_snapshot(want, snap)
    tm = snap.tenants["a"]
    assert not tm.registered and tm.graph_version == -1
    assert tm.cache_entries == 0 and tm.cache.misses == misses == w_misses
    assert snap.violations() == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_snapshot_bit_matches_server_stats(backend):
    def run(S):
        rng = np.random.default_rng(6)
        reg = S.serving.GraphRegistry()
        g = S.core.erdos_renyi(50, 3.0, seed=7)
        reg.register("live", g)

        async def drive():
            async with S.async_server(reg, batch_window_ms=1.0) as srv:
                reqs = _requests(S, g, 10, rng, "live",
                                 deadline_ms=60_000.0)
                reqs.append(S.serving.PathQueryRequest(
                    uid=99, s=0, t=1, k=3, graph_id="ghost"))
                resps = await srv.serve(reqs)
                return srv, srv.metrics_snapshot(), resps
        return asyncio.run(drive())

    (_, want, _), (srv, snap, resps) = _both(backend, run)
    assert_snapshot(want, snap)
    assert dataclasses.asdict(snap.serve) == dataclasses.asdict(srv.stats)
    assert snap.serve.submitted == 11
    assert snap.serve.rejected_unknown_graph == 1
    assert snap.serve.completed == sum(r.status == STATUS_OK for r in resps)
    assert snap.queue_depth == 0 and snap.violations() == []
    assert dataclasses.asdict(snap.enum_stats) == \
        dataclasses.asdict(srv.enum_totals)


# ---------------------------------------------------------------------------
# export formats
# ---------------------------------------------------------------------------

def _time_free_lines(text):
    return [ln for ln in text.splitlines() if "_ms_total" not in ln]


@pytest.mark.parametrize("backend", BACKENDS)
def test_json_export_round_trips_to_dict(backend):
    want_srv, srv = _both(backend, _two_tenant_server)
    snap = snapshot(srv)
    doc = json.loads(snap.to_json())
    assert doc == json.loads(json.dumps(snap.to_dict()))
    assert json.loads(snap.to_json(indent=2)) == doc
    assert doc["cache"]["hits"] == srv.engine.cache.stats.hits
    assert doc["tenants"]["a"]["cache"]["hits"] == \
        srv.engine.cache.stats_for("a").hits
    want_doc = json.loads(want_srv.metrics_snapshot().to_json())
    want_doc.pop("captured_at"), doc.pop("captured_at")
    assert doc == want_doc


@pytest.mark.parametrize("backend", BACKENDS)
def test_prometheus_export_shape_and_values(backend):
    want_srv, srv = _both(backend, _two_tenant_server)
    snap = snapshot(srv)
    text = snap.to_prometheus()
    assert text == want_srv.metrics_snapshot().to_prometheus()
    assert text.endswith("\n")
    lines = text.splitlines()
    headers = [ln for ln in lines if ln.startswith("# TYPE")]
    assert len(headers) == len(set(headers))
    assert f"pathenum_cache_hits_total {snap.cache.hits}" in lines
    for gid in ("a", "b"):
        assert (f'pathenum_tenant_cache_hits_total{{graph_id="{gid}"}} '
                f"{snap.tenants[gid].cache.hits}") in lines
    assert not any('pathenum_tenant_cache_quota{graph_id="b"}' in ln
                   for ln in lines)
    assert 'pathenum_tenant_cache_quota{graph_id="a"} 8' in lines
    assert not any("pathenum_serve_" in ln for ln in lines)


def test_prometheus_label_escaping():
    snap = MetricsSnapshot(captured_at=0.0, cache=CacheStats(),
                           cache_entries=0, cache_capacity=0,
                           enum_stats=EnumStats(), tenants={})
    lines = []
    snap._sample(lines, "m", "gauge", 1, 'we"ird\\id\n')
    assert lines == ["# TYPE m gauge", 'm{graph_id="we\\"ird\\\\id\\n"} 1']


# ---------------------------------------------------------------------------
# invariants: violations() is empty on healthy stacks, loud on broken ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_violations_catch_injected_tenant_drift(backend):
    snap = snapshot(_two_tenant_server(side("port", backend)))
    assert snap.violations() == []
    snap.tenants["a"].cache.hits += 1
    bad = snap.violations()
    assert len(bad) == 1 and "hits" in bad[0]
    snap.tenants["a"].cache.hits -= 1
    snap.cache_entries += 1
    assert any("entries" in v for v in snap.violations())


@pytest.mark.parametrize("backend", BACKENDS)
def test_violations_catch_broken_admission_identity(backend):
    def run(S):
        rng = np.random.default_rng(8)
        g = S.core.erdos_renyi(30, 3.0, seed=8)

        async def drive():
            async with S.async_server(g, batch_window_ms=0.0) as srv:
                await srv.serve(_requests(S, g, 5, rng, "default"))
                return srv.metrics_snapshot()
        return asyncio.run(drive())

    want, snap = _both(backend, run)
    assert_snapshot(want, snap)
    assert snap.violations() == []
    snap.serve.accepted -= 1
    assert any("admission" in v or "settlement" in v
               for v in snap.violations())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("backend", BACKENDS)
def test_fuzzed_async_traffic_keeps_counter_identities(backend, seed):
    """Mixed traffic (duplicates, unknown tenants, per-tenant and queue
    quotas, deadlines none / 0 ms / a minute / two minutes): the
    admission and settlement identities hold, the SLO counters agree with
    the responses, and the port's snapshot equals repro's, times masked."""
    def run(S):
        rng = np.random.default_rng(100 + seed)
        reg = S.serving.GraphRegistry()
        graphs = {"a": S.core.erdos_renyi(30, 3.0, seed=seed),
                  "b": S.core.erdos_renyi(45, 4.0, seed=seed + 50)}
        reg.register("a", graphs["a"], cache_quota=3, max_pending=2)
        reg.register("b", graphs["b"])
        gids = ["a", "b", "ghost"]
        reqs = []
        for uid in range(int(rng.integers(20, 40))):
            gid = gids[int(rng.integers(0, 3))]
            g = graphs.get(gid, graphs["a"])
            s, t = map(int, rng.choice(g.n, 2, replace=False))
            dl = [None, 0.0, 60_000.0, 120_000.0][int(rng.integers(0, 4))]
            reqs.append(S.serving.PathQueryRequest(
                uid=uid, s=s, t=t, k=int(rng.integers(2, 5)), graph_id=gid,
                deadline_ms=dl))

        async def drive():
            async with S.async_server(
                    reg, batch_window_ms=float(rng.choice([0.0, 1.0])),
                    max_queue_depth=8) as srv:
                resps = await srv.serve(reqs)
                return srv.metrics_snapshot(), resps
        return (reqs, *asyncio.run(drive()))

    (_, want, w_resps), (reqs, snap, resps) = _both(backend, run)
    assert_snapshot(want, snap)
    assert [(r.status, r.count, r.slo_met) for r in resps] == \
        [(r.status, r.count, r.slo_met) for r in w_resps]
    s = snap.serve
    assert s.submitted == len(reqs) == s.accepted + s.rejected_total
    assert s.accepted == s.completed + s.rejected_mid_flight + s.cancelled \
        + s.failed
    assert s.failed == 0 and s.cancelled == 0
    assert s.completed == sum(r.status == STATUS_OK for r in resps)
    assert s.slo_met == sum(r.slo_met is True for r in resps)
    assert s.slo_missed == sum(r.slo_met is False for r in resps)
    assert snap.violations() == []
    json.loads(snap.to_json())
    assert _time_free_lines(snap.to_prometheus()) == \
        _time_free_lines(want.to_prometheus())


# ---------------------------------------------------------------------------
# server-side conveniences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_metrics_snapshot_methods_match_free_function(backend):
    S = side("port", backend)
    srv = _two_tenant_server(S)
    assert masked(srv.metrics_snapshot()) == masked(snapshot(srv))

    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=1)

        async def drive():
            async with S.async_server(g, batch_window_ms=0.0) as asrv:
                await asrv.serve(_requests(S, g, 3, np.random.default_rng(1),
                                           "default"))
                return asrv.metrics_snapshot(), S.serving.snapshot(asrv)
        return asyncio.run(drive())

    (want, _), (a, b) = _both(backend, run)
    assert masked(a) == masked(b)
    assert_snapshot(want, a)
    assert a.serve is not None and a.violations() == []
