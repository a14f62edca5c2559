"""Streaming graphs + the metrics control plane, end to end (DESIGN.md §12).

    PYTHONPATH=src python -m repro_torch.examples.streaming_serving [--device cpu]

A fraud graph serves while its edge set changes underneath it; every
claim is asserted:

  * ``GraphRegistry.mutate`` streams edge inserts/deletes into a live
    tenant: ``Graph.with_edges`` returns a versioned copy, the version
    lands in every cache key, and the tenant's stale entries are purged
    from the bound engine; post-mutation answers equal a cold engine on
    the mutated graph;
  * ``register`` over a live id is the hot-swap path (v2 in, v1 entries
    out) for bulk rebuilds;
  * ``snapshot(server)`` captures the metrics control plane's read side
    (per-tenant cache counters, merged Fig.-6 enumeration totals,
    admission/SLO stats on the async front-end), exported as JSON and
    Prometheus text, with ``violations()`` re-checking every counter
    identity;
  * ``set_cache_quota`` / ``set_max_pending`` are its write side: live
    quota adjustment, no restart.

Siblings: ``multi_tenant_serving`` (the static tenancy story),
``async_serving`` (single-graph async + SLOs).
"""
from __future__ import annotations

import asyncio
import json

import numpy as np

from ..core import BatchPathEnum, erdos_renyi
from ..serving import (AsyncHcPEServer, GraphRegistry, HcPEServer,
                       PathQueryRequest, STATUS_OK,
                       STATUS_REJECTED_TENANT_QUOTA, snapshot)
from . import device_from


def requests(g, graph_id, count, rng, uid0=0, **kw):
    """``count`` k=4 requests between distinct random vertices."""
    out = []
    while len(out) < count:
        s, t = map(int, rng.choice(g.n, 2, replace=False))
        out.append(PathQueryRequest(uid=uid0 + len(out), s=s, t=t, k=4,
                                    graph_id=graph_id, **kw))
    return out


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns the values it printed."""
    dev = device_from(argv, __doc__)
    rng = np.random.default_rng(0)
    g_v0 = erdos_renyi(800, 5.0, seed=3)

    registry = GraphRegistry()
    registry.register("fraud", g_v0, cache_quota=32)
    server = HcPEServer(registry, device=dev)
    reqs = requests(g_v0, "fraud", 20, rng)

    # -- serve on v0, then stream a mutation in ----------------------------
    server.serve(reqs)
    resp0, _ = server.serve(reqs)                 # warm pass, all hits
    v0_cached = server.engine.cache.tenant_len("fraud")
    print(f"v0: {len(resp0)} responses, "
          f"{v0_cached} cached indexes")

    new_edges = np.array([[0, 1], [1, 0], [2, 700], [700, 2]])
    drop = g_v0.edge_list()[rng.choice(g_v0.m, 400, replace=False)]
    entry = registry.mutate("fraud", add=new_edges, remove=drop)
    print(f"mutate: fraud now version {entry.graph.version}, "
          f"m {g_v0.m} -> {entry.graph.m}, cache purged to "
          f"{server.engine.cache.tenant_len('fraud')} entries")
    assert entry.graph.version == 1
    assert server.engine.cache.tenant_len("fraud") == 0

    # post-mutation answers == a cold engine on the mutated graph: the
    # pre-mutation indexes are unreachable (version is in the cache key)
    resp1, _ = server.serve(reqs)
    cold = BatchPathEnum(device=dev).run(entry.graph,
                                         [(q.s, q.t, q.k) for q in reqs])
    assert [r.count for r in resp1] == cold.counts.tolist()
    changed = sum(1 for a, b in zip(resp0, resp1) if a.count != b.count)
    print(f"v1: counts match a cold engine; {changed}/{len(reqs)} "
          f"queries changed answers across the mutation")

    # -- hot-swap: a bulk rebuild replaces the graph wholesale --------------
    g_rebuilt = entry.graph.with_edges(add=np.array([[3, 4]]))
    registry.register("fraud", g_rebuilt, cache_quota=32)
    assert server.engine.cache.tenant_len("fraud") == 0
    swap_version = registry.entry("fraud").graph.version
    print(f"hot-swap: registered rebuild at version "
          f"{swap_version}, cache purged again")

    # -- metrics: the sync snapshot -----------------------------------------
    server.serve(reqs)
    snap = snapshot(server)
    assert snap.violations() == []
    tm = snap.tenants["fraud"]
    doc = json.loads(snap.to_json())
    assert doc["tenants"]["fraud"]["cache"]["hits"] == tm.cache.hits
    print(f"snapshot: fraud hit_rate={tm.cache.hit_rate:.2f} "
          f"entries={tm.cache_entries}/{tm.cache_quota} "
          f"enum_results={snap.enum_stats.results}, violations=[]")

    # -- live quota adjustment (the control plane's write path) -------------
    registry.set_cache_quota("fraud", 4)
    assert server.engine.cache.tenant_len("fraud") == 4
    print("set_cache_quota(4): cache shed to 4 entries live")

    # -- async front-end: admission stats + Prometheus export ---------------
    async def drive():
        async with AsyncHcPEServer(registry, batch_window_ms=1.0,
                                   device=dev) as asrv:
            registry.set_max_pending("fraud", 2)       # throttle live
            flood = requests(registry.get("fraud"), "fraud", 12, rng,
                             uid0=100, deadline_ms=500.0)
            resps = await asrv.serve(flood)
            return snapshot(asrv), resps

    asnap, resps = asyncio.run(drive())
    ok = sum(1 for r in resps if r.status == STATUS_OK)
    shed = sum(1 for r in resps if r.status == STATUS_REJECTED_TENANT_QUOTA)
    s = asnap.serve
    assert s.submitted == s.accepted + s.rejected_total == 12
    assert asnap.violations() == []
    print(f"async: {ok} served, {shed} shed by max_pending=2; "
          f"admission identity holds ({s.submitted} == {s.accepted} + "
          f"{s.rejected_total})")

    prom = asnap.to_prometheus()
    assert "pathenum_serve_submitted_total 12" in prom.splitlines()
    print(f"prometheus export: {len(prom.splitlines())} lines, e.g.")
    for line in prom.splitlines()[:4]:
        print(f"  {line}")
    print("OK")
    return {"v0": (len(resp0), v0_cached),
            "mutate": (entry.graph.version, g_v0.m, entry.graph.m),
            "changed": changed, "counts": [r.count for r in resp1],
            "hot_swap_version": swap_version,
            "snapshot": (tm.cache.hit_rate, tm.cache_entries,
                         tm.cache_quota, snap.enum_stats.results),
            "async": (ok, shed, s.submitted, s.accepted, s.rejected_total),
            "prometheus_lines": len(prom.splitlines()),
            "prometheus_head": prom.splitlines()[:4]}


if __name__ == "__main__":
    main()
