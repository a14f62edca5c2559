"""Multi-graph tenancy: one server, many tenant graphs (DESIGN.md §8).

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving [--device cpu]

Two tenants, "acme" (a hub-heavy fraud graph with a tight cache quota)
and "globex" (a sparser social graph), register with one
``GraphRegistry`` and serve through one ``HcPEServer`` and one shared
engine:

  * interleaved per-tenant requests grouped into per-graph engine
    batches, counts byte-identical to dedicated single-tenant engines;
  * the same (s, t, k) queried on both graphs building two separate
    cache entries (no cross-tenant index reuse);
  * per-tenant cache stats in the serve report, quota-bounded churn, and
    retirement purging a tenant's cache slice;
  * the async front-end rejecting a flooding tenant with
    ``STATUS_REJECTED_TENANT_QUOTA`` while its neighbour is unaffected.

Siblings: ``batch_serving`` (single-graph sync), ``async_serving``
(single-graph async + SLOs), ``serve_batch`` (LM decode serving).
"""
from __future__ import annotations

import asyncio

import numpy as np

from ..core import PathEnum, erdos_renyi, power_law
from ..serving import (AsyncHcPEServer, GraphRegistry, HcPEServer,
                       PathQueryRequest, STATUS_REJECTED_TENANT_QUOTA)
from . import device_from


def hot_requests(g, graph_id, count, rng, k=4, uid0=0):
    """``count`` requests over 8 hot pairs of ``g``'s 30 top hubs."""
    deg = np.diff(g.indptr)
    hubs = np.argsort(deg)[-30:]
    pool = []
    while len(pool) < 8:
        s, t = rng.choice(hubs, 2, replace=False)
        if (int(s), int(t)) not in pool:
            pool.append((int(s), int(t)))
    picks = rng.integers(0, len(pool), size=count)
    return [PathQueryRequest(uid=uid0 + i, s=pool[j][0], t=pool[j][1], k=k,
                             graph_id=graph_id)
            for i, j in enumerate(picks)]


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns the values it printed, times left out."""
    dev = device_from(argv, __doc__)
    rng = np.random.default_rng(0)
    g_acme = power_law(1500, 6.0, seed=3)      # fraud rings: hub-heavy
    g_globex = erdos_renyi(1200, 4.0, seed=7)  # social: uniform sparse

    registry = GraphRegistry()
    registry.register("acme", g_acme, cache_quota=16)
    registry.register("globex", g_globex)
    server = HcPEServer(registry, device=dev)

    acme = hot_requests(g_acme, "acme", 25, rng)
    globex = hot_requests(g_globex, "globex", 25, rng, uid0=25)
    interleaved = [r for pair in zip(acme, globex) for r in pair]
    responses, report = server.serve(interleaved)
    print(f"one server, two tenants: {report.batch_size} queries, "
          f"{report.throughput_qps:,.0f} q/s")
    tenants = {}
    for gid in ("acme", "globex"):
        c = report.tenant_cache[gid]
        resident = server.engine.cache.tenant_len(gid)
        tenants[gid] = (c.hits, c.misses, c.hit_rate, resident)
        print(f"  {gid:7s} cache: {c.hits} hits / {c.misses} misses "
              f"(hit rate {c.hit_rate:.0%}), "
              f"{resident} entries resident")

    # byte-identical to dedicated single-tenant engines
    seq = PathEnum(device=dev)
    graphs = {"acme": g_acme, "globex": g_globex}
    for r in responses:
        req = interleaved[[q.uid for q in interleaved].index(r.uid)]
        assert r.count == seq.count(graphs[req.graph_id], req.s, req.t, req.k)
    print("per-tenant counts match dedicated engines: OK")

    # same (s, t, k) on both tenants -> two cache entries, two answers
    # (hub s by out-degree, hub t by in-degree; ids valid on both graphs)
    n_shared = g_globex.n
    s = int(np.argsort(np.diff(g_acme.indptr)[:n_shared])[-1])
    t = int(np.argsort(np.diff(g_acme.rindptr)[:n_shared])[-3])
    twin = [PathQueryRequest(uid=100, s=s, t=t, k=4, graph_id="acme"),
            PathQueryRequest(uid=101, s=s, t=t, k=4, graph_id="globex")]
    (ra, rg), rep = server.serve(twin)
    print(f"same ({s}, {t}, 4) on both tenants: acme={ra.count} "
          f"globex={rg.count} (misses={rep.cache.misses} — no sharing)")

    # retiring a tenant purges its cache slice; queries start rejecting
    registry.retire("acme")
    (late,), _ = server.serve([twin[0]])
    retired_entries = server.engine.cache.tenant_len("acme")
    print(f"after retire('acme'): cache entries="
          f"{retired_entries}, "
          f"late request -> {late.status}")

    # async: a flooding tenant is shed by its in-flight quota
    reg2 = GraphRegistry()
    reg2.register("flooder", g_acme, max_pending=2)
    reg2.register("steady", g_globex)

    async def drive():
        async with AsyncHcPEServer(reg2, batch_window_ms=10.0,
                                   device=dev) as srv:
            flood = [PathQueryRequest(uid=i, s=0, t=1 + i, k=3,
                                      graph_id="flooder") for i in range(6)]
            steady = [PathQueryRequest(uid=10 + i, s=0, t=1 + i, k=3,
                                       graph_id="steady") for i in range(3)]
            return await srv.serve(flood + steady), srv.stats

    resps, stats = asyncio.run(drive())
    shed = sum(r.status == STATUS_REJECTED_TENANT_QUOTA for r in resps)
    ok_steady = sum(r.status == "ok" for r in resps if r.graph_id == "steady")
    print(f"async quota: flooder shed {shed}/6, steady served "
          f"{ok_steady}/3 ({stats.rejected_tenant_quota} tenant-quota "
          f"rejections)")
    return {"batch_size": report.batch_size, "tenants": tenants,
            "counts": [r.count for r in responses],
            "twin": ((s, t), ra.count, rg.count, rep.cache.misses),
            "retired": (retired_entries, late.status),
            "async": (shed, ok_steady, stats.rejected_tenant_quota,
                      [(r.uid, r.status, r.count) for r in resps])}


if __name__ == "__main__":
    main()
