"""Batch **HcPE** serving: dedup + warm index cache, sync front-end.

    PYTHONPATH=src python -m repro_torch.examples.batch_serving [--device cpu]

Builds a hub-heavy graph, simulates a production query log (many
requests hitting a small set of hot s-t pairs), serves it twice through
``HcPEServer`` and prints the serving report: throughput, latency
percentiles, and the index-cache reuse that makes the second batch
cheap.  ``HcPEServer(g)`` is the single-graph form: the bare graph wraps
into a one-tenant ``GraphRegistry`` (DESIGN.md §8).

Siblings: ``serve_batch`` (LM decode serving, no path queries),
``async_serving`` (the async HcPE front-end over the same engine) and
``multi_tenant_serving`` (many tenant graphs behind one server).
"""
from __future__ import annotations

import numpy as np

from ..core import BatchPathEnum, PathEnum, power_law
from ..serving import HcPEServer, PathQueryRequest
from . import device_from


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns the values it printed, times left out."""
    dev = device_from(argv, __doc__)
    g = power_law(2000, 6.0, seed=3)
    k = 4

    # hot query pool: high-degree endpoints (the paper's V' sets, §7.1)
    deg = np.diff(g.indptr)
    hubs = np.argsort(deg)[-40:]
    rng = np.random.default_rng(0)
    pool = []
    while len(pool) < 10:
        s, t = rng.choice(hubs, 2, replace=False)
        if (int(s), int(t)) not in pool:
            pool.append((int(s), int(t)))

    # a 50-request batch over 10 hot pairs -> 80% duplicates
    requests = [PathQueryRequest(uid=i, s=pool[j][0], t=pool[j][1], k=k)
                for i, j in enumerate(rng.integers(0, len(pool), size=50))]

    server = HcPEServer(g, BatchPathEnum(device=dev))
    responses, report = server.serve(requests)
    print(f"cold batch: {report.batch_size} queries "
          f"({report.distinct_queries} distinct), "
          f"{report.total_results} paths, "
          f"{report.throughput_qps:,.0f} q/s")
    print(f"  latency p50={report.p50_ms:.3f}ms p90={report.p90_ms:.3f}ms "
          f"p99={report.p99_ms:.3f}ms")
    print(f"  index cache: {report.cache.hits} hits / "
          f"{report.cache.misses} misses (hit rate "
          f"{report.cache.hit_rate:.0%})")

    # same workload again: every index now comes out of the warm LRU
    _, report2 = server.serve(requests)
    print(f"warm batch: {report2.throughput_qps:,.0f} q/s, "
          f"hit rate {report2.cache.hit_rate:.0%}")

    # counts must be byte-identical to the sequential engine
    seq = PathEnum(device=dev)
    for r in responses:
        req = requests[r.uid]
        assert r.count == seq.count(g, req.s, req.t, req.k)
    print(f"sequential cross-check: OK ({len(responses)} responses)")
    return {"batch_size": report.batch_size,
            "distinct": report.distinct_queries,
            "total_results": report.total_results,
            "cold_cache": (report.cache.hits, report.cache.misses),
            "warm_hit_rate": report2.cache.hit_rate,
            "counts": [r.count for r in responses]}


if __name__ == "__main__":
    main()
