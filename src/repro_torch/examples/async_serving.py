"""Async deadline-aware HcPE serving: tight-SLO queries jump the queue.

    PYTHONPATH=src python -m repro_torch.examples.async_serving [--device cpu]

A mixed workload, one heavy enumeration (k=8 on a dense region, ~10^6
paths) plus a swarm of light point lookups with tight deadlines, is
served twice:

  * through the blocking ``HcPEServer.serve`` (every response waits for
    the whole batch, heavy query included), then
  * through ``AsyncHcPEServer``: admission control, a micro-batching
    window, earliest-deadline-first dispatch, enumeration in a worker
    thread.  The tight-SLO lights are grouped, scheduled, and answered
    before the heavy query runs; result counts are identical.

``AsyncHcPEServer(g, ...)`` is the single-graph form (the graph wraps
into a one-tenant ``GraphRegistry``, DESIGN.md §8).  How many lights
meet their SLO, and in how many micro-batches they go, follows the wall
clock (``CLOCK_BOUND``).

Siblings: ``batch_serving`` (the sync HcPE batch front-end),
``multi_tenant_serving`` (many tenant graphs behind one server) and
``serve_batch`` (LM decode serving, unrelated to HcPE).
"""
from __future__ import annotations

import asyncio
import time

import numpy as np

from ..core import BatchPathEnum, erdos_renyi
from ..serving import AsyncHcPEServer, HcPEServer, PathQueryRequest
from . import device_from


def make_workload(g, rng):
    """One heavy k=8 request first, then 20 light k=3 requests with a
    50 ms deadline."""
    heavy = PathQueryRequest(uid=0, s=0, t=1, k=8, deadline_ms=60_000.0)
    lights = []
    while len(lights) < 20:
        s, t = rng.integers(0, g.n, 2)
        if s != t:
            lights.append(PathQueryRequest(uid=1 + len(lights), s=int(s),
                                           t=int(t), k=3, deadline_ms=50.0))
    return [heavy] + lights        # heavy first: worst case for FIFO


def pct(xs, q):
    """The q-th percentile of seconds ``xs``, in ms."""
    return float(np.percentile(np.asarray(xs) * 1e3, q))


async def run_async(g, workload, dev):
    """Each request's response and its seconds from the burst's start."""
    async with AsyncHcPEServer(g, BatchPathEnum(device=dev),
                               batch_window_ms=2.0) as server:
        t0 = time.perf_counter()

        async def timed(req):
            resp = await server.submit(req)
            return resp, time.perf_counter() - t0

        done = await asyncio.gather(*(timed(r) for r in workload))
        stats = server.stats
    return done, stats


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns the values it printed, times left out."""
    dev = device_from(argv, __doc__)
    g = erdos_renyi(200, 12.0, seed=3)
    workload = make_workload(g, np.random.default_rng(11))

    t0 = time.perf_counter()
    sync_resps, _ = HcPEServer(g, BatchPathEnum(device=dev)).serve(workload)
    sync_wall = time.perf_counter() - t0
    print(f"sync  HcPEServer.serve: every response after {sync_wall*1e3:8.1f} ms "
          f"(heavy query blocks all {len(workload) - 1} lights)")

    done, stats = asyncio.run(run_async(g, workload, dev))
    lights = [(r, dt) for r, dt in done if r.uid != 0]
    heavy_dt = next(dt for r, dt in done if r.uid == 0)
    light_dts = [dt for _, dt in lights]
    met = sum(1 for r, _ in lights if r.slo_met)
    rejected = stats.rejected_queue_full + stats.rejected_quota
    print(f"async AsyncHcPEServer:  light p50={pct(light_dts, 50):6.1f} ms  "
          f"p99={pct(light_dts, 99):6.1f} ms  heavy={heavy_dt*1e3:8.1f} ms")
    print(f"  SLO (50 ms) met on {met}/{len(lights)} lights; "
          f"{stats.micro_batches} micro-batches, "
          f"{rejected} rejected")

    sync_counts = {r.uid: r.count for r in sync_resps}
    async_counts = {r.uid: r.count for r, _ in done}
    assert async_counts == sync_counts
    print(f"  result counts identical to sync engine "
          f"({sum(sync_counts.values()):,} paths total)")
    return {"lights": len(lights), "slo_met": met,
            "micro_batches": stats.micro_batches, "rejected": rejected,
            "counts": sync_counts}


if __name__ == "__main__":
    main()
