"""Find the highest rate an open-loop cell's server sustains.

    python -m hcpe_bench.sweep --workload <cell> --seed <n> \
        --rates 50,100,200 --seconds 8

Sets the cell up once, as a run does, then offers each rate in turn for
``--seconds`` and prints one JSON line a rate: requests, answers ok,
the median and 95th-percentile due-to-answer milliseconds, how late the
generator sent (95th percentile), and ``backlog_s``, how long after the
arrival window the last answer came.  A rate the server sustains ends
with a backlog near one service time; past it the backlog grows with
the window.  The cell's rate is fixed from this once, in its
``workloads/<cell>.json``; runs of the benchmark never sweep.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

import numpy as np
import torch

from . import graphgen, loops, stats
from .harness import find_cell, port_modules, use_checkout_program


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    use_checkout_program()
    dev = torch.device("cuda", torch.cuda.current_device())
    cell = find_cell(args.workload)
    cfg, params = cell.config, dict(cell.traffic)
    mods = port_modules()
    mods["build"].build_all()
    k, n = int(cfg["query"]["k"]), graphgen.vertex_count(cfg["graph"])
    arrays, pool = graphgen.build(cfg, args.seed, dev)
    graph = mods["graph"].Graph.from_numpy(
        n, *(x.cpu().numpy() for x in (arrays.indptr, arrays.indices,
                                       arrays.rindptr, arrays.rindices,
                                       arrays.esrc, arrays.edst)))
    engine = mods["batch"].BatchPathEnum(device=dev, **cfg["engine"])
    serving = mods["serving"]
    req = serving.PathQueryRequest
    engine.run(graph, [(s, t, k) for s, t in pool],
               count_only=bool(params["count_only"]),
               first_n=params.get("first_n"))
    server = serving.AsyncHcPEServer(
        graph, engine=engine,
        batch_window_ms=float(params["batch_window_ms"]))

    async def drive():
        async with server:
            await server.serve([req(uid=i, s=s, t=t, k=k,
                                    count_only=bool(params["count_only"]),
                                    first_n=params.get("first_n"))
                                for i, (s, t) in enumerate(pool)])
            for i, rate in enumerate(float(x)
                                     for x in args.rates.split(",")):
                params["rate_per_s"] = rate
                before = server.stats.micro_batches
                rng = np.random.default_rng([args.seed, 2, i])
                records, t0, t1 = await loops.open_loop(
                    server, req, pool, k, params, rng, args.seconds)
                late = [(r.sent - r.due) * 1e3 for r in records]
                print(json.dumps({
                    "rate_per_s": rate, "requests": len(records),
                    "ok": sum(r.ok for r in records),
                    "p50_ms": stats.latency_percentile(records, 50),
                    "p95_ms": stats.latency_percentile(records, 95),
                    "send_late_p95_ms": stats.percentile(late, 95),
                    "backlog_s": t1 - t0 - args.seconds,
                    "micro_batches": server.stats.micro_batches - before}),
                    flush=True)
    t = time.perf_counter()
    asyncio.run(drive())
    print(json.dumps({"sweep_s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
