#!/usr/bin/env python3
"""Cost of K4, the min-plus BFS of the device walk-count DP, on one NVIDIA
GPU for one or more source trees of the PyTorch/CUDA port, so that two
commits are compared on one card in one call.

Each ``--src`` directory (the ``src`` of a checkout) is measured in a
process of its own, in the order given, on inputs shaped as
``chip_smoke.py``'s K4 lines: one relaxation ``minplus_spmv`` over a
random (2048, 2048) adjacency (0.3% edges, 16 sources), and the
planner's two bounded BFS over the dense adjacency of the index for
1104 -> 997 at k = 4 on ``power_law(2000, 6.0, seed=3)``:

* ``spmv_ms`` / ``spmv_device_ms``: one relaxation a call, as a caller
  sees it (CUDA events around back-to-back calls) and on the card alone
  (the calls queued behind ``torch.cuda._sleep``);
* ``bfs_ms`` / ``bfs_device_ms``: ``ops.bfs_dense`` from s;
* ``reverse_ms`` / ``reverse_device_ms``: the BFS from t over the
  transpose as ``core.estimator._bfs_levels`` runs it: on a tree whose
  ``bfs_dense`` takes ``transposed``, that read; otherwise the BFS over
  ``wadj.T.contiguous()``, copy included;
* ``levels_ms``: ``_bfs_levels`` as the planner calls it (both BFS, the
  clamps and the copies to the host), on the host clock, drained;
  ``levels_k4_launches``: K4's launches in one such call.

Run from the root of a checkout on a machine with a CUDA device:
``python3 tools/minplus_cost.py --src old/src --src src --src src --src
old/src``.  Prints one JSON object per tree, in milliseconds.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def events_ms(torch, fn, reps: int, sleep: bool) -> float:
    """Milliseconds a call over ``reps`` back-to-back calls, the median of
    three runs; with ``sleep`` the calls queue behind ``torch.cuda._sleep``
    so the events time the card alone."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        if sleep:
            torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        runs.append(start.elapsed_time(stop) / reps)
    return statistics.median(runs)


def measure(src: str, reps: int) -> dict:
    """One tree's costs, in this process."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch.core as tc
    from repro_torch.core import estimator as est
    from repro_torch.kernels import ops
    from repro_torch.kernels import semiring_spmm as sr

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    n, inf = 2048, 1e9
    adj = torch.from_numpy(np.where(rng.random((n, n)) < 0.003, 1.0, inf)
                           .astype(np.float32)).to(dev)
    dist = np.full(n, inf, np.float32)
    dist[rng.choice(n, 16, replace=False)] = rng.integers(0, 4, 16)
    d = torch.from_numpy(dist).to(dev)

    g = tc.power_law(2000, 6.0, seed=3)
    idx = tc.build_index(g, 1104, 997, 4, device=dev)
    wadj, _amat, winf = est._dense_adjacency(idx)
    k = idx.k
    takes_transposed = "transposed" in inspect.signature(
        ops.bfs_dense).parameters

    def reverse():
        if takes_transposed:
            return ops.bfs_dense(wadj, idx.t, k, inf=winf, transposed=True)
        return ops.bfs_dense(wadj.T.contiguous(), idx.t, k, inf=winf)

    def forward():
        return ops.bfs_dense(wadj, idx.s, k, inf=winf)

    def spmv():
        return sr.minplus_spmv(adj, d, inf=inf)

    def levels():
        return est._bfs_levels(idx, wadj, winf)

    levels()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        levels()
    levels_ms = (time.perf_counter() - t0) / reps * 1e3
    launches = sr.minplus_launches
    levels()
    launches = sr.minplus_launches - launches
    return {"src": src, "bfs_takes_transposed": takes_transposed,
            "shape": {"spmv_n": n, "bfs_n": int(wadj.shape[0]), "k": k},
            "spmv_ms": events_ms(torch, spmv, reps, False),
            "spmv_device_ms": events_ms(torch, spmv, 50, True),
            "bfs_ms": events_ms(torch, forward, reps, False),
            "bfs_device_ms": events_ms(torch, forward, 50, True),
            "reverse_ms": events_ms(torch, reverse, reps, False),
            "reverse_device_ms": events_ms(torch, reverse, 50, True),
            "levels_ms": levels_ms, "levels_k4_launches": launches,
            "device": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a checkout's src directory; repeat to compare")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.src[0], args.reps)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("minplus_cost: no CUDA device")
    for src in args.src:
        subprocess.run([sys.executable, __file__, "--one", "--src", src,
                        "--reps", str(args.reps)], check=True)


if __name__ == "__main__":
    main()
