#!/usr/bin/env python3
"""K1's kernels on one NVIDIA GPU against the chunk's rows and fan-out:
the card's time of each kernel a call, from ``torch.profiler``, for the
masks entry (``frontier_masks``: its counter memset and kernel) and the
hop entry (``frontier_hop``: its count and write launches), at
``--rows`` rows of one query with ``--max-deg`` candidates each (every
row full, all continued, depth 2, k = 8; the index arrays of
``wrapper_host_cost.frontier_inputs``), plus the same chunk with its
last two thirds PAD.  A tree without the hop entry times the masks
alone.

Each ``--src`` directory (the ``src`` of a checkout) is measured in a
process of its own.  Run from the root of a checkout on a machine with a
CUDA device: ``python3 tools/frontier_scaling.py --src src``.  Prints one
JSON object per tree and shape, in microseconds.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

TOOLS = Path(__file__).resolve().parent


def kernel_us(torch, fn, reps: int = 20) -> dict:
    """The card's microseconds a call of ``fn``, by kernel (or memset)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = "memset" if "Memset" in e.name else next(
                (k for k in ("masks", "count", "write") if k in e.name),
                e.name[:40])
            out[name] = out.get(name, 0.0) + e.device_time_total / reps
    return out


def measure(src: str, rows_list, max_degs) -> None:
    """Print one tree's times, in this process."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(TOOLS))
    from repro_torch.kernels import frontier_expand as fe
    from wrapper_host_cost import frontier_inputs

    dev = torch.device("cuda", 0)
    has_hop = hasattr(fe, "frontier_hop")
    for md in max_degs:
        for rows in rows_list:
            paths, _r, tv, _d, begins, ends, dsts = frontier_inputs(
                torch, np, dev, rows, 1, md, seed=1)
            full = torch.from_numpy(paths).to(dev)
            pad = full.clone()
            pad[rows // 3:] = -1
            meta = torch.tensor([2, int(tv[0])], dtype=torch.int32).to(dev)
            arrays = (begins[0], ends[0], dsts[0], meta)
            row = {"src": src, "rows": rows, "max_deg": md,
                   "slots": rows * md,
                   "masks": kernel_us(torch, lambda: fe.frontier_masks(
                       full, *arrays, max_deg=md)),
                   "masks_third_valid": kernel_us(
                       torch, lambda: fe.frontier_masks(pad, *arrays,
                                                        max_deg=md))}
            if has_hop:
                row["hop"] = kernel_us(torch, lambda: fe.frontier_hop(
                    full, *arrays, max_deg=md))
            row["device"] = torch.cuda.get_device_name(0)
            print(json.dumps(row), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a checkout's src directory; repeat to compare")
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[256, 2048, 8192, 16384, 65536])
    ap.add_argument("--max-deg", type=int, nargs="+", default=[4, 32])
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        measure(args.src[0], args.rows, args.max_deg)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("frontier_scaling: no CUDA device")
    for src in args.src:
        subprocess.run([sys.executable, __file__, "--one", "--src", src,
                        "--rows", *map(str, args.rows), "--max-deg",
                        *map(str, args.max_deg)], check=True)


if __name__ == "__main__":
    main()
