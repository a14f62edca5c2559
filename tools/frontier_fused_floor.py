#!/usr/bin/env python3
"""K5 (``frontier_fused_masks``) on one NVIDIA GPU beside the device work
that any kernel with its outputs and gathers must do, at the shape of
``chip_smoke.py``'s largest fused dispatch.

K5's bound (``bound_ms`` of its ``kernel`` line) counts 4 bytes for each
gather, but the card reads device memory in 32-byte sectors and a row's
begin, end and dst entries sit in three scattered sectors.  This script
times, each on the card alone (the launches queued behind
``torch.cuda._sleep``):

* ``k5``: the kernel through ``frontier_fused_masks_table``, counters
  zeroed on the stream by its launch function;
* ``write_outputs``: one ``fill_`` of a buffer the size of K5's three
  (rows, max_deg) int32 outputs, the least a kernel that writes them
  takes;
* ``zero_counters``: one ``zero_`` of the (members, 4) counters, a stream
  operation like the launch function's ``cudaMemsetAsync``;
* ``gathers``: ``index_select`` of each valid row's begin, end and first
  dst entries from one member's index, three gathers of the same count
  as K5's.

Inputs are synthetic, made from a seed: ``--rows`` packed rows padded to
a power of two with PAD rows (``--real`` of them real), ``--members``
queries over 65,536 vertices, ``--max-deg`` candidate slots, k = 8.
Run from the root of a checkout on a machine with a CUDA device:
``python3 tools/frontier_fused_floor.py``.  Prints one JSON object of
milliseconds per call.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from counting_spmm_sweep import device_ms  # noqa: E402
from wrapper_host_cost import frontier_inputs  # noqa: E402


def main() -> None:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=131072)
    ap.add_argument("--real", type=int, default=75434)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--max-deg", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("frontier_fused_floor: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import frontier_expand as fe

    dev = torch.device("cuda", 0)
    rows, m, md = args.rows, args.members, args.max_deg
    paths, rank, tvec, depthv, begins, ends, dsts = frontier_inputs(
        torch, np, dev, args.real, m, md)
    k1 = paths.shape[1]
    padded = np.full((rows, k1), -1, np.int32)
    padded[:args.real] = paths
    rk = np.zeros(rows, np.int32)
    rk[:args.real] = rank
    p, r, tv, dv = (torch.from_numpy(x).to(dev)
                    for x in (padded, rk, tvec, depthv))
    table = torch.from_numpy(fe.fused_member_table(
        begins, ends, dsts, k1max=k1, device=dev)).to(dev)
    got = fe.frontier_fused_masks_table(p, r, tv, dv, table, max_deg=md)
    want = fe.frontier_fused_masks_plain(p, r, tv, dv, begins, ends, dsts,
                                         max_deg=md)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        sys.exit("frontier_fused_floor: K5 differs from its plain version")
    out = torch.empty(3 * rows * md, dtype=torch.int32, device=dev)
    counters = torch.empty((m, 4), dtype=torch.int32, device=dev)
    last = torch.from_numpy(paths[:, 2].astype(np.int64)).to(dev)
    begin, end, dst = begins[0], ends[0].view(-1), dsts[0]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "shape": {"rows": rows, "real_rows": args.real, "members": m,
                  "k1": k1, "max_deg": md},
        "k5": device_ms(torch, lambda: fe.frontier_fused_masks_table(
            p, r, tv, dv, table, max_deg=md)),
        "write_outputs": device_ms(torch, lambda: out.fill_(-1)),
        "zero_counters": device_ms(torch, counters.zero_),
        "gathers": device_ms(torch, lambda: (
            begin.index_select(0, last), end.index_select(0, last * k1),
            dst.index_select(0, last))),
    }), flush=True)


if __name__ == "__main__":
    main()
