#!/usr/bin/env python3
"""Cost of the frontier kernels' dispatches on one NVIDIA GPU, for one or
more source trees of the PyTorch/CUDA port, so that two commits are
compared on one card in one call: ``ops.frontier_expand_fused`` (the fused
driver's call that launches K5), the single-query hop as the solo
host-looped driver pays it, and K1's wrapper ``frontier_masks``.

Each ``--src`` directory (the ``src`` of a checkout) is measured in a
process of its own, in the order given, at ``--rows`` packed rows of
``--members`` queries with ``--max-deg`` candidate slots and k = 8 (the
defaults: the real rows, members and fan-out of the largest dispatch of
``chip_smoke.py``'s fused leg) on the index arrays that
``wrapper_host_cost.frontier_inputs`` makes from its seed:

* ``host_us``: host time per call, the calls queued back to back;
* ``dispatch_us``: time per call with the card drained after each, as the
  fused driver pays a dispatch (it reads the counts back before the next);
* ``device_busy_us``: the card's busy time per call (kernels, copies and
  memsets) under ``torch.profiler``, and ``device_ops`` per call;
* ``hop_*``: one single-query hop at ``--hop-rows`` rows with
  ``--hop-max-deg`` candidates each, all continued (the defaults: near
  the largest hop of ``chip_smoke.py``'s ``first_n`` leg), as
  ``core.enumerate._device_step`` pays it: the chunk to the card, the
  hop, the counters and row counts back, then the rows.  Where the tree
  has ``ops.frontier_expand_readback`` that is the call; otherwise
  ``ops.frontier_expand`` followed by the reads the older driver made
  (a ``torch.cat`` of the counts with ``tolist``, then ``.cpu()`` of each
  block of rows).  ``hop_host_us``, ``hop_drained_us`` (it ends in host
  reads, so each call drains the card), ``hop_device_busy_us`` and
  ``hop_device_ops`` as above;
* ``k1_device_us``: K1's time on the card a call (the calls queued behind
  ``torch.cuda._sleep``, CUDA events around them) at ``--k1-rows`` rows
  of one query with ``--k1-max-deg`` slots (the defaults: the shape of
  ``chip_smoke.py``'s K1 line), and ``k1_host_us``, its host time a call.

Where the tree's fused expand takes ``member_table``, each member's row is
built once outside the timing and the rows are stacked in every call, as
the fused driver does.

Run from the root of a checkout on a machine with a CUDA device:
``python3 tools/frontier_dispatch_cost.py --src old/src --src src --src src
--src old/src``.  Prints one JSON object per tree, in microseconds.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

TOOLS = Path(__file__).resolve().parent


def profile_ops(torch, fn, reps: int):
    """Device operations and the card's busy microseconds per call of
    ``fn`` under ``torch.profiler`` (None when it sees no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in evs) / reps if evs else None
    return len(evs) / reps, busy


def measure(src: str, rows: int, members: int, max_deg: int,
            k1_rows: int, k1_max_deg: int, hop_rows: int, hop_max_deg: int,
            reps: int) -> dict:
    """One tree's costs, in this process."""
    import numpy as np
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(TOOLS))
    from repro_torch.kernels import frontier_expand as fe
    from repro_torch.kernels import ops
    from wrapper_host_cost import frontier_inputs

    dev = torch.device("cuda", 0)
    paths, rank, tvec, depthv, begins, ends, dsts = frontier_inputs(
        torch, np, dev, rows, members, max_deg)
    wantc = np.ones(members, bool)
    kw = {"max_deg": max_deg}
    takes_table = "member_table" in inspect.signature(
        ops.frontier_expand_fused).parameters
    if takes_table:
        k1 = paths.shape[1]
        table_rows = [fe.fused_member_table([b], [e], [d], k1max=k1,
                                            device=dev)[0]
                      for b, e, d in zip(begins, ends, dsts)]

    def call():
        if takes_table:
            kw["member_table"] = np.stack(table_rows)
        return ops.frontier_expand_fused(paths, rank, tvec, depthv, begins,
                                         ends, dsts, wantc, **kw)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
        torch.cuda.synchronize()
    drained = time.perf_counter() - t0
    n_ops, busy_us = profile_ops(torch, call, reps)

    # the single-query hop, as the solo host-looped driver pays it
    hp, _r, ht, _d, hb, he, hd = frontier_inputs(torch, np, dev, hop_rows, 1,
                                                 hop_max_deg, seed=2)
    hkw = dict(depth=2, t=int(ht[0]), max_deg=hop_max_deg, want_cont=True)
    readback = hasattr(ops, "frontier_expand_readback")

    def hop():
        if readback:
            return ops.frontier_expand_readback(hp, hb[0], he[0], hd[0],
                                                **hkw)
        e, c, ne, nc, ctr = ops.frontier_expand(hp, hb[0], he[0], hd[0],
                                                **hkw)
        out = torch.cat([ctr.long(), ne.view(1), nc.view(1)]).tolist()
        return (e[:out[4]].cpu().numpy() if out[4] else None,
                c[:out[5]].cpu().numpy() if out[5] else None, out[:3])
    for _ in range(10):
        hop()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        hop()
    hop_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(reps):
        hop()
        torch.cuda.synchronize()
    hop_drained = time.perf_counter() - t0
    hop_ops, hop_busy = profile_ops(torch, hop, reps)

    kp, _r, kt, _d, kb, ke, kd = frontier_inputs(torch, np, dev, k1_rows, 1,
                                                 k1_max_deg, seed=1)
    kp = torch.from_numpy(kp).to(dev)
    meta = torch.tensor([2, int(kt[0])], dtype=torch.int32).to(dev)

    def k1():
        return fe.frontier_masks(kp, kb[0], ke[0], kd[0], meta,
                                 max_deg=k1_max_deg)
    for _ in range(20):
        k1()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        k1()
    k1_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    # 50 calls queue in well under the ~10 ms the card sleeps
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(50):
        k1()
    stop.record()
    stop.synchronize()
    return {"src": src, "takes_member_table": takes_table,
            "shape": {"rows": rows, "members": members,
                      "k1": int(paths.shape[1]), "max_deg": max_deg},
            "reps": reps,
            "host_us": host / reps * 1e6,
            "dispatch_us": drained / reps * 1e6,
            "device_busy_us": busy_us,
            "device_ops": n_ops,
            "hop_readback_entry": readback,
            "hop_shape": {"rows": hop_rows, "k1": int(hp.shape[1]),
                          "max_deg": hop_max_deg},
            "hop_host_us": hop_host / reps * 1e6,
            "hop_drained_us": hop_drained / reps * 1e6,
            "hop_device_busy_us": hop_busy,
            "hop_device_ops": hop_ops,
            "k1_shape": {"rows": k1_rows, "k1": int(kp.shape[1]),
                         "max_deg": k1_max_deg},
            "k1_host_us": k1_host / reps * 1e6,
            "k1_device_us": start.elapsed_time(stop) / 50 * 1e3,
            "device": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", required=True,
                    help="a checkout's src directory; repeat to compare")
    ap.add_argument("--rows", type=int, default=75434)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--max-deg", type=int, default=4)
    ap.add_argument("--k1-rows", type=int, default=16384)
    ap.add_argument("--k1-max-deg", type=int, default=32)
    ap.add_argument("--hop-rows", type=int, default=2048)
    ap.add_argument("--hop-max-deg", type=int, default=16)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.src[0], args.rows, args.members,
                                 args.max_deg, args.k1_rows,
                                 args.k1_max_deg, args.hop_rows,
                                 args.hop_max_deg, args.reps)), flush=True)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("frontier_dispatch_cost: no CUDA device")
    for src in args.src:
        subprocess.run(
            [sys.executable, __file__, "--one", "--src", src, "--rows",
             str(args.rows), "--members", str(args.members), "--max-deg",
             str(args.max_deg), "--k1-rows", str(args.k1_rows),
             "--k1-max-deg", str(args.k1_max_deg), "--hop-rows",
             str(args.hop_rows), "--hop-max-deg", str(args.hop_max_deg),
             "--reps", str(args.reps)], check=True)


if __name__ == "__main__":
    main()
