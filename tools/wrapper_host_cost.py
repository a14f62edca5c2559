#!/usr/bin/env python3
"""Host time per call of a kernel wrapper of the PyTorch/CUDA port, and of
the pieces it is made of, on one NVIDIA GPU.

A wrapper's call returns before the card finishes, so when the card's
work is a few microseconds the caller waits on the host: argument checks,
the outputs' allocation, copies to the card, the stream lookup and the
ctypes launch.  This script times each piece apart, with the host clock
over many calls (no synchronisation inside the loop), for three
wrappers:

* K3, ``counting_spmm``, at the walk-count DP's shape: a (2048, 2048)
  float32 matrix and one column;
* K5, its hop entry ``frontier_fused_hop`` (what the fused expand
  launches), the masks entry ``frontier_fused_masks_table`` and the
  list-taking ``frontier_fused_masks``, at ``--rows`` packed rows of
  ``--members`` queries with ``--max-deg`` candidate slots and k = 8 (the
  defaults: the real rows, members and fan-out of the largest dispatch of
  ``chip_smoke.py``'s fused leg, whose K5 ``kernel`` line prints that
  shape; the fused expand hands the card the rows unpadded); beside them
  the hop's ctypes launch alone (the memset and its two launches),
  the member table's copy to the card from pinned memory without a
  stream sync (as the list-taking entry makes it; the fused expand puts
  it in the one copy it makes anyway) and as a pageable
  ``torch.tensor(...).to`` copy, which syncs the stream, and the whole
  ``ops.frontier_expand_fused`` call on the same rows with the members'
  table rows stacked per call, as the fused driver passes them;
* K1, ``frontier_masks`` and the hop entry ``frontier_hop``, on the same
  rows as one query; beside them the outputs the masks wrapper allocated
  before it made one allocation (three ``torch.empty`` and a
  ``torch.zeros``) and the one it makes now.

Run from the root of a checkout on a machine with a CUDA device:
``python3 tools/wrapper_host_cost.py``.  Prints one JSON object of
microseconds per call.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_us(torch, fn, reps: int = 3000) -> float:
    """Microseconds of host time per call of ``fn`` over ``reps`` calls,
    after 100 warm-up calls; the queue is drained before and after."""
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / reps * 1e6


def frontier_inputs(torch, np, dev, rows, members, max_deg, k=8, n=65536,
                    seed=0):
    """Index arrays of ``members`` queries over ``n`` vertices, each with
    ``max_deg`` candidates in every budget column, and ``rows`` packed
    rows (in member order) at depth 2: the arguments of one fused hop."""
    rng = np.random.default_rng(seed)
    begin = np.arange(n, dtype=np.int64) * max_deg
    end = np.repeat((begin + max_deg)[:, None], k + 1, axis=1)
    begins, ends, dsts = [], [], []
    for _ in range(members):
        begins.append(torch.from_numpy(begin.astype(np.int32)).to(dev))
        ends.append(torch.from_numpy(end.astype(np.int32)).to(dev))
        dsts.append(torch.from_numpy(rng.integers(
            0, n, n * max_deg).astype(np.int32)).to(dev))
    paths = np.full((rows, k + 1), -1, np.int32)
    paths[:, :3] = rng.integers(0, n, (rows, 3))
    rank = np.sort(rng.integers(0, members, rows)).astype(np.int32)
    tvec = rng.integers(0, n, members).astype(np.int32)
    depthv = np.full(members, 2, np.int32)
    return paths, rank, tvec, depthv, begins, ends, dsts


def main() -> None:
    import argparse

    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=75434)
    ap.add_argument("--members", type=int, default=16)
    ap.add_argument("--max-deg", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("wrapper_host_cost: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import frontier_expand as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels import semiring_spmm as sr

    dev = torch.device("cuda", 0)
    n = 2048
    a = torch.zeros((n, n), device=dev)
    x = torch.zeros((n, 1), device=dev)
    y = torch.empty((n, 1), device=dev)
    lib = sr._lib()
    raw = _build.stream(dev)
    ptrs = (a.data_ptr(), x.data_ptr(), y.data_ptr())
    out = {
        "device": torch.cuda.get_device_name(0),
        "counting_spmm_q1": host_us(torch, lambda: sr.counting_spmm(a, x)),
        "torch_matmul_q1": host_us(torch, lambda: torch.matmul(a, x)),
        "ctypes_launch_only": host_us(
            torch, lambda: lib.counting_spmm_launch(*ptrs, 0, n, 1, 1, n,
                                                    raw)),
        "torch_empty": host_us(torch, lambda: torch.empty(
            (n, 1), dtype=torch.float32, device=dev)),
        "current_stream_object": host_us(
            torch, lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream": host_us(torch, lambda: _build.stream(dev)),
        "argument_checks": host_us(torch, lambda: (
            sr._check_f32("adj", a, dev), sr._check_f32("counts", x, dev))),
    }

    # K5 and K1 at the fused leg's shape
    rows, m, md = args.rows, args.members, args.max_deg
    paths, rank, tvec, depthv, begins, ends, dsts = frontier_inputs(
        torch, np, dev, rows, m, md)
    wantc = np.ones(m, bool)
    wc = torch.ones(m, dtype=torch.int32, device=dev)
    p = torch.from_numpy(paths).to(dev)
    rk = torch.from_numpy(rank).to(dev)
    tv = torch.from_numpy(tvec).to(dev)
    dv = torch.from_numpy(depthv).to(dev)
    k1 = paths.shape[1]
    host_table = fe.fused_member_table(begins, ends, dsts, k1max=k1,
                                       device=dev)
    table = torch.from_numpy(host_table).to(dev)
    # each member's row built once, as the fused driver keeps them
    table_rows = list(host_table)
    vnew = torch.empty((rows, md), dtype=torch.int32, device=dev)
    emit, cont = torch.empty_like(vnew), torch.empty_like(vnew)
    counters = torch.empty((m, 4), dtype=torch.int32, device=dev)
    flib = fe._fused_lib()
    fptrs = (p.data_ptr(), rk.data_ptr(), tv.data_ptr(), dv.data_ptr(),
             table.data_ptr(), vnew.data_ptr(), emit.data_ptr(),
             cont.data_ptr(), counters.data_ptr())
    # the hop's head, block totals and row blocks, allocated once
    hop_buf = torch.empty(4 * fe.HOP_MAX_GRID + 6 * m + 2 * rows * md * k1,
                          dtype=torch.int32, device=dev)
    o = 4 * fe.HOP_MAX_GRID + 6 * m
    hptrs = (p.data_ptr(), rk.data_ptr(), tv.data_ptr(), dv.data_ptr(),
             wc.data_ptr(), table.data_ptr(),
             hop_buf[4 * fe.HOP_MAX_GRID:].data_ptr(), hop_buf.data_ptr(),
             hop_buf[o:].data_ptr(), hop_buf[o + rows * md * k1:].data_ptr())

    def outputs(zeros):
        return ([torch.empty((rows, md), dtype=torch.int32, device=dev)
                 for _ in range(3)],
                (torch.zeros if zeros else torch.empty)(
                    (m, 4), dtype=torch.int32, device=dev))
    # reps of 300 for calls that launch: the card's queue never fills
    out.update({
        "k5_shape": {"rows": rows, "members": m, "k1": k1, "max_deg": md},
        "k5_hop_entry": host_us(
            torch, lambda: fe.frontier_fused_hop(
                p, rk, tv, dv, wc, table, max_deg=md), 300),
        "k5_hop_ctypes_launch_only": host_us(
            torch, lambda: flib.frontier_fused_hop_launch(
                *hptrs, rows, k1, md, m, raw), 300),
        "k5_table_entry": host_us(
            torch, lambda: fe.frontier_fused_masks_table(
                p, rk, tv, dv, table, max_deg=md), 300),
        "k5_list_entry": host_us(torch, lambda: fe.frontier_fused_masks(
            p, rk, tv, dv, begins, ends, dsts, max_deg=md), 300),
        "k5_ctypes_launch_only": host_us(
            torch, lambda: flib.frontier_fused_masks_launch(
                *fptrs, rows, k1, md, m, raw), 300),
        "k5_outputs_torch_empty": host_us(torch, lambda: outputs(False)),
        "k5_row_checks": host_us(torch, lambda: fe._check_rows(
            p, rk, tv, dv, m, md)),
        "k5_member_table_build": host_us(
            torch, lambda: fe.fused_member_table(
                begins, ends, dsts, k1max=k1, device=dev), 1000),
        "k5_table_pinned_copy": host_us(
            torch, lambda: torch.from_numpy(host_table).pin_memory().to(
                dev, non_blocking=True), 300),
        "k5_table_pageable_copy": host_us(torch, lambda: torch.tensor(
            host_table).to(dev), 300),
        "k5_counters_torch_zeros": host_us(torch, lambda: torch.zeros(
            (m, 4), dtype=torch.int32, device=dev)),
        "fused_expand_whole": host_us(
            torch, lambda: ops.frontier_expand_fused(
                paths, rank, tvec, depthv, begins, ends, dsts, wantc,
                max_deg=md, member_table=np.stack(table_rows)), 100),
    })
    meta = torch.tensor([2, int(tvec[0])], dtype=torch.int32).to(dev)
    klib = fe._lib()
    kptrs = (p.data_ptr(), begins[0].data_ptr(), ends[0].data_ptr(),
             dsts[0].data_ptr(), meta.data_ptr(), vnew.data_ptr(),
             emit.data_ptr(), cont.data_ptr(), counters.data_ptr())
    out.update({
        "k1_wrapper": host_us(torch, lambda: fe.frontier_masks(
            p, begins[0], ends[0], dsts[0], meta, max_deg=md), 300),
        "k1_ctypes_launch_only": host_us(
            torch, lambda: klib.frontier_masks_launch(
                *kptrs, rows, k1, md, dsts[0].shape[0], raw), 300),
        "k1_outputs_torch_empty_and_zeros": host_us(
            torch, lambda: outputs(True)),
        "k1_outputs_one_empty": host_us(torch, lambda: torch.empty(
            3 * rows * md + 4, dtype=torch.int32, device=dev)),
        "k1_hop_wrapper": host_us(torch, lambda: fe.frontier_hop(
            p, begins[0], ends[0], dsts[0], meta, max_deg=md), 300),
        "k1_argument_checks": host_us(torch, lambda: fe._check_args(
            p, begins[0], ends[0], dsts[0], meta, md)),
    })
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
