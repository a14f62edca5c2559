#!/usr/bin/env python3
"""Host time per call of a kernel wrapper of the PyTorch/CUDA port, and of
the pieces it is made of, on one NVIDIA GPU.

A wrapper's call returns before the card finishes, so when the card's
work is a few microseconds the caller waits on the host: argument checks,
the output's allocation, the stream lookup and the ctypes launch.  This
script times each piece apart, with the host clock over many calls (no
synchronisation inside the loop), at the walk-count DP's shape: K3,
``counting_spmm``, on a (2048, 2048) float32 matrix and one column.

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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("wrapper_host_cost: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
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
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
