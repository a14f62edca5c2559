#!/usr/bin/env python3
"""K3 (``counting_spmm``) at q > 1 on one NVIDIA GPU, over the number of
K slices of its split-K SGEMM.

The wrapper picks the slices (``semiring_spmm.counting_splits``); this
script calls the library's launch function directly with 1, 2, 4, 8 and
16 slices at the smoke's shape, (2048, 2048) @ (2048, 128) float32, so
the time of one block's main loop (one slice: 16 blocks, each over all
of K) and the cost of cutting K (more blocks, a pass that adds the
slices) can be read apart.  Each time is the card's alone: the launches
queue behind ``torch.cuda._sleep``.  Every result is checked against the
plain product.

Run from the root of a checkout on a machine with a CUDA device:
``python3 tools/counting_spmm_sweep.py``.  Prints one JSON object.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def device_ms(torch, fn, reps: int = 50) -> float:
    """Milliseconds of device time per call, the calls queued behind a
    spin of the card so the host's launch cost is hidden."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("counting_spmm_sweep: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import semiring_spmm as sr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(5)
    n, q = 2048, 128
    a = torch.from_numpy((rng.random((n, n)) < 0.01).astype(np.float32))
    x = torch.from_numpy(rng.integers(0, 16, (n, q)).astype(np.float32))
    a, x = a.to(dev), x.to(dev)
    y = torch.empty((n, q), dtype=torch.float32, device=dev)
    want = sr.counting_spmm_plain(a, x)
    lib = sr._lib()
    out = {"device": torch.cuda.get_device_name(0), "n": n, "q": q,
           "wrapper_splits": sr.counting_splits(
               n, q, torch.cuda.get_device_properties(dev)
               .multi_processor_count)[0],
           "by_splits_ms": {}}
    for splits in (1, 2, 4, 8, 16):
        k_split = -(-(-(-n // splits)) // sr.GEMM_K_STEP) * sr.GEMM_K_STEP
        part = torch.empty((splits, n, q), dtype=torch.float32, device=dev)

        def launch():
            _build.check(lib.counting_spmm_launch(
                a.data_ptr(), x.data_ptr(), y.data_ptr(), part.data_ptr(),
                n, q, splits, k_split, _build.stream(dev)), "counting_spmm")

        ms = device_ms(torch, launch)
        if not torch.equal(y, want):
            sys.exit(f"counting_spmm_sweep: {splits} slices differ from the "
                     f"plain product")
        out["by_splits_ms"][splits] = ms
    out["torch_matmul_ms"] = device_ms(torch, lambda: torch.matmul(a, x))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
