"""Command line of the benchmark: one run of one cell.

    python -m hcpe_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout.  It needs a CUDA card: without one it
exits with code 2 and prints no result.  The program under test is the
PyTorch port in ``src/repro_torch``; without it the run fails.  The
last line of standard output is the result as one JSON object; the
numbers the check compared, each beside its limit, are also the last
lines of standard error.  A run whose process holds ``jax``,
``jaxlib``, ``flax`` or ``repro`` once its window has closed exits
with code 3 and prints no result.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    # the program's build and kernel caches stay at fixed places inside
    # the checkout (the port builds its kernels into its own
    # src/repro_torch/kernels/build/)
    cache = REPO / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        log("no CUDA device: this benchmark runs on the card only")
        return 2
    if not (REPO / "src" / "repro_torch").is_dir():
        log("the program (src/repro_torch) is not in this checkout")
        return 1
    from hcpe_bench import harness
    harness.use_checkout_program()
    log(f"device {torch.cuda.get_device_name(0)}")
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              started=STARTED, log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"forbidden modules loaded in this process: {found}")
        return 3
    log(f"power_limit_w {result['device'].get('power_limit_w')}")
    for name, c in result["checks"].items():
        log(f"{name} {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
