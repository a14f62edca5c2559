"""Serving launcher: batched decode over a (reduced) arch config.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3p2_1b \\
      --requests 8 --max-tokens 12 [--device cpu]

The arguments and defaults are ``repro.launch.serve``'s, plus
``--device`` (default ``cuda``: without a card it raises; ``cpu`` runs
the plain attention path).  Parameters are random, from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv: list[str] | None = None) -> dict:
    """Serve the requests; returns what it printed, the wall time left
    out: requests, tokens, engine steps and each request's tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--preset", default="reduced", choices=["reduced", "full"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_arch
    from ..models import transformer
    from ..serving.engine import Request, ServeEngine

    cfg = get_arch(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    params = transformer.init_params(cfg, 0, device=args.device)
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         max_len=args.max_len,
                         temperature=args.temperature, device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for uid in range(args.requests):
        prompt = rng.integers(3, cfg.vocab, size=rng.integers(2, 8))
        engine.submit(Request(uid=uid, prompt=prompt.astype(np.int32),
                              max_tokens=args.max_tokens))
    results = engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.time() - t0
    toks = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks/max(wall,1e-9):.1f} tok/s, {engine.steps_run} engine steps"
          f", {engine.device})")
    for uid in sorted(results):
        print(f"  req {uid}: {results[uid]}")
    return {"requests": len(results), "tokens": toks,
            "engine_steps": engine.steps_run,
            "results": {uid: list(results[uid]) for uid in sorted(results)}}


if __name__ == "__main__":
    main()
