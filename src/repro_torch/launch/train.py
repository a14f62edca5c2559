"""End-to-end training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3p2_1b \\
      --preset reduced --steps 50 --ckpt-dir /tmp/ckpt [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --preset lm100m \\
      --steps 200 --data path_corpus   # trains on PathEnum's paths

The arguments, presets (``reduced``, ``full``, ``lm100m``) and output
are ``repro``'s, plus ``--device`` (default ``cuda``: without a card it
raises).  ``--data path_corpus`` draws from ``power_law(2000, 6.0,
seed=1)`` through a ``PathCorpus`` on the same device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def build_arch(args):
    """The config a preset names."""
    from ..configs import get_arch
    from ..configs.base import ArchConfig

    if args.preset == "lm100m":
        # ~100M-param llama-style model for the end-to-end example
        return ArchConfig(
            name="lm100m", family="dense", num_layers=8, d_model=1024,
            num_heads=16, kv_heads=4, d_ff=2816, vocab=16384, head_dim=64,
            attn_chunk=256, tie_embeddings=True)  # ≈107M params
    cfg = get_arch(args.arch)
    if args.preset == "reduced":
        cfg = cfg.reduced()
    return cfg


def main(argv: list[str] | None = None) -> dict:
    """Train; returns what it printed, the wall time left out: the
    config's name, its parameter count, the steps, the straggler steps
    and the metrics log."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3p2_1b")
    ap.add_argument("--preset", default="reduced",
                    choices=["reduced", "full", "lm100m"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "path_corpus"])
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import tree as tree_mod
    from ..core.device import resolve_device
    from ..data.pipeline import PathCorpus, SyntheticLM
    from ..optim import adamw
    from ..training.trainer import Trainer, TrainerConfig

    device = resolve_device(args.device)
    cfg = build_arch(args)
    if args.data == "path_corpus":
        from ..core.graph import power_law
        g = power_law(2000, 6.0, seed=1)
        data = PathCorpus(graph=g, k=5, seq_len=args.seq,
                          global_batch=args.batch, device=device)
        cfg = dataclasses.replace(cfg, vocab=max(cfg.vocab, data.vocab))
    else:
        data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq,
                           global_batch=args.batch)

    opt_cfg = adamw.OptimizerConfig(peak_lr=args.lr, warmup_steps=20,
                                    total_steps=args.steps)
    tcfg = TrainerConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches,
                         log_every=max(1, args.steps // 20), device=device)
    trainer = Trainer(cfg, opt_cfg, tcfg)
    t0 = time.time()
    params, _ = trainer.fit(data)
    wall = time.time() - t0

    n_params = sum(x.numel() for x in tree_mod.leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps} "
          f"wall={wall:.1f}s stragglers={trainer.straggler_steps}")
    for rec in trainer.metrics_log:
        print(json.dumps(rec))
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"config": cfg.name, "params": n_params,
                       "log": trainer.metrics_log}, f, indent=2)
    return {"config": cfg.name, "params": n_params, "steps": args.steps,
            "stragglers": list(trainer.straggler_steps),
            "log": list(trainer.metrics_log)}


if __name__ == "__main__":
    main()
