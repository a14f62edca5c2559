"""Motivation example 3: paths as training signal for KG completion.

    PYTHONPATH=src python -m repro_torch.examples.kg_completion [--device cpu]

PathEnum enumerates hop-constrained paths between entity pairs (K1's hop
entry on the card); the data pipeline tokenizes them; a small LM trains
on the path corpus for 30 steps and its loss must fall.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from ..core import power_law
from ..data.pipeline import PathCorpus
from ..optim import adamw
from ..training.trainer import Trainer, TrainerConfig
from . import device_from

# the LM's shape, less its vocabulary (the corpus's)
ARCH = dict(name="kg_lm", family="dense", num_layers=2, d_model=128,
            num_heads=4, kv_heads=2, d_ff=256, head_dim=32, attn_chunk=32,
            tie_embeddings=True)
OPT = dict(peak_lr=1e-3, warmup_steps=5, total_steps=30)
STEPS = 30


def corpus(device) -> PathCorpus:
    """The example's path corpus on ``power_law(500, 5.0, seed=11)``."""
    graph = power_law(500, 5.0, seed=11)
    return PathCorpus(graph=graph, k=4, seq_len=32, global_batch=8,
                      device=device)


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns the values it printed and the logged
    losses."""
    dev = device_from(argv, __doc__)
    data = corpus(dev)
    cfg = ArchConfig(vocab=data.vocab, **ARCH)
    opt = adamw.OptimizerConfig(**OPT)
    trainer = Trainer(cfg, opt, TrainerConfig(steps=STEPS, log_every=5,
                                              device=dev))
    trainer.fit(data)
    first, last = trainer.metrics_log[0], trainer.metrics_log[-1]
    print(f"path-LM loss: step {first['step']}: {first['loss']:.3f} -> "
          f"step {last['step']}: {last['loss']:.3f}")
    assert last["loss"] < first["loss"], "training on path corpus must learn"
    print("OK")
    return {"first": (first["step"], first["loss"]),
            "last": (last["step"], last["loss"]),
            "log": [(r["step"], r["loss"]) for r in trainer.metrics_log]}


if __name__ == "__main__":
    main()
