"""End-to-end LM training: lm100m, about 100M parameters.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps N] [--device cpu] [--metrics-out PATH]

A short run by default (30 steps of 4 x 128 tokens); pass --steps 300
for the full one.  Trains through ``launch.train`` in this process, on
plain attention as ``repro``'s training does; ``--metrics-out`` writes
the metrics log as JSON.
"""
from __future__ import annotations

from ..launch import train
from ..core.device import resolve_device
from . import parser


def main(argv: list[str] | None = None) -> dict:
    """Train in this process; returns ``launch.train.main``'s values."""
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--metrics-out", default=None,
                    help="write the metrics log here as JSON")
    args = ap.parse_args(argv)
    resolve_device(args.device)     # raises without a card
    extra = ["--metrics-out", args.metrics_out] if args.metrics_out else []
    return train.main(["--preset", "lm100m", "--steps", str(args.steps),
                       "--batch", "4", "--seq", "128",
                       "--device", args.device] + extra)


if __name__ == "__main__":
    main()
