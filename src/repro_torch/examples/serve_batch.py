"""**LM decode** serving (continuous batching over decode slots).

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]

Drives the language-model serving engine (``serving/engine.py``)
through ``launch.serve`` with ``repro``'s arguments: the reduced
llama3.2-1b, 6 requests on 3 slots, 8 new tokens each.  On the card
every decode step's attention is K7.  Nothing to do with path queries:
for HcPE serving see ``batch_serving``, ``async_serving`` and
``multi_tenant_serving``.
"""
from __future__ import annotations

from ..launch import serve
from ..core.device import resolve_device
from . import parser

ARGV = ["--arch", "llama3p2_1b", "--requests", "6", "--slots", "3",
        "--max-tokens", "8"]


def main(argv: list[str] | None = None) -> dict:
    """Serve in this process; returns ``launch.serve.main``'s values."""
    args = parser(__doc__).parse_args(argv)
    resolve_device(args.device)     # raises without a card
    return serve.main(ARGV + ["--device", args.device])


if __name__ == "__main__":
    main()
