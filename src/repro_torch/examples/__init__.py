"""The port's runnable examples: ``repro``'s nine ``examples/*.py`` under
the same names, on the card.

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

Each module keeps its ``repro`` script's graphs, seeds, sizes and
assertions and prints the same lines.  ``main(argv=None)`` takes
``--device`` (``cuda`` by default: without a card it raises; ``cpu``
runs the plain versions of the kernels) and returns a dict of the
values it printed, wall-clock times left out.

PathEnum: ``quickstart`` (one query, the planner and the oracle),
``fraud_detection`` (weight-ranked top-3 cycles), ``batch_serving``
(``HcPEServer``, cold and warm), ``multi_tenant_serving``
(``GraphRegistry``), ``async_serving`` (``AsyncHcPEServer`` against the
sync server), ``streaming_serving`` (``mutate`` and the metrics
exports).  The LM: ``kg_completion`` (a small LM trained on a
``PathCorpus``), ``serve_batch`` (``launch.serve``), ``train_lm``
(``launch.train``, lm100m).
"""
from __future__ import annotations

import argparse

import torch

from ..core.device import resolve_device

PATHENUM = ("quickstart", "fraud_detection", "batch_serving",
            "multi_tenant_serving", "async_serving", "streaming_serving")
LM = ("kg_completion", "serve_batch", "train_lm")
NAMES = PATHENUM + LM

# values in a PathEnum example's returned dict that follow the wall
# clock, so two runs on the same inputs may differ in them
CLOCK_BOUND = {
    "async_serving": {
        "slo_met": "a light request meets its 50 ms deadline only if its "
                   "micro-batch is answered within 50 ms of wall time",
        "micro_batches": "requests join a micro-batch by arrival within "
                         "the 2 ms batching window",
    },
}


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the examples' ``--device``."""
    ap = argparse.ArgumentParser(description=doc.strip().split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions)")
    return ap


def device_from(argv: list[str] | None, doc: str) -> torch.device:
    """The device ``--device`` names in ``argv``."""
    return resolve_device(parser(doc).parse_args(argv).device)
