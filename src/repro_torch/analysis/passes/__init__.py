"""The repro-torch-lint rule registry (DESIGN.md §11).

One module per rule family, with ``repro.analysis.passes``'s names; each
exports a ``PASSES`` list, folded here into ``ALL_PASSES`` — the set
``python -m repro_torch.analysis`` runs by default.  To add a rule:
write the pass module, append its ``PASSES`` here, pair it with good
and bad fixtures under ``tests/fixtures/repro_torch_lint/`` and a row in
the README's static-analysis table of the port.
"""
from __future__ import annotations

from typing import Dict, List

from ..framework import LintPass
from . import (async_safety, compat_boundary, deadline_hook, docs,
               hygiene, kernel_contract, rank_dtype)

ALL_PASSES: List[LintPass] = [
    *kernel_contract.PASSES,
    *compat_boundary.PASSES,
    *async_safety.PASSES,
    *deadline_hook.PASSES,
    *rank_dtype.PASSES,
    *docs.PASSES,
    *hygiene.PASSES,
]

PASS_BY_NAME: Dict[str, LintPass] = {p.name: p for p in ALL_PASSES}

__all__ = ["ALL_PASSES", "PASS_BY_NAME"]
