"""repro-torch-lint: the port's static analysis (DESIGN.md §11).

The counterpart of ``repro.analysis``, with the same framework, command
line and seven rule families, each restated for the port: the kernel
wrappers' contract (first-use builds, a plain version beside every
kernel, no fallback that hides one, PAD, int32), the port's boundary
(no JAX or ``repro`` import, one CUDA probe, one process-group
factory), async safety in serving, the deadline hook in the emitting
loops, float64 rank costs, the docs gates and hygiene.  It reads source
only: it imports neither ``torch`` nor ``jax`` and nothing of ``repro``,
and needs no device.  One entry point, the same on the CPU and on the
GPU machine (``chip_smoke.py`` runs it as its first phase):

    python -m repro_torch.analysis --strict

Programmatic surface: ``lint_repo()`` runs the full registry over the
repo walk and returns a ``LintReport``; ``run_passes`` is the
lower-level hook the tests use to aim individual passes at fixture
files.  Rule catalogue: the README's ``PyTorch/CUDA port`` section.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

from .framework import (Finding, LintContext, LintPass, LintReport,
                        SourceFile, repo_root, run_passes, walk_repo)
from .passes import ALL_PASSES, PASS_BY_NAME

__all__ = [
    "ALL_PASSES", "PASS_BY_NAME", "Finding", "LintContext", "LintPass",
    "LintReport", "SourceFile", "lint_repo", "repo_root", "run_passes",
    "walk_repo",
]


def lint_repo(root: Optional[Path] = None,
              rules: Optional[Sequence[str]] = None) -> LintReport:
    """Run the full registry (or the named ``rules``) over the repo walk
    and return the report.  Raises KeyError on an unknown rule name."""
    passes = ALL_PASSES if rules is None else [
        PASS_BY_NAME[r] for r in rules]
    return run_passes(passes, root=root)
