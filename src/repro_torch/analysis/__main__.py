"""CLI for repro-torch-lint: ``python -m repro_torch.analysis``
(DESIGN.md §11).

Default run walks the port (``src/repro_torch``, ``chip_smoke.py``,
``tests/test_torch_*.py`` and ``tests/torch_*.py``, minus
tests/fixtures) with every registered pass and exits 1 on any
error-severity finding; ``--strict`` fails on warnings too.  Explicit
paths bypass the scope patterns — that is how the fixture tests aim one
rule at a known-bad snippet:

    python -m repro_torch.analysis --rules kernel-contract \\
        tests/fixtures/repro_torch_lint/kernel_contract_bad.py

Exit codes are ``repro.analysis``'s: 0 clean, 1 findings, 2 an unknown
rule.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from .framework import run_passes
from .passes import ALL_PASSES, PASS_BY_NAME


def main(argv: Optional[List[str]] = None) -> int:
    """Parse arguments, run the selected passes, print the report, and
    return the process exit code."""
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-torch-lint: the port's static analysis "
                    "(rule catalogue: README, PyTorch/CUDA port)")
    parser.add_argument("paths", nargs="*", type=Path,
                        help="explicit files to lint (bypasses rule "
                             "scoping; default: walk the port)")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on warnings as well as errors")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable JSON report on stdout")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule names to run "
                             "(default: all)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        width = max(len(p.name) for p in ALL_PASSES)
        for p in ALL_PASSES:
            print(f"{p.name:<{width}}  {p.description}")
        return 0

    if args.rules is not None:
        names = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in names if r not in PASS_BY_NAME]
        if unknown:
            print(f"repro-torch-lint: unknown rule(s): "
                  f"{', '.join(unknown)} (see --list-rules)",
                  file=sys.stderr)
            return 2
        passes = [PASS_BY_NAME[r] for r in names]
    else:
        passes = ALL_PASSES

    report = run_passes(passes, paths=args.paths or None)
    print(report.render_json() if args.json else report.render())
    return report.exit_code(strict=args.strict)


if __name__ == "__main__":
    sys.exit(main())
