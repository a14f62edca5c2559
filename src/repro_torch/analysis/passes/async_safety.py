"""async-safety: no blocking calls inside ``async def`` (DESIGN.md §7, §11).

The async front-end's whole contract is that the event loop keeps
admitting (and rejecting) requests while enumeration runs in a worker
thread.  One blocking call inside an ``async def`` body stalls every
pending future at once, and no unit test reliably catches it (the tests
still pass, just slower and with the admission control gone).

Flagged inside ``async def`` bodies under the port's ``serving/``:

  * ``repro``'s three clauses, unchanged: ``time.sleep(...)`` (use
    ``asyncio.sleep``); a direct ``<...>engine.run(...)`` (dispatch
    through ``asyncio.to_thread(self.engine.run, ...)``: passing the
    bound method *as an argument* is the sanctioned pattern); and
    ``.block_until_ready()``;
  * the port's device syncs: ``torch.cuda.synchronize(...)`` and a
    stream's or event's ``.synchronize()``.  A sync waits for the card,
    and belongs in the worker thread, never on the loop.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..framework import Finding, LintPass, SourceFile


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted name of an expression (``self.engine`` ->
    'self.engine'); empty for non-name shapes."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


class AsyncSafetyPass(LintPass):
    """AST walk over async function bodies in the serving layer."""

    name = "async-safety"
    description = ("no blocking calls (time.sleep, direct engine.run, "
                   ".block_until_ready, torch.cuda.synchronize, a stream's "
                   "or event's .synchronize) inside async def bodies in "
                   "serving/ (DESIGN.md §7)")
    scope = ("src/repro_torch/serving/*.py",)

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        for node in sf.nodes:
            if isinstance(node, ast.AsyncFunctionDef):
                yield from self._check_async_body(sf, node)

    def _check_async_body(self, sf: SourceFile,
                          fn: ast.AsyncFunctionDef) -> Iterator[Finding]:
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            callee = node.func
            if not isinstance(callee, ast.Attribute):
                continue
            owner = _dotted(callee.value)
            if callee.attr == "sleep" and owner == "time":
                yield self.finding(sf, node, (
                    f"time.sleep inside async def {fn.name} blocks the "
                    f"event loop — use asyncio.sleep"))
            elif callee.attr == "block_until_ready":
                yield self.finding(sf, node, (
                    f".block_until_ready() inside async def {fn.name} "
                    f"stalls the loop on device sync — move it into the "
                    f"worker thread"))
            elif callee.attr == "run" and "engine" in owner.split("."):
                yield self.finding(sf, node, (
                    f"direct {owner}.run(...) inside async def {fn.name} "
                    f"runs enumeration on the event loop — dispatch via "
                    f"asyncio.to_thread({owner}.run, ...)"))
            elif callee.attr == "synchronize":
                yield self.finding(sf, node, (
                    f"{owner or '<expr>'}.synchronize() inside async def "
                    f"{fn.name} stalls the loop on the card — move it "
                    f"into the worker thread"))


PASSES = [AsyncSafetyPass()]
