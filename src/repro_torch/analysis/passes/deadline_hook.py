"""deadline-hook: emitting loops consult the cooperative deadline (DESIGN.md §7, §11).

The serving stack's anytime contract rests on one convention in the
enumeration core: every loop that emits results or processes chunks in
a function taking a ``deadline`` parameter must consult that deadline,
so an in-flight batch stops at the next chunk/key-group boundary after
its budget expires.  The convention is easy to break silently — a new
driver loop that forgets the check still returns correct results, it
just stops honoring SLOs, and only a timing-sensitive test could
notice.

``repro``'s rule, unchanged in meaning, over the port's
``core/enumerate.py`` and ``core/join.py``: in any
function with a ``deadline`` parameter, every *outermost* loop whose
body touches the enumeration counters (``stats.chunks`` /
``stats.results`` / ``stats.pairs``) must, somewhere in its body,
either reference ``deadline`` directly or call a ``_expired()`` helper
(the join module's local idiom, itself closed over ``deadline``).
Inner loops ride on their enclosing loop's check — the deadline is a
chunk-granularity budget, not a per-row one (DESIGN.md §7).
"""
from __future__ import annotations

import ast
from typing import Iterator, List

from ..framework import Finding, LintPass, SourceFile

_LOOP = (ast.For, ast.While, ast.AsyncFor)
_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef)
_COUNTERS = frozenset({"chunks", "results", "pairs"})


def _outermost_loops(fn: ast.AST) -> List[ast.AST]:
    """The loops of ``fn`` not nested inside another loop (nested
    function bodies are separate scopes and are skipped)."""
    loops: List[ast.AST] = []

    def visit(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _LOOP):
                loops.append(child)
            elif isinstance(child, _FUNC):
                continue
            else:
                visit(child)

    visit(fn)
    return loops


def _touches_counters(loop: ast.AST) -> bool:
    """True when the loop body reads/writes an EnumStats counter on a
    ``*stats`` object — the signature of an emitting/chunking loop."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Attribute) and node.attr in _COUNTERS \
                and isinstance(node.value, ast.Name) \
                and node.value.id.endswith("stats"):
            return True
    return False


def _consults_deadline(loop: ast.AST) -> bool:
    """True when the loop body references ``deadline`` or calls the
    ``_expired`` helper idiom."""
    for node in ast.walk(loop):
        if isinstance(node, ast.Name) and node.id == "deadline":
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "_expired":
            return True
    return False


class DeadlineHookPass(LintPass):
    """AST check over the enumeration drivers' loop structure."""

    name = "deadline-hook"
    description = ("outermost emitting loops in core/enumerate.py and "
                   "core/join.py consult the cooperative deadline hook "
                   "(DESIGN.md §7)")
    scope = ("src/repro_torch/core/enumerate.py",
             "src/repro_torch/core/join.py")

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        for node in sf.nodes:
            if not isinstance(node, _FUNC):
                continue
            args = node.args
            names = [a.arg for a in (args.posonlyargs + args.args
                                     + args.kwonlyargs)]
            if "deadline" not in names:
                continue
            for loop in _outermost_loops(node):
                if _touches_counters(loop) and not _consults_deadline(loop):
                    yield self.finding(sf, loop, (
                        f"emitting loop in {node.name} never consults the "
                        f"deadline hook — a deadline-carrying batch would "
                        f"run to completion past its budget (DESIGN.md §7)"))


PASSES = [DeadlineHookPass()]
