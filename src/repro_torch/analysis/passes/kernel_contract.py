"""kernel-contract: the CUDA kernels' wrapper contracts (DESIGN.md §9, §11).

``repro``'s pass holds its Pallas call sites to four clauses: an
``interpret=`` switch and a ``grid=``, PAD = −1, int32 matrices, and a
``ref.py`` oracle registered beside every ``ops.py`` wrapper.  The port
has no Pallas call; its kernels are CUDA sources built by
``kernels/_build.py`` and launched through ctypes from the wrappers in
``kernels/*.py``.  The port's form of those clauses:

  * **First use, not import.**  ``_build.load(...)`` and
    ``_build.build_all(...)`` are called only inside a function body,
    and ``triton`` is imported only there: the CPU tests import every
    module on machines without ``nvcc``.
  * **A plain version beside every kernel** (the counterpart of the
    ``ref.py`` oracle).  Each public function that reaches
    ``_build.load`` in its own module, directly or through another
    function of the module, has a branch for a non-CUDA tensor
    (``if not x.is_cuda:``, or the ``else`` of ``if x.is_cuda:``) that
    returns a call to a ``*_plain`` function.
  * **No fallback that hides the kernel**, anywhere in
    ``src/repro_torch/**``: the body of an exception handler calls no
    ``*_plain`` function and names no ``"cpu"`` device.  A failed build
    or launch raises.
  * **PAD.**  A module-level ``PAD`` is −1 (``-1`` or ``np.int32(-1)``),
    as ``repro``'s is, anywhere in the port.
  * **Integer matrices stay int32** in the functions that reach
    ``_build.load``: ``int64`` / ``long`` (``torch.long``, ``.long()``)
    and the narrower or unsigned integer dtypes are flagged there.  The
    plain versions index with int64 and are not held to it.
  * **One build list** (aggregate, over ``kernels/_build.py``):
    ``SOURCES`` names every ``csrc/*.cu`` beside it and nothing else,
    and ``NVCC_FLAGS`` targets ``sm_90a``.

Kernel modules are ``src/repro_torch/kernels/*.py``; the fallback and
PAD clauses cover the whole port.  Explicit paths outside the port's
tree (fixtures, copies) get every clause.
"""
from __future__ import annotations

import ast
import fnmatch
from typing import Dict, Iterator, List, Optional, Set

from ..framework import (Finding, LintContext, LintPass, SourceFile,
                         dotted_name)

# the shared sentinel, pinned by core.graph.PAD
PAD_VALUE = -1

KERNEL_MODULES = "src/repro_torch/kernels/*.py"
PORT_PREFIX = "src/repro_torch/"
BUILD_MODULE = "_build.py"
BUILD_REL = "src/repro_torch/kernels/_build.py"
ARCH_FLAG = "sm_90a"

_BUILD_CALLS = frozenset({"load", "build_all"})
_WIDE_INTS = frozenset({
    "int64", "long", "int16", "int8", "uint8", "uint16", "uint32",
    "uint64"})
_FUNC = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _callee(node: ast.Call) -> str:
    """The last name of a call's function (``a.b.f(...)`` -> 'f')."""
    return dotted_name(node.func).rsplit(".", 1)[-1]


def _int_value(node: ast.AST) -> Optional[int]:
    """The integer a literal spells: ``-1``, ``1``, or a one-argument
    constructor of one (``np.int32(-1)``); None for anything else."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        inner = _int_value(node.operand)
        return None if inner is None else -inner
    if isinstance(node, ast.Call) and len(node.args) == 1 \
            and not node.keywords:
        return _int_value(node.args[0])
    return None


def _branch_on_cuda(test: ast.AST) -> Optional[bool]:
    """True for a test that holds on a CUDA tensor (``x.is_cuda``,
    ``x.device.type == "cuda"``), False for one that holds off it
    (``not x.is_cuda``, ``x.device.type != "cuda"``, ``x.is_cpu``),
    None for any other test."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _branch_on_cuda(test.operand)
        return None if inner is None else not inner
    if isinstance(test, ast.Attribute) and test.attr in ("is_cuda",
                                                         "is_cpu"):
        return test.attr == "is_cuda"
    if isinstance(test, ast.Compare) and len(test.ops) == 1 \
            and isinstance(test.left, ast.Attribute) \
            and test.left.attr == "type" \
            and isinstance(test.comparators[0], ast.Constant) \
            and test.comparators[0].value in ("cuda", "cpu"):
        eq = isinstance(test.ops[0], ast.Eq)
        if not eq and not isinstance(test.ops[0], ast.NotEq):
            return None
        return eq == (test.comparators[0].value == "cuda")
    return None


def _walk_body(stmts: List[ast.stmt]) -> Iterator[ast.AST]:
    """Every node of ``stmts``, nested function bodies excluded."""
    stack: List[ast.AST] = [s for s in stmts if not isinstance(s, _FUNC)]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, _FUNC):
                stack.append(child)


def _returns_plain(stmts: List[ast.stmt]) -> bool:
    """True when ``stmts`` return a call to a ``*_plain`` function."""
    return any(isinstance(n, ast.Return) and isinstance(n.value, ast.Call)
               and _callee(n.value).endswith("_plain")
               for n in _walk_body(stmts))


def _has_plain_branch(fn: ast.AST) -> bool:
    """True when ``fn`` has a branch for a non-CUDA tensor that returns
    a call to a ``*_plain`` function."""
    for node in _walk_body(fn.body):
        if not isinstance(node, ast.If):
            continue
        on_cuda = _branch_on_cuda(node.test)
        if on_cuda is False and _returns_plain(node.body):
            return True
        if on_cuda is True and _returns_plain(node.orelse):
            return True
    return False


class KernelContractPass(LintPass):
    """AST checks for the port's kernel-wrapper conventions."""

    name = "kernel-contract"
    description = ("kernels build at first use, each public wrapper that "
                   "reaches _build.load has a non-CUDA branch returning a "
                   "*_plain version, no except handler falls back to a "
                   "plain version or the CPU, PAD stays -1, launching "
                   "functions stay int32, and _build.SOURCES / NVCC_FLAGS "
                   "cover csrc/*.cu for sm_90a (DESIGN.md §9)")
    scope = ("src/repro_torch/*.py",)

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        yield from self._check_fallbacks(sf)
        yield from self._check_pad(sf, tree)
        if fnmatch.fnmatch(sf.rel, KERNEL_MODULES) \
                or not sf.rel.startswith(PORT_PREFIX):
            build_names = self._build_names(tree)
            yield from self._check_first_use(sf, tree, build_names)
            yield from self._check_launchers(sf, tree, build_names)

    # -- the whole port ----------------------------------------------------

    def _check_fallbacks(self, sf: SourceFile) -> Iterator[Finding]:
        seen: Set[int] = set()
        handlers = [h for h in sf.nodes
                    if isinstance(h, ast.ExceptHandler)]
        for node in (n for h in handlers for stmt in h.body
                     for n in ast.walk(stmt)):
            if id(node) in seen:        # a handler inside a handler
                continue
            seen.add(id(node))
            if isinstance(node, ast.Call) \
                    and _callee(node).endswith("_plain"):
                yield self.finding(sf, node, (
                    f"{_callee(node)} called in an exception handler — a "
                    f"failed build or launch must raise, not fall back to "
                    f"the plain version"))
            elif isinstance(node, ast.Constant) and node.value == "cpu":
                yield self.finding(sf, node, (
                    "the 'cpu' device named in an exception handler — a "
                    "failure on the card must raise, not move the work to "
                    "the CPU"))

    def _check_pad(self, sf: SourceFile,
                   tree: ast.Module) -> Iterator[Finding]:
        for node in tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            if any(isinstance(t, ast.Name) and t.id == "PAD"
                   for t in targets) and _int_value(value) != PAD_VALUE:
                yield self.finding(sf, node, (
                    f"PAD declared with a value other than {PAD_VALUE} — "
                    f"the sentinel is shared with repro's; divergence "
                    f"breaks PAD-row inertness and parity"))

    # -- kernel modules ----------------------------------------------------

    @staticmethod
    def _build_names(tree: ast.Module) -> Set[str]:
        """Names under which the module calls ``_build``'s entry points:
        '_build.load', '_build.build_all', and any alias imported from
        ``_build``."""
        names = {f"_build.{n}" for n in _BUILD_CALLS}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module \
                    and node.module.rsplit(".", 1)[-1] == "_build":
                for alias in node.names:
                    if alias.name in _BUILD_CALLS:
                        names.add(alias.asname or alias.name)
        return names

    def _check_first_use(self, sf: SourceFile, tree: ast.Module,
                         build_names: Set[str]) -> Iterator[Finding]:
        # what runs at import: the module body, class bodies included
        for node in _walk_body(tree.body):
            name = dotted_name(node.func) \
                if isinstance(node, ast.Call) else ""
            if name in build_names:
                yield self.finding(sf, node, (
                    f"{name}(...) at import — kernels build at first use, "
                    f"inside the function that launches them; the CPU "
                    f"tests import every module without nvcc"))
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import)
                        else [node.module or ""])
                if any(m.split(".")[0] == "triton" for m in mods):
                    yield self.finding(sf, node, (
                        "triton imported at import time — import it inside "
                        "the function that launches the kernel"))

    def _check_launchers(self, sf: SourceFile, tree: ast.Module,
                         build_names: Set[str]) -> Iterator[Finding]:
        funcs: Dict[str, ast.AST] = {
            n.name: n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
        calls: Dict[str, Set[str]] = {}
        reaches: Set[str] = set()
        for name, fn in funcs.items():
            calls[name] = set()
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                callee = dotted_name(node.func)
                if callee in build_names:
                    reaches.add(name)
                elif callee in funcs:
                    calls[name].add(callee)
        changed = True
        while changed:
            changed = False
            for name, callees in calls.items():
                if name not in reaches and callees & reaches:
                    reaches.add(name)
                    changed = True
        for name in sorted(reaches, key=lambda n: funcs[n].lineno):
            fn = funcs[name]
            if not name.startswith("_") and not _has_plain_branch(fn):
                yield self.finding(sf, fn, (
                    f"{name} launches a kernel but has no branch for a "
                    f"non-CUDA tensor returning a *_plain version — every "
                    f"kernel keeps its plain version beside it"))
            for node in ast.walk(fn):
                if isinstance(node, ast.Attribute) \
                        and node.attr in _WIDE_INTS:
                    yield self.finding(sf, node, (
                        f"integer dtype {node.attr} in {name}, which "
                        f"launches a kernel — path and index matrices are "
                        f"int32 by contract (DESIGN.md §9)"))

    # -- the build list ----------------------------------------------------

    def check_aggregate(self, ctx: LintContext,
                        files: List[SourceFile]) -> Iterator[Finding]:
        builds = [sf for sf in files if sf.parse_error is None
                  and sf.rel.rsplit("/", 1)[-1] == BUILD_MODULE]
        if not builds and not ctx.explicit:
            yield Finding(rule=self.name, path=BUILD_REL, line=0,
                          message="no kernels/_build.py: nothing builds "
                                  "the CUDA sources")
        for sf in builds:
            yield from self._check_build(sf)

    def _check_build(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        found: Dict[str, ast.AST] = {}
        for node in tree.body:
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id in ("SOURCES",
                                                        "NVCC_FLAGS"):
                    found[t.id] = value
        sources = found.get("SOURCES")
        if not isinstance(sources, ast.Dict):
            yield self.finding(sf, 0, (
                "no module-level SOURCES dict literal — the build list "
                "must name every csrc/*.cu"))
        else:
            named = {v.value for v in sources.values
                     if isinstance(v, ast.Constant)
                     and isinstance(v.value, str)}
            csrc = sf.path.parent / "csrc"
            present = {p.name for p in csrc.glob("*.cu")}
            for cu in sorted(present - named):
                yield self.finding(sf, sources, (
                    f"csrc/{cu} is not in SOURCES — it would never be "
                    f"built"))
            for cu in sorted(named - present):
                yield self.finding(sf, sources, (
                    f"SOURCES names {cu}, which is not a csrc/*.cu file"))
        flags = found.get("NVCC_FLAGS")
        strings = [] if flags is None else [
            n.value for n in ast.walk(flags)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]
        if not any(ARCH_FLAG in s for s in strings):
            yield self.finding(sf, flags if flags is not None else 0, (
                f"NVCC_FLAGS does not target {ARCH_FLAG} — the kernels "
                f"are written for Hopper"))


PASSES = [KernelContractPass()]
