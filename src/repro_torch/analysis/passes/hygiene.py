"""Hygiene passes: unused-import, mutable-default, bare-except (DESIGN.md §11).

``repro``'s three cleanliness rules, unchanged in meaning, over the
port's source (``src/repro_torch/**`` and ``chip_smoke.py``).  They ship
here so the port needs one lint entry point
(``python -m repro_torch.analysis``) and so their scoping matches its
layout (``__init__.py`` re-export modules are exempt from
unused-import, string-quoted annotations count as uses).

  * **unused-import** — an imported name never referenced by the module.
    A name counts as used when it appears as a ``Name`` node *or* as an
    identifier inside any string constant — the latter covers quoted
    annotations (``"collections.OrderedDict[QueryKey, ...]"``) and
    ``__all__`` entries.  ``from __future__`` imports and ``__init__.py``
    files (re-export surfaces) are exempt.
  * **mutable-default** — a ``list``/``dict``/``set`` literal (or
    constructor call) as a parameter default: shared across calls,
    a classic aliasing bug.
  * **bare-except** — ``except:`` with no exception class swallows
    ``KeyboardInterrupt``/``SystemExit``; name the exceptions (or
    ``BaseException`` when the breadth is deliberate).
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, Set, Tuple

from ..framework import Finding, LintPass, SourceFile

_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")

_HYGIENE_SCOPE = ("src/repro_torch/*.py", "chip_smoke.py")


def _used_names(sf: SourceFile) -> Set[str]:
    """Every identifier the module references: Name nodes plus the
    identifiers inside string constants (quoted annotations, __all__)."""
    used: Set[str] = set()
    for node in sf.nodes:
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            used.update(_IDENT.findall(node.value))
    return used


class UnusedImportPass(LintPass):
    """Imports never referenced in the module body."""

    name = "unused-import"
    description = ("imported names are referenced (Name nodes or quoted "
                   "annotations); __init__.py re-export modules exempt")
    scope = _HYGIENE_SCOPE

    def applies_to(self, rel: str) -> bool:
        if rel.rsplit("/", 1)[-1] == "__init__.py":
            return False
        return super().applies_to(rel)

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        imported: Dict[str, Tuple[int, str]] = {}
        for node in sf.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    imported[bound] = (node.lineno, alias.name)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    bound = alias.asname or alias.name
                    imported[bound] = (node.lineno, alias.name)
        used = _used_names(sf)
        for bound, (lineno, target) in sorted(imported.items(),
                                              key=lambda kv: kv[1][0]):
            if bound not in used:
                yield self.finding(sf, lineno, (
                    f"'{bound}' imported but never used"))


class MutableDefaultPass(LintPass):
    """list/dict/set literals (or constructors) as parameter defaults."""

    name = "mutable-default"
    description = ("no mutable default arguments (list/dict/set literal "
                   "or constructor) — defaults are shared across calls")
    scope = _HYGIENE_SCOPE

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        for node in sf.nodes:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]
            for dflt in defaults:
                if self._is_mutable(dflt):
                    yield self.finding(sf, dflt, (
                        f"mutable default argument in {node.name} — one "
                        f"shared object across every call; default to "
                        f"None and construct inside"))

    @staticmethod
    def _is_mutable(node: ast.AST) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            return True
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("list", "dict", "set"))


class BareExceptPass(LintPass):
    """``except:`` clauses with no exception class."""

    name = "bare-except"
    description = ("no bare 'except:' — it swallows KeyboardInterrupt/"
                   "SystemExit; name the exceptions")
    scope = _HYGIENE_SCOPE

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        for node in sf.nodes:
            if isinstance(node, ast.ExceptHandler) and node.type is None:
                yield self.finding(sf, node, (
                    "bare 'except:' swallows KeyboardInterrupt/SystemExit "
                    "— name the exceptions (BaseException if the breadth "
                    "is deliberate)"))


PASSES = [UnusedImportPass(), MutableDefaultPass(), BareExceptPass()]
