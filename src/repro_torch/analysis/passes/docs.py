"""docstring-coverage + doc-links: the documentation gates (DESIGN.md §11).

``repro``'s two rule families, unchanged in meaning, over the port:

  * **docstring-coverage** — the public surface of the audited modules
    (the port's ``serving/*.py``, ``core/batch.py`` and
    ``core/sharing.py``) is fully documented: module docstring, public
    classes, public functions/methods (nested defs excluded, mirroring
    ``interrogate``).  Each missing docstring is its own finding.  Each
    audited module's docstring must also carry its ``DESIGN.md §N``
    anchor, so every public module is reachable from the design doc.
  * **doc-links** — every ``DESIGN.md §N`` anchor spelled in a walked
    file of the port or in the README's ``PyTorch/CUDA port`` section
    names a section that exists, and every relative markdown link in
    that section points at a real file.  ``DESIGN.md`` is the JAX
    package's design document; the port gains no section of its own
    there, so its anchors name ``repro``'s sections.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator, List, Tuple

from ..framework import Finding, LintContext, LintPass, SourceFile

#: the audited set: the serving surface + the batch engine it fronts
AUDITED_SCOPE = (
    "src/repro_torch/serving/*.py",
    "src/repro_torch/core/batch.py",
    "src/repro_torch/core/sharing.py",
)

_ANCHOR = re.compile(r"DESIGN\.md §(\d+)(?:-(\d+))?")
_MD_LINK = re.compile(r"\]\(([^)]+)\)")
_SECTION = re.compile(r"^## §(\d+)", re.MULTILINE)

#: the README section that documents the port, and whose anchors and
#: relative links must resolve
README = "README.md"
PORT_HEADING = "## PyTorch/CUDA port"
DESIGN = "DESIGN.md"


def public_docstring_slots(
        tree: ast.Module) -> Iterator[Tuple[str, int, bool]]:
    """Yield (qualname, line, has_docstring) for the module, public
    classes and public functions/methods — nested defs excluded, like
    ``interrogate``."""
    yield "<module>", 1, ast.get_docstring(tree) is not None
    for node in tree.body:
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            yield node.name, node.lineno, ast.get_docstring(node) is not None
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and not sub.name.startswith("_"):
                    yield (f"{node.name}.{sub.name}", sub.lineno,
                           ast.get_docstring(sub) is not None)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not node.name.startswith("_"):
            yield node.name, node.lineno, ast.get_docstring(node) is not None


def port_section(readme: str) -> List[Tuple[int, str]]:
    """The (line number, line) pairs of the README's port section: from
    its heading to the next ``## `` heading."""
    out: List[Tuple[int, str]] = []
    inside = False
    for ln, line in enumerate(readme.splitlines(), 1):
        if line.startswith("## "):
            inside = line.strip() == PORT_HEADING
        if inside:
            out.append((ln, line))
    return out


def _relative_target(link: str) -> str:
    """A markdown link's file part, or "" for an external or in-page
    link."""
    target = link.split("#")[0].strip()
    if target.startswith(("http://", "https://", "mailto:")):
        return ""
    return target


def documents(root: Path) -> List[str]:
    """The repo-relative documents that doc-links reads under ``root``:
    DESIGN.md, the README, and each relative link target of the README's
    port section."""
    out = [DESIGN, README]
    readme = root / README
    if readme.exists():
        for _, line in port_section(readme.read_text(encoding="utf-8")):
            for m in _MD_LINK.finditer(line):
                target = _relative_target(m.group(1))
                if target and target not in out:
                    out.append(target)
    return out


def _dangling(line: str, sections: set) -> Iterator[int]:
    """The section numbers a line's anchors name that do not exist."""
    for m in _ANCHOR.finditer(line):
        lo = int(m.group(1))
        hi = int(m.group(2)) if m.group(2) else lo
        yield from (n for n in range(lo, hi + 1) if n not in sections)


class DocstringCoveragePass(LintPass):
    """Full public-surface docstring coverage on the audited modules,
    plus the per-module DESIGN.md anchor."""

    name = "docstring-coverage"
    description = ("every public slot in serving/*.py, core/batch.py and "
                   "core/sharing.py carries a docstring, and each module "
                   "docstring anchors into DESIGN.md §N")
    scope = AUDITED_SCOPE

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        for qualname, line, has_doc in public_docstring_slots(tree):
            if not has_doc:
                yield self.finding(sf, line, (
                    f"public slot {qualname} has no docstring — the "
                    f"audited surface is documented in full"))
        doc = ast.get_docstring(tree) or ""
        if doc and not _ANCHOR.search(doc):
            yield self.finding(sf, 1, (
                "module docstring lacks a 'DESIGN.md §N' anchor — every "
                "audited module is reachable from the design doc"))


class DocLinksPass(LintPass):
    """Cross-file link integrity: §N anchors resolve, relative links in
    the README's port section point at real files."""

    name = "doc-links"
    description = ("DESIGN.md §N references in the port's files and the "
                   "README's port section resolve to real sections; that "
                   "section's relative markdown links resolve to files")
    # anchors may be spelled anywhere the walk visits
    scope = ("src/repro_torch/*.py", "chip_smoke.py", "tests/test_torch_*.py",
             "tests/torch_*.py")

    def check_aggregate(self, ctx: LintContext,
                        files: List[SourceFile]) -> Iterator[Finding]:
        design = ctx.read(DESIGN) or ""
        sections = {int(m) for m in _SECTION.findall(design)}
        if not sections:
            yield Finding(rule=self.name, path=DESIGN, line=0,
                          message="DESIGN.md defines no '## §N' sections")
            return
        for sf in files:
            for ln, line in enumerate(sf.lines, 1):
                for n in _dangling(line, sections):
                    yield self.finding(sf, ln, (
                        f"dangling reference DESIGN.md §{n} — no such "
                        f"section"))
        section = port_section(ctx.read(README) or "")
        if not section:
            yield Finding(rule=self.name, path=README, line=0,
                          message=f"{README} has no '{PORT_HEADING}' "
                                  f"section")
        for ln, line in section:
            for n in _dangling(line, sections):
                yield Finding(rule=self.name, path=README, line=ln,
                              message=(f"dangling reference DESIGN.md §{n} "
                                       f"— no such section"))
            for m in _MD_LINK.finditer(line):
                target = _relative_target(m.group(1))
                if not target:
                    continue
                if not (ctx.root / target).exists():
                    yield Finding(rule=self.name, path=README, line=ln,
                                  message=(f"broken relative link "
                                           f"({m.group(1)}) — target does "
                                           f"not exist"))


PASSES = [DocstringCoveragePass(), DocLinksPass()]
