"""repro-torch-lint pass framework: the port's copy of ``repro``'s
(DESIGN.md §11).

The port keeps conventions that a test can only sample: no JAX and no
``repro`` behind its imports, a plain version beside every CUDA kernel
and no fallback that hides a kernel, kernels built at first use and not
at import, float64 rank costs, deadline checks in the emitting loops,
no blocking call on the serving event loop.  Each is a syntactic
property of the source tree, so each is a static pass over the AST,
run the same way on the CPU and on the GPU machine:

    python -m repro_torch.analysis --strict

This module is the machinery every pass shares, with ``repro``'s names
and semantics: ``SourceFile`` (text, parsed AST, suppression comments),
``Finding`` (one diagnostic), ``LintPass`` (the per-file and aggregate
hooks), ``LintContext`` (the selected file set), and ``run_passes``
(collect, drop the suppressed, report).  The passes live in
``repro_torch.analysis.passes``, one module a rule family.  It imports
nothing of ``repro``, ``torch`` or ``jax``.

Suppressions are explicit and greppable, with the port's own token so
that neither tool reads the other's: a trailing
``# repro-torch-lint: disable=<rule>[,<rule>...]`` comment silences
matching findings on its line only, and a
``# repro-torch-lint: disable-file=<rule>`` comment anywhere in the
file silences the whole file for that rule; ``all`` matches every rule.
Suppressed findings are counted in the summary line, so none hides
silently.
"""
from __future__ import annotations

import ast
import dataclasses
import fnmatch
import json
import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

#: severity levels; ``--strict`` fails on both, the default exit code
#: only on errors.
SEVERITIES = ("error", "warning")

#: the files a repo-wide walk visits: the port, the GPU smoke script and
#: the port's tests and their harnesses
WALK_PATTERNS = ("src/repro_torch/**/*.py", "chip_smoke.py",
                 "tests/test_torch_*.py", "tests/torch_*.py")
#: lint fixtures are deliberately bad snippets: never walk them
WALK_EXCLUDE = ("tests/fixtures",)

_SUPPRESS_LINE = re.compile(r"#\s*repro-torch-lint:\s*disable=([\w,\-]+)")
_SUPPRESS_FILE = re.compile(
    r"#\s*repro-torch-lint:\s*disable-file=([\w,\-]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: ``rule`` names the pass (and the suppression
    token), ``path`` is repo-relative, ``line`` is 1-based (0 for
    whole-file findings)."""
    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"

    def render(self) -> str:
        """The human one-liner: ``path:line: [rule] message``."""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> Dict[str, object]:
        """The JSON-output shape (``repro``'s keys)."""
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "severity": self.severity}


class SourceFile:
    """One file under lint: text, lines, lazily parsed AST, and the
    parsed suppression comments.  ``rel`` is the repo-relative posix
    path every scope pattern and finding uses."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.text = path.read_text(encoding="utf-8")
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.Module] = None
        self._parse_error: Optional[SyntaxError] = None
        self._nodes: Optional[List[ast.AST]] = None
        self._line_disables: Dict[int, Set[str]] = {}
        self._file_disables: Set[str] = set()
        for ln, line in enumerate(self.lines, 1):
            m = _SUPPRESS_LINE.search(line)
            if m:
                self._line_disables[ln] = set(m.group(1).split(","))
            m = _SUPPRESS_FILE.search(line)
            if m:
                self._file_disables |= set(m.group(1).split(","))

    @property
    def tree(self) -> Optional[ast.Module]:
        """The parsed module, or None when the file does not parse (the
        runner reports a ``parse-error`` finding instead)."""
        if self._tree is None and self._parse_error is None:
            try:
                self._tree = ast.parse(self.text)
            except SyntaxError as exc:
                self._parse_error = exc
        return self._tree

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree in ``ast.walk`` order, walked once and
        kept: each pass scans the whole module."""
        if self._nodes is None:
            tree = self.tree
            self._nodes = [] if tree is None else list(ast.walk(tree))
        return self._nodes

    @property
    def parse_error(self) -> Optional[SyntaxError]:
        """The SyntaxError raised while parsing, if any."""
        self.tree  # noqa: B018 — force the lazy parse
        return self._parse_error

    def suppressed(self, line: int, rule: str) -> bool:
        """True when a finding of ``rule`` at ``line`` is silenced by a
        line- or file-level ``# repro-torch-lint: disable`` comment."""
        if self._file_disables & {rule, "all"}:
            return True
        return bool(self._line_disables.get(line, set()) & {rule, "all"})


@dataclasses.dataclass
class LintContext:
    """What one lint run sees: the repo root and the selected files.
    ``explicit`` is True when the caller named files on the command
    line — scope patterns are then bypassed, so a fixture snippet can
    be linted as if it lived in the directory its rule guards."""
    root: Path
    files: List[SourceFile]
    explicit: bool = False

    def files_for(self, lint_pass: "LintPass") -> List[SourceFile]:
        """The files this pass examines: everything (explicit mode) or
        the scope-pattern matches."""
        if self.explicit:
            return self.files
        return [sf for sf in self.files if lint_pass.applies_to(sf.rel)]

    def read(self, rel: str) -> Optional[str]:
        """Text of a repo file by relative path, None if absent."""
        p = self.root / rel
        return p.read_text(encoding="utf-8") if p.exists() else None


class LintPass:
    """Base class for one rule family.

    Subclasses set ``name`` (the rule id and suppression token),
    ``description`` (one line for ``--list-rules``) and ``scope``
    (repo-relative fnmatch patterns, where ``*`` also matches ``/``),
    then implement ``check`` for per-file rules and/or
    ``check_aggregate`` for rules that need the whole file set at once.
    Findings must use the pass's own ``name`` as rule so suppression
    comments resolve.
    """

    name: str = "abstract"
    description: str = ""
    scope: Tuple[str, ...] = ()

    def applies_to(self, rel: str) -> bool:
        """Scope test for one repo-relative path."""
        return any(fnmatch.fnmatch(rel, pat) for pat in self.scope)

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        """Per-file hook; default: no findings."""
        return iter(())

    def check_aggregate(self, ctx: LintContext,
                        files: List[SourceFile]) -> Iterator[Finding]:
        """Whole-file-set hook (``files`` already scope-filtered);
        default: no findings."""
        return iter(())

    def finding(self, sf: SourceFile, node_or_line, message: str,
                severity: str = "error") -> Finding:
        """Build a Finding anchored at an AST node or a line number."""
        line = getattr(node_or_line, "lineno", node_or_line)
        return Finding(rule=self.name, path=sf.rel, line=int(line),
                       message=message, severity=severity)


def dotted_name(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain (``torch.cuda.synchronize``
    -> 'torch.cuda.synchronize'); empty for any other shape."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


def repo_root(start: Optional[Path] = None) -> Path:
    """The repository root: the nearest ancestor holding
    ``src/repro_torch`` (from any cwd inside the tree)."""
    here = (start or Path(__file__)).resolve()
    for cand in (here, *here.parents):
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    raise RuntimeError("cannot locate repo root (no src/repro_torch "
                       "ancestor)")


def walk_repo(root: Path) -> List[SourceFile]:
    """The default file set: every ``*.py`` that ``WALK_PATTERNS``
    match, minus the excluded fixture directories, sorted by relative
    path."""
    seen: Dict[str, Path] = {}
    for pattern in WALK_PATTERNS:
        for path in root.glob(pattern):
            rel = path.relative_to(root).as_posix()
            if not path.is_file() or any(
                    rel.startswith(excl + "/") or rel == excl
                    for excl in WALK_EXCLUDE):
                continue
            seen[rel] = path
    return [SourceFile(seen[rel], rel) for rel in sorted(seen)]


@dataclasses.dataclass
class LintReport:
    """One run's outcome: surviving findings, the suppressed count, and
    the file count examined."""
    findings: List[Finding]
    suppressed: int
    files: int

    @property
    def errors(self) -> List[Finding]:
        """The error-severity subset (the default-mode exit gate)."""
        return [f for f in self.findings if f.severity == "error"]

    def exit_code(self, strict: bool = False) -> int:
        """0 when clean; 1 on any error, or on any finding at all under
        ``--strict``."""
        gate = self.findings if strict else self.errors
        return 1 if gate else 0

    def render(self) -> str:
        """Human output: one line per finding plus the summary."""
        lines = [f.render() for f in self.findings]
        lines.append(f"repro-torch-lint: {len(self.findings)} finding(s) "
                     f"({self.suppressed} suppressed) "
                     f"across {self.files} file(s)")
        return "\n".join(lines)

    def render_json(self) -> str:
        """Machine output: findings + counters as one JSON object."""
        return json.dumps({
            "findings": [f.to_json() for f in self.findings],
            "suppressed": self.suppressed, "files": self.files}, indent=2)


def run_passes(passes: Sequence[LintPass], root: Optional[Path] = None,
               paths: Optional[Sequence[Path]] = None) -> LintReport:
    """Run ``passes`` over the repo walk (or over ``paths``, bypassing
    scope patterns) and fold the results into a LintReport.

    Suppression comments are applied here — passes yield every finding
    they see and never read the comments themselves — so the counting
    (and the policy) lives in exactly one place.
    """
    root = root or repo_root()
    if paths is not None:
        files = [SourceFile(Path(p), Path(p).resolve().relative_to(
            root).as_posix() if Path(p).resolve().is_relative_to(root)
            else Path(p).name) for p in paths]
        ctx = LintContext(root=root, files=files, explicit=True)
    else:
        ctx = LintContext(root=root, files=walk_repo(root))

    findings: List[Finding] = []
    suppressed = 0
    by_rel = {sf.rel: sf for sf in ctx.files}
    for sf in ctx.files:
        if sf.parse_error is not None:
            findings.append(Finding(
                rule="parse-error", path=sf.rel,
                line=sf.parse_error.lineno or 0,
                message=f"file does not parse: {sf.parse_error.msg}"))
    for lint_pass in passes:
        selected = ctx.files_for(lint_pass)
        raw: List[Finding] = []
        for sf in selected:
            if sf.parse_error is None:
                raw.extend(lint_pass.check(sf))
        raw.extend(lint_pass.check_aggregate(ctx, selected))
        for f in raw:
            sf = by_rel.get(f.path)
            if sf is not None and sf.suppressed(f.line, f.rule):
                suppressed += 1
            else:
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return LintReport(findings=findings, suppressed=suppressed,
                      files=len(ctx.files))
