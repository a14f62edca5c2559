"""repro-torch-lint, the port's static analysis, against ``repro``'s
(DESIGN.md §11).

* Paired fixtures: every port rule flags its known-bad snippet under
  ``tests/fixtures/repro_torch_lint/`` and passes its known-good twin.
* Parity: on every fixture of ``tests/fixtures/repro_lint/`` (read, not
  edited) and of the port's own, the eight rules whose meaning carries
  over give the same ``(rule, line, severity)`` findings and the same
  suppressed count under ``repro.analysis`` and under the port's pass
  (each tool reading the fixture with its own suppression token).  The
  torch-only fixtures are flagged by the port beyond ``repro``.
* Port-only clauses: each is shown on a copy of a real port module with
  one edit, which the pass flags while it passes the unedited copy.
* Framework and CLI: suppression semantics, exit codes and output
  shape, against ``repro``'s CLI on the same fixture.
* The whole tree lints clean, every rule is in the README's port
  section, and the analysis imports neither ``torch``, ``jax`` nor
  anything of ``repro``.
"""
import ast
import importlib.util
import json
import os
import subprocess
import shutil
import sys
from collections import Counter
from pathlib import Path

import pytest

from repro.analysis import PASS_BY_NAME as REPRO_PASS_BY_NAME
from repro.analysis import run_passes as repro_run_passes
from repro_torch.analysis import (ALL_PASSES, PASS_BY_NAME, lint_repo,
                                  run_passes, walk_repo)
from repro_torch.analysis.passes.docs import documents, port_section

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FIXTURES = REPO / "tests" / "fixtures" / "repro_torch_lint"
REPRO_FIXTURES = REPO / "tests" / "fixtures" / "repro_lint"

# rule name -> the fixture stems of its bad/good pairs
RULE_FIXTURES = {
    "kernel-contract": ("kernel_contract",),
    "compat-boundary": ("compat_boundary",),
    "async-safety": ("async_safety", "async_safety_torch"),
    "deadline-hook": ("deadline_hook",),
    "rank-cost-dtype": ("rank_dtype", "rank_dtype_torch"),
    "docstring-coverage": ("docstring_coverage",),
    "doc-links": ("doc_links",),
    "unused-import": ("unused_import",),
    "mutable-default": ("mutable_default",),
    "bare-except": ("bare_except",),
}
PAIRS = [(rule, stem) for rule, stems in sorted(RULE_FIXTURES.items())
         for stem in stems]

# the rules whose meaning carries over from repro unchanged
CARRIED = ("unused-import", "mutable-default", "bare-except",
           "deadline-hook", "rank-cost-dtype", "async-safety",
           "docstring-coverage", "doc-links")
TOKENS = ("# repro-lint:", "# repro-torch-lint:")


def run_rule(rule, *paths):
    """One port rule over explicit paths (scope patterns bypassed)."""
    return run_passes([PASS_BY_NAME[rule]], paths=list(paths))


def keys(report):
    return sorted((f.rule, f.line, f.severity) for f in report.findings)


# ---------------------------------------------------------------------------
# paired fixtures
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule,stem", PAIRS)
def test_bad_fixture_is_flagged(rule, stem):
    report = run_rule(rule, FIXTURES / f"{stem}_bad.py")
    assert report.findings, f"{rule} missed {stem}_bad.py"
    assert all(f.rule == rule for f in report.findings)
    assert report.exit_code() == 1


@pytest.mark.parametrize("rule,stem", PAIRS)
def test_good_fixture_is_clean(rule, stem):
    report = run_rule(rule, FIXTURES / f"{stem}_good.py")
    assert not report.findings, "\n".join(f.render()
                                          for f in report.findings)
    assert report.exit_code(strict=True) == 0


def test_kernel_contract_bad_covers_every_clause():
    report = run_rule("kernel-contract",
                      FIXTURES / "kernel_contract_bad.py")
    messages = "\n".join(f.message for f in report.findings)
    for clause in ("_build.load(...) at import", "triton imported",
                   "scale launches a kernel but has no branch",
                   "scale_plain called in an exception handler",
                   "the 'cpu' device named in an exception handler",
                   "PAD declared", "integer dtype long in index",
                   "integer dtype int64 in index"):
        assert clause in messages, clause
    assert len(report.findings) == 8


def test_compat_boundary_bad_covers_every_clause():
    report = run_rule("compat-boundary",
                      FIXTURES / "compat_boundary_bad.py")
    messages = "\n".join(f.message for f in report.findings)
    for clause in ("'jax'", "'jaxlib.xla_extension'", "'repro.core'",
                   "'repro.kernels.ops'", "torch.cuda.is_available()",
                   "init_process_group(...)", "init_device_mesh(...)"):
        assert clause in messages, clause
    assert len(report.findings) == 7


# ---------------------------------------------------------------------------
# parity with repro on the rules that carry over
# ---------------------------------------------------------------------------


def _with_token(text, token):
    """``text`` as the tool with suppression ``token`` should read it:
    the two tools' tokens swapped when ``token`` is the other one."""
    if token == TOKENS[1]:
        return text
    return (text.replace(TOKENS[0], "\0").replace(TOKENS[1], TOKENS[0])
            .replace("\0", TOKENS[1]))


def _pair_copies(tmp_path, fixture):
    """(repro's copy, the port's copy) of ``fixture``, each with the
    suppression comments of the other tool's fixture set in its own
    token, under the fixture's name."""
    text = fixture.read_text()
    if fixture.parent == REPRO_FIXTURES:
        port_text, repro_text = _with_token(text, TOKENS[0]), text
    else:
        port_text, repro_text = text, _with_token(text, TOKENS[0])
    out = []
    for side, body in (("repro", repro_text), ("port", port_text)):
        (tmp_path / side).mkdir()
        path = tmp_path / side / fixture.name
        path.write_text(body)
        out.append(path)
    return out


PARITY_FIXTURES = sorted(
    [p for p in REPRO_FIXTURES.glob("*.py")]
    + [p for p in FIXTURES.glob("*.py") if "_torch_" not in p.name])


@pytest.mark.parametrize(
    "fixture", PARITY_FIXTURES,
    ids=[f"{p.parent.name}/{p.name}" for p in PARITY_FIXTURES])
def test_carried_rules_match_repro(tmp_path, fixture):
    repro_copy, port_copy = _pair_copies(tmp_path, fixture)
    for rule in CARRIED:
        theirs = repro_run_passes([REPRO_PASS_BY_NAME[rule]],
                                  paths=[repro_copy])
        ours = run_rule(rule, port_copy)
        assert keys(ours) == keys(theirs), rule
        assert ours.suppressed == theirs.suppressed, rule


@pytest.mark.parametrize("stem,rule", [("rank_dtype_torch",
                                        "rank-cost-dtype"),
                                       ("async_safety_torch",
                                        "async-safety")])
def test_torch_spellings_are_flagged_beyond_repro(stem, rule):
    bad = FIXTURES / f"{stem}_bad.py"
    theirs = keys(repro_run_passes([REPRO_PASS_BY_NAME[rule]],
                                   paths=[bad]))
    ours = keys(run_rule(rule, bad))
    assert not Counter(theirs) - Counter(ours)
    extra = sorted((Counter(ours) - Counter(theirs)).elements())
    lines = bad.read_text().splitlines()
    torch_only = {"rank-cost-dtype": ("torch.float)", ".half()",
                                      ".float()", "torch.half"),
                  "async-safety": (".synchronize()",)}[rule]
    flagged = [ln for _, ln, _ in extra]
    want = [i for i, line in enumerate(lines, 1)
            if any(s in line.split("#")[0] for s in torch_only)]
    assert flagged == want and want


# ---------------------------------------------------------------------------
# port-only clauses, each on a copy of a real port module with one edit
# ---------------------------------------------------------------------------

EDITS = {
    "build_at_import": (
        "kernel-contract", "kernels/semiring_spmm.py",
        "# kernel launches since process start",
        '_LIB = _build.load("semiring")\n\n'
        "# kernel launches since process start",
        '_build.load(...) at import'),
    "fallback_to_plain": (
        "kernel-contract", "kernels/semiring_spmm.py",
        "    return _minplus_cuda(adj, dist, 0, 1, inf, transposed)\n",
        "    try:\n"
        "        return _minplus_cuda(adj, dist, 0, 1, inf, transposed)\n"
        "    except RuntimeError:\n"
        "        return minplus_spmv_plain(adj, dist, inf=inf,\n"
        "                                  transposed=transposed)\n",
        "minplus_spmv_plain called in an exception handler"),
    "plain_renamed_away": (
        "kernel-contract", "kernels/semiring_spmm.py",
        "counting_spmm_plain", "counting_spmm_ref",
        "counting_spmm launches a kernel but has no branch"),
    "import_jax": (
        "compat-boundary", "kernels/ops.py",
        "import numpy as np\n", "import jax\nimport numpy as np\n",
        "import of 'jax'"),
    "cuda_probe": (
        "compat-boundary", "core/enumerate.py",
        "\n\ndef ", "\n\ndef _on_card():\n"
                   "    return torch.cuda.is_available()\n\n\ndef ",
        "torch.cuda.is_available() outside compat.py"),
    "float_cast": (
        "rank-cost-dtype", "core/rank.py",
        "costs = np.zeros(paths.shape[0], dtype=np.float64)",
        "costs = torch.zeros(paths.shape[0]).float()",
        ".float() casts to a narrow float"),
    "sync_in_async": (
        "async-safety", "serving/async_server.py",
        "        self._closing = False\n        self._wakeup",
        "        torch.cuda.synchronize()\n"
        "        self._closing = False\n        self._wakeup",
        "torch.cuda.synchronize() inside async def start"),
}


@pytest.mark.parametrize("case", sorted(EDITS))
def test_port_only_clause_on_an_edited_copy(tmp_path, case):
    rule, rel, old, new, message = EDITS[case]
    text = (PORT / rel).read_text()
    assert old in text, f"{rel} no longer holds the text this case edits"
    name = Path(rel).name
    (tmp_path / "orig").mkdir()
    (tmp_path / "edit").mkdir()
    (tmp_path / "orig" / name).write_text(text)
    count = -1 if case == "plain_renamed_away" else 1
    (tmp_path / "edit" / name).write_text(text.replace(old, new, count))
    before = run_rule(rule, tmp_path / "orig" / name)
    assert not before.findings, "\n".join(f.render()
                                          for f in before.findings)
    after = run_rule(rule, tmp_path / "edit" / name)
    assert any(message in f.message for f in after.findings), \
        "\n".join(f.render() for f in after.findings)


def _build_copy(tmp_path, edit=None):
    """A copy of kernels/_build.py beside a csrc/ that holds every real
    source's name, after ``edit(text, csrc)``."""
    kdir = tmp_path / "kernels"
    (kdir / "csrc").mkdir(parents=True)
    for cu in (PORT / "kernels" / "csrc").glob("*.cu"):
        (kdir / "csrc" / cu.name).write_text("")
    text = (PORT / "kernels" / "_build.py").read_text()
    if edit is not None:
        text = edit(text, kdir / "csrc")
    (kdir / "_build.py").write_text(text)
    return run_rule("kernel-contract", kdir / "_build.py")


def _drop_entry(text, csrc):
    old = '    "semiring": "semiring.cu",\n'
    assert old in text
    return text.replace(old, "")


def _extra_source(text, csrc):
    (csrc / "scan.cu").write_text("")
    return text


def _other_arch(text, csrc):
    assert "sm_90a" in text
    return text.replace("compute_90a,code=sm_90a", "compute_80,code=sm_80")


@pytest.mark.parametrize("edit,message", [
    (_drop_entry, "csrc/semiring.cu is not in SOURCES"),
    (_extra_source, "csrc/scan.cu is not in SOURCES"),
    (_other_arch, "NVCC_FLAGS does not target sm_90a"),
], ids=["missing_from_sources", "new_cu_file", "not_sm90a"])
def test_build_list_covers_csrc(tmp_path, edit, message):
    assert not _build_copy(tmp_path / "orig").findings
    after = _build_copy(tmp_path / "edit", edit)
    assert [f.message for f in after.findings
            if message in f.message], after.render()


def test_suppressions_in_the_port_hold_findings(tmp_path):
    """The port's suppressions silence real findings: stripped of its
    comments, a copy of frontier_expand.py is flagged twice, once for
    each of K5's two table entries (no plain branch: only the kernels
    read a table of device pointers)."""
    text = (PORT / "kernels" / "frontier_expand.py").read_text()
    token = "  # repro-torch-lint: disable=kernel-contract"
    assert text.count(token) == 2
    plain = tmp_path / "frontier_expand.py"
    plain.write_text(text.replace(token, ""))
    report = run_rule("kernel-contract", plain)
    assert [f.message.split(" ")[0] for f in report.findings] == [
        "frontier_fused_masks_table", "frontier_fused_hop"]
    kept = run_rule("kernel-contract", PORT / "kernels" /
                    "frontier_expand.py")
    assert not kept.findings and kept.suppressed == 2


# ---------------------------------------------------------------------------
# framework: suppression comments, parse errors
# ---------------------------------------------------------------------------


def test_line_suppressions_are_honored_and_counted():
    demo = FIXTURES / "suppression_demo.py"
    ours = run_rule("unused-import", demo)
    # ctypes (rule named) and json (all) suppressed; os carries repro's
    # token, which the port does not read; sys has none
    assert [f.message for f in ours.findings] == [
        "'os' imported but never used", "'sys' imported but never used"]
    assert ours.suppressed == 2
    theirs = repro_run_passes([REPRO_PASS_BY_NAME["unused-import"]],
                              paths=[demo])
    assert len(theirs.findings) == 3 and theirs.suppressed == 1


def test_file_suppression_silences_whole_file():
    demo = FIXTURES / "suppression_file_demo.py"
    ours = run_rule("unused-import", demo)
    assert not ours.findings and ours.suppressed == 3
    theirs = repro_run_passes([REPRO_PASS_BY_NAME["unused-import"]],
                              paths=[demo])
    assert len(theirs.findings) == 3 and theirs.suppressed == 0


def test_repro_suppressions_are_not_read():
    report = run_rule("unused-import",
                      REPRO_FIXTURES / "suppression_file_demo.py")
    assert len(report.findings) == 3 and report.suppressed == 0


def test_suppression_is_rule_specific(tmp_path):
    src = tmp_path / "mod.py"
    src.write_text('"""Doc."""\n'
                   "import os  # repro-torch-lint: disable=bare-except\n")
    assert len(run_rule("unused-import", src).findings) == 1


def test_parse_error_is_reported(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    report = run_rule("bare-except", bad)
    assert [f.rule for f in report.findings] == ["parse-error"]
    assert report.exit_code() == 1


def test_walk_covers_the_port_and_skips_fixtures():
    rels = [sf.rel for sf in walk_repo(REPO)]
    assert rels == sorted(set(rels))
    for rel in ("chip_smoke.py", "src/repro_torch/compat.py",
                "src/repro_torch/kernels/ops.py",
                "src/repro_torch/analysis/framework.py",
                "tests/test_torch_cuda.py", "tests/torch_mesh_parity.py"):
        assert rel in rels, rel
    assert not [r for r in rels if r.startswith(("tests/fixtures/",
                                                 "src/repro/"))]
    assert "tests/test_analysis.py" not in rels


# ---------------------------------------------------------------------------
# CLI, against repro's on the same fixture
# ---------------------------------------------------------------------------


def _cli(module, *argv):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", module, *argv],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)


def _both(*argv):
    return (_cli("repro.analysis", *argv),
            _cli("repro_torch.analysis", *argv))


def test_cli_exit_codes_and_json_match_repro():
    bad = str(REPRO_FIXTURES / "mutable_default_bad.py")
    good = str(REPRO_FIXTURES / "mutable_default_good.py")
    theirs, ours = _both("--json", "--rules", "mutable-default,bare-except",
                         bad)
    assert ours.returncode == theirs.returncode == 1
    a, b = json.loads(theirs.stdout), json.loads(ours.stdout)
    assert set(a) == set(b) == {"findings", "suppressed", "files"}
    assert [set(f) for f in a["findings"]] == [set(f) for f in b["findings"]]
    assert [(f["rule"], f["line"], f["severity"]) for f in a["findings"]] \
        == [(f["rule"], f["line"], f["severity"]) for f in b["findings"]]
    assert (a["suppressed"], a["files"]) == (b["suppressed"], b["files"])
    theirs, ours = _both("--strict", "--rules", "mutable-default", good)
    assert ours.returncode == theirs.returncode == 0
    assert ours.stdout.startswith("repro-torch-lint: 0 finding(s)")


def test_cli_text_output_and_unknown_rule():
    bad = str(FIXTURES / "unused_import_bad.py")
    theirs, ours = _both("--rules", "unused-import", bad)
    assert ours.returncode == theirs.returncode == 1
    lines = ours.stdout.strip().splitlines()
    assert len(lines) == 6 and all("[unused-import]" in ln
                                   for ln in lines[:5])
    assert lines[-1] == ("repro-torch-lint: 5 finding(s) (0 suppressed) "
                         "across 1 file(s)")
    assert [ln.split(":")[1] for ln in lines[:5]] == [
        ln.split(":")[1] for ln in theirs.stdout.strip().splitlines()[:5]]
    theirs, ours = _both("--rules", "no-such-rule")
    assert ours.returncode == theirs.returncode == 2
    assert "no-such-rule" in ours.stderr and not ours.stdout


def test_cli_list_rules_names_repro_rules():
    theirs, ours = _both("--list-rules")
    assert ours.returncode == theirs.returncode == 0
    names = [ln.split()[0] for ln in ours.stdout.splitlines()]
    assert names == [ln.split()[0] for ln in theirs.stdout.splitlines()]
    assert names == [p.name for p in ALL_PASSES]


def test_cli_strict_on_the_tree_imports_no_torch_jax_or_repro():
    code = ("import json, sys\n"
            "from repro_torch.analysis.__main__ import main\n"
            "rc = main(['--strict'])\n"
            "mods = sorted(m for m in sys.modules\n"
            "              if m.split('.')[0] in ('torch', 'jax', 'repro'))\n"
            "print(json.dumps({'rc': rc, 'mods': mods}))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"rc": 0, "mods": []}, proc.stdout


# ---------------------------------------------------------------------------
# the tree, the registry, the catalogue
# ---------------------------------------------------------------------------


def test_port_lints_clean():
    report = lint_repo()
    assert not report.findings, (
        "the port must lint clean (python -m repro_torch.analysis "
        "--strict):\n" + "\n".join(f.render() for f in report.findings))
    assert report.exit_code(strict=True) == 0
    assert report.files > 100


def test_registry_mirrors_repro():
    from repro import analysis as theirs
    import repro_torch.analysis as ours
    assert list(PASS_BY_NAME) == list(REPRO_PASS_BY_NAME)
    assert len(PASS_BY_NAME) == len(ALL_PASSES)
    assert ours.__all__ == theirs.__all__
    ref = REPO / "src" / "repro" / "analysis"
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref)
        assert (PORT / "analysis" / rel).is_file(), rel
    for p in ALL_PASSES:
        assert p.scope and p.description, p.name
        assert type(p).__name__ == type(REPRO_PASS_BY_NAME[p.name]).__name__


def test_every_rule_is_in_the_readme_port_section():
    section = "\n".join(line for _, line in port_section(
        (REPO / "README.md").read_text()))
    assert "python -m repro_torch.analysis --strict" in section
    assert "# repro-torch-lint: disable=" in section
    for p in ALL_PASSES:
        assert f"`{p.name}`" in section, p.name


def test_analysis_imports_only_the_standard_library():
    for path in sorted((PORT / "analysis").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                root = mod.split(".")[0]
                assert root == "__future__" \
                    or root in sys.stdlib_module_names, (path.name, mod)


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_lint", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_lint_phase(capsys):
    smoke = _load_chip_smoke()
    smoke.lint_phase()
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["phase"] == "lint" and line["findings"] == 0
    assert line["files"] > 100 and line["suppressed"] >= 4
    assert line["seconds"] > 0 and line["skipped"] == {}


def test_doc_links_documents():
    assert documents(REPO)[:2] == ["DESIGN.md", "README.md"]
    assert "PERF.md" in documents(REPO)
    assert all((REPO / d).exists() for d in documents(REPO))


def test_chip_smoke_lint_phase_without_documents(tmp_path, capsys):
    """A checkout of the program alone (no markdown): the phase skips
    doc-links, names what is missing, and still fails on a code fault,
    which is its one finding."""
    skip = shutil.ignore_patterns("__pycache__", "build")
    shutil.copytree(PORT, tmp_path / "src" / "repro_torch", ignore=skip)
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    (tmp_path / "tests").mkdir()
    for path in (REPO / "tests").glob("*torch_*.py"):
        shutil.copy(path, tmp_path / "tests" / path.name)
    assert run_passes([PASS_BY_NAME["doc-links"]], root=tmp_path).findings
    ops = tmp_path / "src" / "repro_torch" / "kernels" / "ops.py"
    ops.write_text(ops.read_text() + "\nimport jax\nJAX = jax\n")
    smoke = _load_chip_smoke()
    smoke.ROOT = tmp_path
    with pytest.raises(SystemExit):
        smoke.lint_phase()
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["findings"] == 1
    assert line["skipped"] == {"doc-links": ["DESIGN.md", "README.md"]}
    assert "kernels/ops.py" in err and "[compat-boundary]" in err
