"""Harness for tests/test_torch_examples*.py: ``repro``'s example scripts
and the port's ``repro_torch.examples`` modules run side by side on the
CPU, their printed lines compared.

``repro``'s script runs through ``runpy.run_path`` as ``__main__``
(JAX on the CPU); the port's ``main(["--device", "cpu"])`` in this
process.  Numbers that carry a time unit (``ms``, ``s``, ``q/s``) are
masked, with the spaces before them (the scripts pad times to a
width).  A test leaves out the lines whose values follow the wall clock
by their prefix.
"""
import contextlib
import importlib
import io
import re
import runpy
from pathlib import Path

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

_TIMED = re.compile(r"\s*\d[\d,]*(?:\.\d+)?\s*(ms|s|q/s)\b")


def masked(text: str, skip=()) -> list:
    """``text``'s lines with timed numbers masked, less those that start
    with a prefix in ``skip``."""
    skip = tuple(skip)
    return [_TIMED.sub(r" # \1", line) for line in text.splitlines()
            if not (skip and line.startswith(skip))]


def run_repro(name: str) -> str:
    """What ``repro``'s ``examples/<name>.py`` prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return out.getvalue()


def run_port(name: str, argv=("--device", "cpu")):
    """(what the port's ``repro_torch.examples.<name>`` prints, the dict
    its ``main`` returns)."""
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        values = mod.main(list(argv))
    return out.getvalue(), values


def assert_same_lines(name: str, skip=()):
    """The port's example prints ``repro``'s lines (masked, less the
    lines ``skip`` names by prefix); returns (the port's compared lines,
    its returned dict)."""
    want = masked(run_repro(name), skip)
    text, values = run_port(name)
    got = masked(text, skip)
    assert got == want, f"{name}: {got} != {want}"
    assert got, f"{name} printed nothing"
    return got, values
