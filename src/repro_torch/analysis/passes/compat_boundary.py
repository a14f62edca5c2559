"""compat-boundary: the port's one dispatch layer (DESIGN.md §6, §11).

``repro`` routes every JAX version-skew API through ``compat.py``.  The
port has no JAX skew to route; its counterpart of that boundary is what
keeps it a port of its own and keeps the machine's facts in one place:

  * **No JAX and no reference.**  No ``import`` / ``from`` of ``jax``,
    ``jaxlib`` or ``repro`` (``repro_torch`` is the port itself), and no
    ``importlib.import_module`` of them, in ``src/repro_torch/**``,
    ``chip_smoke.py`` or ``tests/test_torch_cuda.py`` (the GPU machine
    has no JAX).  This is static, so it also covers modules that are
    imported lazily and the script, which a ``sys.modules`` check after
    an import cannot see.
  * **One CUDA probe.**  ``torch.cuda.is_available()`` is called only in
    ``compat.py`` and ``core/device.py``: every other module asks
    ``core.device.resolve_device``, which raises where a caller asks for
    the card and there is none, so nothing quietly picks the CPU.
  * **One process-group factory.**  ``init_process_group`` and
    ``init_device_mesh`` are called only in ``compat.py``
    (``make_mesh``), where the mesh engine's group is made.

Outside ``src/repro_torch`` (the script, the CUDA test file) only the
import clause applies: both must probe for CUDA themselves.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..framework import Finding, LintPass, SourceFile, dotted_name

#: top-level packages the port may not import
FORBIDDEN_ROOTS = frozenset({"jax", "jaxlib", "repro"})

#: the modules allowed to probe for CUDA
PROBE_SITES = ("src/repro_torch/compat.py", "src/repro_torch/core/device.py")
#: the module allowed to make process groups and device meshes
GROUP_SITES = ("src/repro_torch/compat.py",)
_GROUP_CALLS = frozenset({"init_process_group", "init_device_mesh"})

#: the walked files outside the port: they probe for CUDA themselves,
#: so only the import clause applies to them
IMPORTS_ONLY = ("chip_smoke.py", "tests/test_torch_cuda.py")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_ROOTS


class CompatBoundaryPass(LintPass):
    """AST scan for imports of JAX or the reference, CUDA probes and
    process-group factories outside their one place."""

    name = "compat-boundary"
    description = ("no import of jax, jaxlib or repro in the port, "
                   "chip_smoke.py or tests/test_torch_cuda.py; "
                   "torch.cuda.is_available() only in compat.py and "
                   "core/device.py; init_process_group / init_device_mesh "
                   "only in compat.py (DESIGN.md §6)")
    scope = ("src/repro_torch/*.py", "chip_smoke.py",
             "tests/test_torch_cuda.py")

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        # every file but the script and the CUDA tests is held as a port
        # module: explicit paths (fixtures, copies) get every clause
        in_port = sf.rel not in IMPORTS_ONLY
        for node in sf.nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if _forbidden(alias.name):
                        yield self._import_finding(sf, node, alias.name)
            elif isinstance(node, ast.ImportFrom):
                if node.level == 0 and node.module \
                        and _forbidden(node.module):
                    yield self._import_finding(sf, node, node.module)
            elif isinstance(node, ast.Call):
                yield from self._check_call(sf, node, in_port)

    def _import_finding(self, sf: SourceFile, node: ast.AST,
                        module: str) -> Finding:
        return self.finding(sf, node, (
            f"import of {module!r} — the port imports neither jax nor "
            f"repro; keep its own copy of what it needs"))

    def _check_call(self, sf: SourceFile, node: ast.Call,
                    in_port: bool) -> Iterator[Finding]:
        name = dotted_name(node.func)
        last = name.rsplit(".", 1)[-1]
        if last in ("import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and _forbidden(node.args[0].value):
            yield self._import_finding(sf, node, node.args[0].value)
        if not in_port:
            return
        if name.endswith("cuda.is_available") and sf.rel not in PROBE_SITES:
            yield self.finding(sf, node, (
                "torch.cuda.is_available() outside compat.py and "
                "core/device.py — ask core.device.resolve_device, which "
                "raises where the card is missing instead of picking the "
                "CPU"))
        if last in _GROUP_CALLS and sf.rel not in GROUP_SITES:
            yield self.finding(sf, node, (
                f"{last}(...) outside compat.py — process groups and "
                f"device meshes are made by compat.make_mesh"))


PASSES = [CompatBoundaryPass()]
