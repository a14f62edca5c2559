"""rank-cost-dtype: rank-cost arithmetic stays float64 (DESIGN.md §10, §11).

Ranked enumeration's cross-backend bit-for-bit guarantee — every engine
(heap, buckets, join) and the oracle emit the *same* ordered sequence,
and the port emits ``repro``'s — rests on one numeric convention: path
costs accumulate left-to-right in float64, everywhere.  A single
narrow cast in the cost path breaks tie resolution a few ulps at a
time, and only inputs whose costs happen to collide show it.

The rule, over the port's ``core/rank.py`` and ``core/join.py`` (the
two modules that own cost arithmetic):

  * ``repro``'s clause, unchanged: no 32/16-bit float dtype spelled as
    an attribute (``np.float32``, ``torch.bfloat16``, ``x.bfloat16()``)
    or as a string dtype (``astype("float32")``);
  * torch's own narrow spellings, which that clause cannot see:
    ``torch.float`` (which *is* float32) and ``torch.half`` as
    attributes, and the ``.float()`` and ``.half()`` casts.

Integer dtypes are untouched (path matrices are int32 by the §9 kernel
contract).
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..framework import Finding, LintPass, SourceFile

_NARROW_FLOATS = frozenset({"float32", "float16", "bfloat16"})
# torch's aliases: torch.float is float32, torch.half float16
_TORCH_ALIASES = frozenset({"float", "half"})


class RankCostDtypePass(LintPass):
    """AST scan for narrow float dtypes in the rank-cost modules."""

    name = "rank-cost-dtype"
    description = ("no float32/float16/bfloat16 spelled (torch.float, "
                   "torch.half, .float() and .half() included) in "
                   "core/rank.py or core/join.py — rank costs accumulate "
                   "in float64 (DESIGN.md §10)")
    scope = ("src/repro_torch/core/rank.py", "src/repro_torch/core/join.py")

    def check(self, sf: SourceFile) -> Iterator[Finding]:
        tree = sf.tree
        assert tree is not None
        for node in sf.nodes:
            if isinstance(node, ast.Attribute) \
                    and node.attr in _NARROW_FLOATS:
                yield self.finding(sf, node, (
                    f"{node.attr} in a rank-cost module — cost "
                    f"accumulation is float64 end to end; a narrow cast "
                    f"breaks cross-backend tie resolution (DESIGN.md §10)"))
            elif isinstance(node, ast.Attribute) \
                    and node.attr in _TORCH_ALIASES \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                yield self.finding(sf, node, (
                    f"torch.{node.attr} (a narrow float) in a rank-cost "
                    f"module — cost accumulation is float64 end to end "
                    f"(DESIGN.md §10)"))
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _TORCH_ALIASES \
                    and not node.args and not node.keywords:
                yield self.finding(sf, node, (
                    f".{node.func.attr}() casts to a narrow float in a "
                    f"rank-cost module — cost accumulation is float64 "
                    f"end to end (DESIGN.md §10)"))
            elif isinstance(node, ast.Constant) \
                    and isinstance(node.value, str) \
                    and node.value in _NARROW_FLOATS:
                yield self.finding(sf, node, (
                    f"string dtype {node.value!r} in a rank-cost module — "
                    f"cost accumulation is float64 end to end "
                    f"(DESIGN.md §10)"))


PASSES = [RankCostDtypePass()]
