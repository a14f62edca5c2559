"""Trees of tensors: nested dicts, lists and tuples (NamedTuples too),
the port's counterpart of the pytrees ``repro`` walks with ``jax.tree``.

Anything else is a leaf.  Dicts are walked in sorted key order, as
``jax.tree`` walks them, lists and tuples in order.  A leaf's path is
its keys joined by ``/``: dict keys, list and tuple indices, NamedTuple
field names.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]] | None:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _rebuild(tree, values: List[Any]):
    """``tree``'s node with its children replaced by ``values`` (in
    ``_children``'s order)."""
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def leaves_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf, in tree order."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for key, child in kids
            for item in leaves_with_path(
                child, f"{prefix}/{key}" if prefix else key)]


def leaves(tree) -> List[Any]:
    """Every leaf, in tree order."""
    return [leaf for _path, leaf in leaves_with_path(tree)]


def unflatten(template, values: Iterable[Any]):
    """``template``'s structure with its leaves taken in tree order from
    ``values``."""
    it = iter(values)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        return _rebuild(node, [build(child) for _key, child in kids])
    return build(template)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of each of ``rest`` (trees
    of the same structure) together."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
