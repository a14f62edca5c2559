"""Ranked-enumeration vocabulary, the part the unranked path needs
(ported from ``repro.core.rank``, DESIGN.md §10).

* ``canonical_perm`` — the ``(cost, sequence)`` order that exhausted
  unranked results are sorted into, so every backend and plan returns
  the same ordered list.
* ``make_rank_spec`` — validates an ``order=`` request.  Ranked
  enumeration itself (``order="hops"|"weight"``) is ported in the later
  ranked/constrained slice (ROADMAP.md, queue 1 item 5): a valid request
  raises NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

ORDERS = ("hops", "weight")

RANKED_LATER = ("ranked enumeration (order='hops'|'weight') is not ported "
                "yet; it belongs to the ranked/constrained slice of the "
                "port (ROADMAP.md queue 1 item 5)")


def make_rank_spec(order: Optional[str],
                   weights: Optional[np.ndarray]) -> None:
    """Validate an ``order=`` request: None passes; an unknown order or
    malformed weights raise ValueError as in ``repro``; a valid ranked
    request raises NotImplementedError naming the later slice."""
    if order is None:
        return None
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; expected one of "
                         f"{ORDERS} or None")
    if order == "weight":
        if weights is None:
            raise ValueError("order='weight' requires an edge-weight array "
                             "(graph edge order)")
        w = np.asarray(weights, dtype=np.float64)
        if w.ndim != 1:
            raise ValueError(f"weights must be 1-D, got shape {w.shape}")
        if not np.all(np.isfinite(w)):
            raise ValueError("order='weight' requires finite weights")
        if w.size and float(w.min()) < 0.0:
            raise ValueError("order='weight' requires non-negative weights "
                             "(the Appendix-E monotonicity caveat)")
    raise NotImplementedError(RANKED_LATER)


def canonical_perm(paths: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """The permutation sorting ``paths`` rows by ``(cost, sequence)``.

    Stable lexsort: primary key ``costs`` (float64 or int64, never
    narrowed), then vertex columns left to right.  PAD (−1) tail padding
    sorts before any vertex id, so a shorter sequence precedes its
    extensions, exactly like Python tuple comparison.
    """
    cols = tuple(paths[:, j] for j in range(paths.shape[1] - 1, -1, -1))
    return np.lexsort(cols + (costs,))
