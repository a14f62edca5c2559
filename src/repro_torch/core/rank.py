"""Ranked (any-k) enumeration support (DESIGN.md §10), ported from
``repro.core.rank``.

Under ``order=`` paths come back in non-decreasing rank, so a truncation
(``first_n``, a deadline) is always the top of the result set.  This
module is the shared vocabulary of that contract; the drivers live in
enumerate.py (best-first host heap, rank-bucketed scheduling on K1's
hop entry) and join.py (cost-ordered key groups).

Rank of a path ``p``:

  * ``order="hops"``   — the hop count (number of edges).
  * ``order="weight"`` — the edge-weight sum, accumulated left to right
    in float64 (the *canonical accumulation order*: every driver and the
    oracle sum in the same order, so ties and near-ties agree bit for
    bit across backends and with ``repro``).

Ties break on the lexicographic vertex sequence (PAD-padded rows compare
exactly like Python tuples: a shorter sequence sorts before its
extensions), so ``(cost, sequence)`` is a total order and every backend
emits the same ordered sequence.  Costs are float64 (hops: int64) and
are never narrowed; ``order="weight"`` demands finite non-negative
weights in graph edge order.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

if TYPE_CHECKING:
    from .index import LightweightIndex

ORDERS = ("hops", "weight")

# Relative slack treating two float path costs as a potential tie
# (DESIGN.md §10).  Equal paths cost bit-identical floats everywhere, but
# a lower bound (acc + wdist_t, or a join group's min_a + min_b) sums in
# another association order and may sit a few ulps off the cost it
# bounds.  Emission gates require a result to clear the bound by this
# margin; the margin only delays emission, it never reorders it.
WEIGHT_TIE_SLACK = 1e-9


def weight_slack(bound: float) -> float:
    """The absolute emission margin at a given bound magnitude."""
    return WEIGHT_TIE_SLACK * (1.0 + abs(float(bound)))


@dataclasses.dataclass(frozen=True)
class RankSpec:
    """A validated ranking request: ``order`` plus (for weight ranking)
    the float64 edge-weight array in graph edge order."""
    order: str
    weights: Optional[np.ndarray] = None

    @property
    def is_weight(self) -> bool:
        """True for ``order="weight"`` (float costs, slack-gated
        emission); False for hop ranking (exact integer costs)."""
        return self.order == "weight"


def make_rank_spec(order: Optional[str],
                   weights: Optional[np.ndarray]) -> Optional[RankSpec]:
    """Validate an ``order=`` request into a RankSpec (None stays None).

    ``order="weight"`` requires ``weights``: one finite non-negative
    value per graph edge.  Negative or non-finite weights raise
    ValueError: the best-first lower bounds would stop being admissible.
    """
    if order is None:
        return None
    if order not in ORDERS:
        raise ValueError(f"unknown order {order!r}; expected one of "
                         f"{ORDERS} or None")
    if order == "hops":
        return RankSpec(order="hops")
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
    return RankSpec(order="weight", weights=w)


# ---------------------------------------------------------------------------
# canonical ordering
# ---------------------------------------------------------------------------

def canonical_perm(paths: np.ndarray, costs: np.ndarray) -> np.ndarray:
    """The permutation sorting ``paths`` rows by ``(cost, sequence)``.

    Stable lexsort: primary key ``costs`` (float64 or int64, never
    narrowed), then vertex columns left to right.  PAD (−1) tail padding
    sorts before any vertex id, so a shorter sequence precedes its
    extensions, exactly like Python tuple comparison.
    """
    cols = tuple(paths[:, j] for j in range(paths.shape[1] - 1, -1, -1))
    return np.lexsort(cols + (costs,))


def _index_edge_sources(idx: "LightweightIndex") -> np.ndarray:
    """The source vertex of every forward index edge, int64."""
    counts = (idx.fwd_end[:, idx.k] - idx.fwd_begin).astype(np.int64)
    return np.repeat(np.arange(idx.n, dtype=np.int64), counts)


def index_edge_table(idx: "LightweightIndex", values: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """A vectorized (u, v) -> value lookup table over index edges.

    Returns ``(keys, vals)`` with ``keys = u * n + v`` sorted ascending
    and ``vals`` the per-edge values (``values`` in graph edge order,
    mapped through ``idx.fwd_eid``).  Every edge an enumerator walks is
    an index edge, so ``np.searchsorted(keys, u*n+v)`` always hits.
    """
    n = np.int64(idx.n)
    keys = _index_edge_sources(idx) * n + idx.fwd_dst.astype(np.int64)
    vals = np.asarray(values, dtype=np.float64)[idx.fwd_eid]
    order = np.argsort(keys, kind="stable")
    return keys[order], vals[order]


def path_costs(idx: "LightweightIndex", paths: np.ndarray,
               lengths: np.ndarray,
               spec: Optional[RankSpec]) -> np.ndarray:
    """Canonical per-row costs of finished path rows: the length (int64)
    for hop ranking and ``order=None``; for weight ranking each row's
    edge weights summed left to right in float64."""
    if spec is None or not spec.is_weight:
        return np.asarray(lengths, dtype=np.int64)
    keys, vals = index_edge_table(idx, spec.weights)
    n = np.int64(idx.n)
    costs = np.zeros(paths.shape[0], dtype=np.float64)
    for j in range(paths.shape[1] - 1):
        act = np.asarray(lengths) > j
        if not act.any():
            break
        q = paths[act, j].astype(np.int64) * n + paths[act, j + 1]
        costs[act] = costs[act] + vals[np.searchsorted(keys, q)]
    return costs


def remaining_lower_bound(idx: "LightweightIndex",
                          spec: RankSpec) -> np.ndarray:
    """Admissible per-vertex lower bound on the cost still needed to
    reach ``t`` (the best-first heuristic of DESIGN.md §10).

    * hops: the index's BFS distance-to-t array (int64).
    * weight: a k-round min-plus relaxation over the index edges on the
      host, ``wd[v] = min(w(v,u) + wd[u])``: the cheapest ≤k-hop walk
      cost v→t (float64, +inf where t is out of reach).  Simple paths
      are walks and weights are non-negative, so the bound never
      exceeds the true remaining cost.
    """
    if not spec.is_weight:
        return idx.dist_t.astype(np.int64)
    eu = _index_edge_sources(idx)
    ew = np.asarray(spec.weights, dtype=np.float64)[idx.fwd_eid]
    dst = idx.fwd_dst.astype(np.int64)
    wd = np.full(idx.n, np.inf, dtype=np.float64)
    wd[idx.t] = 0.0
    for _ in range(idx.k):
        if eu.size == 0:
            break
        cand = ew + wd[dst]
        new = wd.copy()
        np.minimum.at(new, eu, cand)
        if np.array_equal(new, wd):
            break
        wd = new
    return wd


def edge_step_costs(idx: "LightweightIndex", spec: RankSpec,
                    pos: np.ndarray) -> np.ndarray:
    """Per-candidate incremental cost for index positions ``pos`` (the
    hop's gather offsets): 1 (int64) for hops, the edge weight (float64)
    for weight ranking."""
    if not spec.is_weight:
        return np.ones(pos.shape[0], dtype=np.int64)
    return np.asarray(spec.weights, dtype=np.float64)[idx.fwd_eid[pos]]
