"""Appendix E — HcPE with variant constraints, ported from
``repro.core.constraints``.

Three extensions, each mapping onto the motivation examples of Section 1:

* ``EdgePredicate``      — predicate on edge attributes (fraud example 2):
                           filter edges *before* the index BFS, the engine
                           is otherwise unchanged (Appendix E: "conduct the
                           filtering when computing the distance").
* ``AccumulativeValue``  — ⊕-accumulated edge values with a final predicate
                           f_a (money-laundering risk example 1, Alg. 7);
                           optional monotone bound enables in-flight pruning.
* ``ActionSequence``     — DFA over edge labels (KG example 3, Alg. 8).

The stateful constraints carry vectorized per-partial state through the
frontier enumerator (one array slot per live partial) — the accelerator
version of Alg. 7/8's extra recursion arguments.  For the join enumerator
they are applied on full tuples at join time, as Appendix E prescribes
("the DFS method can terminate the invalid search path at an earlier stage
than the join method").  The state is host numpy: a constrained query
runs on the host backend (``enumerate.resolve_backend``), as in
``repro``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from . import rank
from .graph import Graph
from .index import LightweightIndex


def edge_predicate_mask(graph: Graph,
                        pred: Callable[[np.ndarray, np.ndarray], np.ndarray]
                        ) -> np.ndarray:
    """Vectorized predicate over (esrc, edst) -> bool mask, fed to
    build_index(edge_mask=...)."""
    return np.asarray(pred(graph.esrc, graph.edst), dtype=bool)


class AccumulativeValue:
    """Alg. 7: accumulate ⊕ over edge values; accept iff f_a(β) at emit.

    op: associative+commutative ufunc-style callable (e.g. np.add)
    weights: (m,) values aligned with graph edge order (index carries the
             original edge ids, so lookups survive the index permutation).
    monotone_upper: if not None, partials whose accumulator already exceeds
             this bound are pruned in flight (valid only for monotone ⊕ with
             non-negative values — the Appendix-E caveat about negative
             weights is honored by leaving this None).
    """

    def __init__(self, weights: np.ndarray, op=np.add, init: float = 0.0,
                 accept: Callable[[np.ndarray], np.ndarray] = lambda b: b >= 0,
                 monotone_upper: Optional[float] = None):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.op = op
        self.init_value = float(init)
        self.accept_fn = accept
        self.monotone_upper = monotone_upper

    # --- frontier-enumerator hooks (vectorized over partials) ---
    def init(self, rows: int) -> np.ndarray:
        """The state of ``rows`` fresh partials: ``init`` each."""
        return np.full(rows, self.init_value, dtype=np.float64)

    def extend(self, state, parent, eids, vnew):
        """β ⊕ w(e) for each candidate, and whether it survives the
        monotone bound."""
        beta = self.op(state[parent], self.weights[eids])
        keep = np.ones(beta.shape[0], dtype=bool)
        if self.monotone_upper is not None:
            keep = beta <= self.monotone_upper
        return beta, keep

    def accept(self, state, sel):
        """f_a(β) of the emitted candidates ``sel``."""
        return np.asarray(self.accept_fn(state[sel]), dtype=bool)

    def gather(self, state, sel):
        """The state of the continuing candidates ``sel``."""
        return state[sel]

    def slice(self, state, sl):
        """The state of one chunk piece ``sl``."""
        return state[sl]

    # --- join-enumerator hook (full tuples) ---
    def check_full(self, idx: LightweightIndex, rows: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
        """f_a(β) of full path rows, β accumulated along each row."""
        # recompute β along each tuple via an edge-weight lookup table
        keep = np.ones(rows.shape[0], dtype=bool)
        betas = np.full(rows.shape[0], self.init_value, dtype=np.float64)
        wmap = self._weight_lookup(idx)
        for j in range(rows.shape[1] - 1):
            act = lens > j
            if not act.any():
                break
            u = rows[act, j].astype(np.int64)
            v = rows[act, j + 1].astype(np.int64)
            betas[act] = self.op(betas[act], wmap(u, v))
        return keep & np.asarray(self.accept_fn(betas), dtype=bool)

    def _weight_lookup(self, idx: LightweightIndex):
        """(u, v) arrays -> weights, over the index edges."""
        return _index_edge_lookup(idx, self.weights)


class ActionSequence:
    """Alg. 8: DFA over edge labels.

    A: (num_states, num_labels) int matrix; -1 = invalid transition.
    labels: (m,) int edge labels aligned with graph edge order.
    start, accepting: DFA start state and accepting-state mask.
    """

    def __init__(self, A: np.ndarray, labels: np.ndarray, start: int,
                 accepting: np.ndarray):
        self.A = np.asarray(A, dtype=np.int64)
        self.labels = np.asarray(labels, dtype=np.int64)
        self.start = int(start)
        self.accepting = np.asarray(accepting, dtype=bool)

    def init(self, rows: int) -> np.ndarray:
        """The state of ``rows`` fresh partials: the start state."""
        return np.full(rows, self.start, dtype=np.int64)

    def extend(self, state, parent, eids, vnew):
        """The DFA step on each candidate's edge label; -1 dies."""
        nxt = self.A[np.maximum(state[parent], 0), self.labels[eids]]
        keep = (state[parent] >= 0) & (nxt >= 0)
        return nxt, keep

    def accept(self, state, sel):
        """Whether the emitted candidates ``sel`` end in an accepting
        state."""
        st = state[sel]
        ok = st >= 0
        out = np.zeros(st.shape[0], dtype=bool)
        out[ok] = self.accepting[st[ok]]
        return out

    def gather(self, state, sel):
        """The state of the continuing candidates ``sel``."""
        return state[sel]

    def slice(self, state, sl):
        """The state of one chunk piece ``sl``."""
        return state[sl]

    def check_full(self, idx: LightweightIndex, rows: np.ndarray,
                   lens: np.ndarray) -> np.ndarray:
        """Whether the DFA accepts each full path row's labels."""
        lmap = self._label_lookup(idx)
        st = np.full(rows.shape[0], self.start, dtype=np.int64)
        for j in range(rows.shape[1] - 1):
            act = (lens > j) & (st >= 0)
            if not act.any():
                break
            u = rows[act, j].astype(np.int64)
            v = rows[act, j + 1].astype(np.int64)
            lab = lmap(u, v)
            st_act = st[act]
            nxt = np.where(lab >= 0, self.A[np.maximum(st_act, 0),
                                            np.maximum(lab, 0)], -1)
            st[act] = nxt
        ok = st >= 0
        out = np.zeros(rows.shape[0], dtype=bool)
        out[ok] = self.accepting[st[ok]]
        return out

    def _label_lookup(self, idx: LightweightIndex):
        """(u, v) arrays -> labels, over the index edges."""
        return _index_edge_lookup(idx, self.labels)


def _index_edge_lookup(idx: LightweightIndex, values: np.ndarray):
    """A vectorized (u, v) -> value lookup over the index edges
    (``values`` in graph edge order, float64 weights or int64 labels,
    which round-trip float64 exactly).  Every edge of a full path row is
    an index edge by construction, so every lookup hits."""
    keys, vals = rank.index_edge_table(idx, values)
    vals = vals.astype(values.dtype)
    n = np.int64(idx.n)

    def look(u, v):
        return vals[np.searchsorted(keys, u.astype(np.int64) * n + v)]
    return look
