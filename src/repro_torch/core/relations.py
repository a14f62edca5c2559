"""Algorithm 2 — relation construction + full reducer (dangling-tuple
elimination), ported from ``repro.core.relations``.  This is the paper's
*baseline* pruning method, kept for the pruning-power comparison of
Appendix B: after the full reducer,
``R_i(u_{i-1}:v, u_i)`` must equal ``I_t(v, k-i)`` for every non-t vertex v
appearing in R_i; tests/test_torch_baseline.py asserts that equivalence
against the light-weight index.
"""
from __future__ import annotations

from typing import List, Set

import numpy as np

from .graph import Graph


def build_relations(graph: Graph, s: int, t: int, k: int) -> List[np.ndarray]:
    """Returns R_1..R_k as (m_i, 2) int arrays after the full reducer.

    The virtual (t,t) tuple of rule (3) is represented explicitly.
    """
    u, v = graph.esrc.astype(np.int64), graph.edst.astype(np.int64)
    rels: List[np.ndarray] = []
    # (1)/(2): initialize
    r1 = np.stack([u[u == s], v[u == s]], axis=1)
    rels.append(r1)
    for i in range(2, k):
        keep = (u != s) & (v != s) & (u != t)  # E(G-{s}) and v != t as src
        ri = np.stack([u[keep], v[keep]], axis=1)
        ri = np.concatenate([ri, [[t, t]]], axis=0)
        rels.append(ri)
    keep = (v == t) & (u != s) & (u != t)
    rk = np.stack([u[keep], v[keep]], axis=1)
    rk = np.concatenate([rk, [[t, t]]], axis=0)
    rels.append(rk)

    # full reducer — forward sweep (Alg. 2 L5-8)
    for i in range(k - 1):
        c = set(rels[i][:, 1].tolist())
        nxt = rels[i + 1]
        mask = np.fromiter((int(x) in c for x in nxt[:, 0]), bool,
                           count=nxt.shape[0])
        rels[i + 1] = nxt[mask]
    # backward sweep (Alg. 2 L9-12)
    for i in range(k - 2, -1, -1):
        c = set(rels[i + 1][:, 0].tolist())
        cur = rels[i]
        mask = np.fromiter((int(x) in c for x in cur[:, 1]), bool,
                           count=cur.shape[0])
        rels[i] = cur[mask]
    return rels


def relation_sizes(rels: List[np.ndarray]) -> List[int]:
    """|R_1| .. |R_k|."""
    return [int(r.shape[0]) for r in rels]


def relation_neighbors(rels: List[np.ndarray], i: int, v: int) -> Set[int]:
    """R_i(u_{i-1}:v, u_i) — successors of v in relation R_i (1-based i)."""
    r = rels[i - 1]
    return set(int(x) for x in r[r[:, 0] == v][:, 1])
