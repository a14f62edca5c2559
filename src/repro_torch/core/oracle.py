"""Ground truth for HcPE: plain recursive backtracking (Alg. 1), ported
from ``repro.core.oracle``.

Pure Python and numpy, deliberately simple.  The port's engine paths are
held against it as exact set comparisons; ``bfs_dist_np`` is also the
host BFS behind ``bfs.index_distances_np``.

Under ``order=`` (ranked enumeration, DESIGN.md §10) the contract is the
exact sequence: the oracle sorts by ``(cost, lexicographic vertex
sequence)``, the cost being the hop count or the left-to-right
edge-weight sum in Python floats, accumulated in the engines' order so
ties agree bit for bit.
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Optional, Set, Tuple

import numpy as np

from .graph import Graph


def bfs_dist_np(graph: Graph, src: int, k: int, reverse: bool = False,
                excluded: Optional[int] = None) -> np.ndarray:
    """Bounded BFS distance from ``src`` (or *to* src if reverse) ≤ k+1.

    ``excluded`` is forbidden as a *transit* vertex (the paper's G-{v}):
    it may receive a distance but is never expanded.
    """
    INF = k + 1
    dist = np.full(graph.n, INF, dtype=np.int32)
    dist[src] = 0
    frontier = [src]
    d = 0
    indptr = graph.rindptr if reverse else graph.indptr
    indices = graph.rindices if reverse else graph.indices
    while frontier and d < k:
        nxt = []
        for u in frontier:
            if u == excluded:
                continue
            for v in indices[indptr[u]:indptr[u + 1]]:
                v = int(v)
                if dist[v] > d + 1:
                    dist[v] = d + 1
                    nxt.append(v)
        frontier = nxt
        d += 1
    return dist


def path_cost(p: Tuple[int, ...], order: str,
              wmap: Optional[dict] = None) -> float:
    """Canonical rank cost of one path tuple: hop count, or the
    left-to-right edge-weight sum (``wmap``: (u, v) -> weight)."""
    if order == "hops":
        return len(p) - 1
    cost = 0.0
    for a, b in zip(p, p[1:]):
        cost = cost + float(wmap[(a, b)])
    return cost


def rank_sorted(paths: Iterable[Tuple[int, ...]], order: Optional[str],
                weights=None, graph: Optional[Graph] = None,
                ) -> List[Tuple[int, ...]]:
    """Sort path tuples into the canonical ranked order ``(cost, vertex
    sequence)``; ``order=None`` uses the hops key (the order exhausted
    unranked results are canonicalized to)."""
    wmap = None
    if order == "weight":
        if graph is None or weights is None:
            raise ValueError("order='weight' needs graph and weights")
        wmap = {(int(a), int(b)): float(w)
                for a, b, w in zip(graph.esrc, graph.edst, weights)}
    key_order = order or "hops"
    return sorted(paths, key=lambda p: (path_cost(p, key_order, wmap), p))


def enumerate_paths(graph: Graph, s: int, t: int, k: int,
                    edge_pred: Optional[Callable[[int, int], bool]] = None,
                    order: Optional[str] = None,
                    weights=None) -> List[Tuple[int, ...]]:
    """All simple paths s->t with ≤ k edges (interior vertices ∉ {s,t})
    whose edges all pass ``edge_pred``; sorted as tuples, or in the
    canonical ranked sequence under ``order=`` (`rank_sorted`)."""
    if s == t:
        raise ValueError("s and t must be distinct")
    B = bfs_dist_np(graph, t, k, reverse=True)
    out: List[Tuple[int, ...]] = []
    M = [s]
    on_path = {s}

    def search() -> None:
        v = M[-1]
        if v == t:
            out.append(tuple(M))
            return
        if len(M) - 1 >= k:
            return
        for v2 in graph.neighbors(v):
            v2 = int(v2)
            if v2 in on_path or v2 == s:
                continue
            if edge_pred is not None and not edge_pred(v, v2):
                continue
            if (len(M) - 1) + 1 + B[v2] <= k:
                M.append(v2)
                on_path.add(v2)
                search()
                M.pop()
                on_path.discard(v2)

    search()
    if order is not None:
        return rank_sorted(out, order, weights=weights, graph=graph)
    return sorted(out)


def count_walks(graph: Graph, s: int, t: int, k: int) -> int:
    """|W(s,t,k,G)| per Definition 2.1 (interior vertices ∉ {s,t}): the
    exact count the full-fledged estimator reaches at convergence."""
    counts = np.zeros(graph.n, dtype=np.int64)
    counts[s] = 1
    total = 0
    for _ in range(k):
        nxt = np.zeros(graph.n, dtype=np.int64)
        for u in range(graph.n):
            if counts[u] == 0 or u == t:
                continue
            for v in graph.neighbors(u):
                v = int(v)
                if v == s:
                    continue
                nxt[v] += counts[u]
        total += int(nxt[t])
        nxt[t] = 0  # walks stop at t (Definition 2.1)
        counts = nxt
    return total


def paths_as_set(paths: Iterable[Tuple[int, ...]]) -> Set[Tuple[int, ...]]:
    """Path tuples as a set of int tuples."""
    return set(tuple(int(x) for x in p) for p in paths)
