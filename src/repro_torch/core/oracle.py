"""Ground truth for HcPE: plain recursive backtracking (Alg. 1), ported
from ``repro.core.oracle``.

Pure Python and numpy, deliberately simple.  The port's engine paths are
held against it as exact set comparisons; ``bfs_dist_np`` is also the
host BFS behind ``bfs.index_distances_np``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

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


def enumerate_paths(graph: Graph, s: int, t: int,
                    k: int) -> List[Tuple[int, ...]]:
    """All simple paths s->t with ≤ k edges (interior vertices ∉ {s,t}),
    sorted as tuples."""
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
            if (len(M) - 1) + 1 + B[v2] <= k:
                M.append(v2)
                on_path.add(v2)
                search()
                M.pop()
                on_path.discard(v2)

    search()
    return sorted(out)
