"""Baselines the paper compares against, ported from
``repro.core.baseline``.

``generic_dfs`` is Algorithm 1 — the backtracking framework shared by
BC-DFS / T-DFS / T-DFS2 — with the static barrier B(v) = S(v,t|G) from one
reverse BFS (the initialization BC-DFS uses before its dynamic barrier
updates kick in).  It traverses the *raw* graph: each step scans all of
N(v) and re-checks the hop bound, which is precisely the per-step cost the
light-weight index eliminates.  Instrumented with the same Fig.-6 metrics
as the index enumerator (#edges accessed, #invalid partials, #results),
for the paper's detailed comparison (Fig. 6).  Pure Python on the host.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from .enumerate import EnumStats
from .graph import Graph
from .oracle import bfs_dist_np


@dataclasses.dataclass
class BaselineResult:
    """Paths (sorted tuples; empty under ``count_only``), the count, the
    Fig.-6 counters and whether the search ran to its end."""
    paths: List[Tuple[int, ...]]
    count: int
    stats: EnumStats
    exhausted: bool = True


def generic_dfs(graph: Graph, s: int, t: int, k: int,
                count_only: bool = False,
                first_n: Optional[int] = None,
                max_steps: Optional[int] = None) -> BaselineResult:
    """Algorithm 1 over the raw graph with the static barrier B(v).

    ``first_n`` stops after n results; ``max_steps`` stops once that
    many neighbour scans have been made (``exhausted=False`` either
    way)."""
    B = bfs_dist_np(graph, t, k, reverse=True)
    stats = EnumStats()
    out: List[Tuple[int, ...]] = []
    count = 0
    M = [s]
    on_path = {s}
    steps = 0
    stop = False

    def search() -> bool:
        """Returns True iff this subtree emitted at least one result."""
        nonlocal count, steps, stop
        v = M[-1]
        if v == t:
            count += 1
            stats.results += 1
            if not count_only:
                out.append(tuple(M))
            if first_n is not None and count >= first_n:
                stop = True
            return True
        any_emit = False
        nbrs = graph.neighbors(v)
        stats.edges_accessed += len(nbrs)
        steps += len(nbrs)
        if max_steps is not None and steps > max_steps:
            stop = True
        for v2 in nbrs:
            if stop:
                break
            v2 = int(v2)
            # Alg. 1 line 7: v' ∉ M and L(M) + 1 + B(v') <= k
            if v2 in on_path or v2 == s:
                stats.partials_generated += 1
                stats.invalid_partials += 1
                continue
            if (len(M) - 1) + 1 + B[v2] > k:
                stats.partials_generated += 1
                stats.invalid_partials += 1
                continue
            stats.partials_generated += 1
            M.append(v2)
            on_path.add(v2)
            emitted = search()
            if not emitted:
                stats.invalid_partials += 1
            any_emit = any_emit or emitted
            M.pop()
            on_path.discard(v2)
        return any_emit

    search()
    return BaselineResult(paths=sorted(out) if not count_only else [],
                          count=count, stats=stats, exhausted=not stop)
