"""Bounded BFS distances, the first stage of index construction (Alg. 3 L1).

As in ``repro.core.bfs``, the queue BFS becomes k rounds of
edge-parallel relaxation over the edge list; here each round is one
``scatter_reduce_(…, "amin")`` on the edge list's device.  The JAX
package compiles the same loop with XLA (no Pallas kernel), so plain
torch is its counterpart.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .graph import Graph


def bfs_edge_relax(esrc: torch.Tensor, edst: torch.Tensor, n: int, k: int,
                   src: int, excluded: int) -> torch.Tensor:
    """Distances from ``src`` within ``k`` hops, ``excluded`` removed as a
    transit vertex (it may still be reached).

    ``esrc``/``edst`` are int64 edge endpoints on one device; returns
    int32 (n,) on that device with k+1 as the unreachable sentinel.
    """
    inf = k + 1
    dist = torch.full((n,), inf, dtype=torch.int32, device=esrc.device)
    dist[src] = 0
    from_excluded = esrc == excluded
    for _ in range(k):
        cand = torch.where(from_excluded, inf,
                           dist.index_select(0, esrc) + 1)
        new = dist.scatter_reduce(0, edst, cand, reduce="amin",
                                  include_self=True)
        dist = torch.clamp(new, max=inf)
    return dist


def index_distances(graph: Graph, s: int, t: int, k: int,
                    device: torch.device | str = "cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(dist_s, dist_t) per Prop. 4.3, S(s,·|G−{t}) and S(·,t|G−{s}),
    relaxed on ``device`` and returned as host int32 arrays."""
    dg = graph.to(device)
    esrc, edst = dg.esrc.long(), dg.edst.long()
    ds = bfs_edge_relax(esrc, edst, graph.n, k, s, t)
    dt = bfs_edge_relax(edst, esrc, graph.n, k, t, s)
    return ds.cpu().numpy(), dt.cpu().numpy()


def index_distances_np(graph: Graph, s: int, t: int,
                       k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host reference (queue BFS) for the relaxation."""
    from .oracle import bfs_dist_np
    ds = bfs_dist_np(graph, s, k, reverse=False, excluded=t)
    dt = bfs_dist_np(graph, t, k, reverse=True, excluded=s)
    return ds, dt
