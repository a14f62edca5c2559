"""Seeded graphs and query pools, made on the device in a few large calls.

A configuration names its graph by the Graph 500 benchmark's Kronecker
generator: ``SCALE`` (``n = 2 ** SCALE`` vertices), ``edgefactor``
(edge tuples per vertex) and the initiator probabilities ``A``, ``B``,
``C`` (``D = 1 - A - B - C``).  ``kronecker_keys`` draws the tuples bit
by bit as the benchmark's reference generator does, permutes the vertex
labels, keeps each tuple in both directions when the graph is
undirected, and drops self-loops and repeated edges, which the Graph
500 kernels may ignore.  That base graph is a function of the
configuration's ``graph_seed`` alone.  The run's ``--seed`` then
relabels the vertices by a seeded permutation: every seed serves an
isomorphic graph, so every seed does the same work in another order,
while the arrays the program is handed differ from seed to seed.

``query_pool`` draws the paper's §7.1 online queries on the base graph:
s and t among the top share of vertices by degree, with t at most
``max_dist`` hops from s.  The pool is then mapped through the same
relabelling.

Everything here is plain PyTorch on the device it is given; on the CPU
it is a deterministic function of the seeds too (a CUDA and a CPU
generator draw different streams).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class EdgeArrays:
    """A graph's arrays on one device, laid out as the port's ``Graph``
    holds them: the forward CSR sorted by (src, dst), the reverse CSR
    sorted by (dst, src), and the edge list in forward order."""
    n: int
    indptr: torch.Tensor    # (n+1,) int64
    indices: torch.Tensor   # (m,) int64, dst in forward order
    rindptr: torch.Tensor   # (n+1,) int64
    rindices: torch.Tensor  # (m,) int64, src in reverse order
    esrc: torch.Tensor      # (m,) int64

    @property
    def m(self) -> int:
        """Number of edges."""
        return int(self.indices.shape[0])

    @property
    def edst(self) -> torch.Tensor:
        """The destination of each edge, forward order."""
        return self.indices


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def kronecker_keys(scale: int, edgefactor: int, a: float, b: float,
                   c: float, undirected: bool, seed: int,
                   device: torch.device) -> torch.Tensor:
    """Sorted distinct ``src * n + dst`` keys (no self-loops) of the
    Graph 500 Kronecker generator, ``n = 2 ** scale``: ``edgefactor * n``
    edge tuples, each built bit by bit (the row bit is 1 with chance
    ``1 - a - b``; the column bit is then 1 with chance ``b / (a + b)``
    after a row bit 0 and ``d / (c + d)`` after a 1), the vertex labels
    permuted by a seeded permutation; ``undirected`` keeps each tuple in
    both directions."""
    n = 1 << int(scale)
    count = int(edgefactor) * n
    gen = _generator(seed, device)
    ab = float(a) + float(b)
    c_norm, a_norm = float(c) / (1.0 - ab), float(a) / ab
    row = torch.zeros(count, dtype=torch.int64, device=device)
    col = torch.zeros(count, dtype=torch.int64, device=device)
    for bit in range(int(scale)):
        row_bit = torch.rand(count, generator=gen, device=device) > ab
        col_p = torch.where(row_bit, c_norm, a_norm)
        col_bit = torch.rand(count, generator=gen, device=device) > col_p
        row += row_bit.long() << bit
        col += col_bit.long() << bit
    perm = torch.randperm(n, generator=gen, device=device)
    src, dst = perm.index_select(0, row), perm.index_select(0, col)
    if undirected:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    keep = src != dst
    return torch.unique(src[keep] * n + dst[keep])


def csr_from_keys(n: int, src: torch.Tensor, dst: torch.Tensor
                  ) -> EdgeArrays:
    """Both CSR directions of the distinct edges ``src -> dst``."""
    fkey = torch.sort(src * n + dst).values
    esrc, edst = fkey // n, fkey % n
    rkey = torch.sort(dst * n + src).values
    rdst, rsrc = rkey // n, rkey % n

    def indptr(rows: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(n + 1, dtype=torch.int64, device=rows.device)
        out[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
        return out
    return EdgeArrays(n=n, indptr=indptr(esrc), indices=edst,
                      rindptr=indptr(rdst), rindices=rsrc, esrc=esrc)


def vertex_count(graph_cfg: dict) -> int:
    """The configuration's number of vertices, ``2 ** SCALE``."""
    return 1 << int(graph_cfg["SCALE"])


def base_graph(graph_cfg: dict, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The configuration's base graph as (src, dst) int64 edge tensors."""
    n = vertex_count(graph_cfg)
    keys = kronecker_keys(graph_cfg["SCALE"], graph_cfg["edgefactor"],
                          graph_cfg["A"], graph_cfg["B"], graph_cfg["C"],
                          graph_cfg["undirected"], graph_cfg["graph_seed"],
                          device)
    return keys // n, keys % n


def relabel(n: int, seed: int, device: torch.device) -> torch.Tensor:
    """The run's vertex relabelling: new id of each base vertex."""
    return torch.randperm(n, generator=_generator(seed, device),
                          device=device)


def reach_within(n: int, src: torch.Tensor, dst: torch.Tensor, root: int,
                 hops: int) -> torch.Tensor:
    """(n,) bool: the vertices at most ``hops`` edges from ``root``."""
    seen = torch.zeros(n, dtype=torch.bool, device=src.device)
    seen[root] = True
    frontier = seen.clone()
    for _ in range(hops):
        nxt = torch.zeros_like(seen)
        nxt[dst[frontier.index_select(0, src)]] = True
        frontier = nxt & ~seen
        seen |= frontier
    return seen


def query_pool(n: int, src: torch.Tensor, dst: torch.Tensor,
               query_cfg: dict) -> List[Tuple[int, int]]:
    """``pool_size`` distinct (s, t) pairs of the §7.1 generator on the
    base graph: s drawn uniformly from the top ``top_degree_share`` of
    vertices by total degree (ties by vertex id) with an out-edge, t
    drawn uniformly from those top vertices within ``max_dist`` hops of
    s.  Draws come from ``pool_seed``; a source with no such t is
    skipped."""
    deg = (torch.bincount(src, minlength=n)
           + torch.bincount(dst, minlength=n))
    order = torch.sort(-deg, stable=True).indices
    top_n = max(2, int(np.ceil(query_cfg["top_degree_share"] * n)))
    top = order[:top_n]
    is_top = torch.zeros(n, dtype=torch.bool, device=src.device)
    is_top[top] = True
    has_out = torch.bincount(src, minlength=n) > 0
    sources = top[has_out.index_select(0, top)].cpu().numpy()
    rng = np.random.default_rng(int(query_cfg["pool_seed"]))
    want = int(query_cfg["pool_size"])
    pool: List[Tuple[int, int]] = []
    for s in rng.permutation(sources):
        near = reach_within(n, src, dst, int(s), int(query_cfg["max_dist"]))
        near &= is_top
        near[int(s)] = False
        cand = torch.nonzero(near).view(-1).cpu().numpy()
        if cand.size == 0:
            continue
        t = int(cand[rng.integers(cand.size)])
        if (int(s), t) not in pool:
            pool.append((int(s), t))
        if len(pool) == want:
            return pool
    raise ValueError(f"only {len(pool)} of {want} pool pairs found")


def build(config: dict, seed: int, device: torch.device
          ) -> Tuple[EdgeArrays, List[Tuple[int, int]]]:
    """The run's graph (base graph relabelled by ``seed``) on ``device``
    and its query pool in the relabelled ids, pool order kept."""
    n = vertex_count(config["graph"])
    src, dst = base_graph(config["graph"], device)
    pool = query_pool(n, src, dst, config["query"])
    new_id = relabel(n, seed, device)
    arrays = csr_from_keys(n, new_id.index_select(0, src),
                           new_id.index_select(0, dst))
    ids = new_id.cpu().numpy()
    return arrays, [(int(ids[s]), int(ids[t])) for s, t in pool]
