"""Graph container and generators (the port of ``repro.core.graph``).

The canonical representation is the JAX package's: a static CSR pair
(forward and reverse) plus flat edge lists, held as host numpy arrays,
vertices int32 ids in ``[0, n)``.  The generators draw from numpy's
``default_rng`` exactly as ``repro`` does, so one seed gives byte-equal
arrays in both packages (tests/test_torch_graph.py).

``Graph.to(device)`` holds the same arrays as tensors on a device (a
``DeviceGraph``), which the device index build reads
(``index.build_index_device``).

Graphs are immutable values, but deployments stream (DESIGN.md §12):
mutation is *versioned copying*, as in ``repro``.  ``with_edges`` (and
the ``add_edges`` / ``remove_edges`` conveniences) rebuild the CSR
around the new edge set through ``from_edges`` and return a new
``Graph`` whose ``version`` is bumped by one; every index-cache key
folds the version in (core/batch.py), so an index built against
version v never answers a query against version v+1.  The copy is a
new object, so it starts with no device arrays of its own: the old
version's ``DeviceGraph`` is freed with the old ``Graph``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .device import resolve_device

INF_DIST = np.int32(0x3FFFFFFF)
PAD = np.int32(-1)


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """A graph's arrays on one device: vertex ids int32, offsets int64."""
    n: int
    indptr: torch.Tensor    # (n+1,) int64
    indices: torch.Tensor   # (m,)   int32
    rindptr: torch.Tensor   # (n+1,) int64
    rindices: torch.Tensor  # (m,)   int32
    esrc: torch.Tensor      # (m,)   int32
    edst: torch.Tensor      # (m,)   int32

    def memory_bytes(self) -> int:
        """Bytes held on the device."""
        return sum(x.numel() * x.element_size() for x in
                   (self.indptr, self.indices, self.rindptr, self.rindices,
                    self.esrc, self.edst))


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph in CSR (forward + reverse) with flat edge lists;
    ``version`` is ``repro``'s streaming-mutation epoch (DESIGN.md §12)."""

    n: int
    indptr: np.ndarray    # (n+1,) int64
    indices: np.ndarray   # (m,)   int32, dst sorted within each src slice
    rindptr: np.ndarray   # (n+1,) int64
    rindices: np.ndarray  # (m,)   int32
    esrc: np.ndarray      # (m,) int32
    edst: np.ndarray      # (m,) int32
    version: int = 0

    @property
    def m(self) -> int:
        """Number of edges."""
        return int(self.indices.shape[0])

    def out_degree(self, v: int) -> int:
        """Number of out-neighbours of ``v``."""
        return int(self.indptr[v + 1] - self.indptr[v])

    def neighbors(self, v: int) -> np.ndarray:
        """Out-neighbours of ``v`` (sorted)."""
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def in_neighbors(self, v: int) -> np.ndarray:
        """In-neighbours of ``v`` (sorted)."""
        return self.rindices[self.rindptr[v]:self.rindptr[v + 1]]

    def reverse(self) -> "Graph":
        """The graph with every edge reversed (the CSR pair swapped)."""
        return Graph(self.n, self.rindptr, self.rindices, self.indptr,
                     self.indices, self.rindices_src(), self.redst())

    def rindices_src(self) -> np.ndarray:
        """The source (in reverse-CSR terms) of each reverse-CSR entry."""
        return np.repeat(np.arange(self.n, dtype=np.int32),
                         np.diff(self.rindptr).astype(np.int64))

    def redst(self) -> np.ndarray:
        """The destination of each reverse-CSR entry."""
        return self.rindices

    # -- streaming mutation (DESIGN.md §12) ---------------------------------

    def edge_list(self) -> np.ndarray:
        """The edge set as an (m, 2) int64 array in forward-CSR order."""
        return np.stack([self.esrc.astype(np.int64),
                         self.edst.astype(np.int64)], axis=1)

    def with_edges(self, add: Optional[np.ndarray] = None,
                   remove: Optional[np.ndarray] = None) -> "Graph":
        """Versioned copy with ``add`` edges inserted and ``remove``
        edges deleted (DESIGN.md §12), as ``repro``'s.

        Both arguments are (r, 2) arrays of directed ``(src, dst)``
        pairs with endpoints in [0, n).  Removals run first, then
        insertions, so an edge in both is re-inserted.  Removing an edge
        the graph does not hold raises ValueError; inserting one it holds
        is a no-op, and self-loops are dropped.  The copy's ``version``
        is ``self.version + 1`` even when the edge set is unchanged.
        """
        edges = self.edge_list()
        if remove is not None:
            rem = np.asarray(remove, dtype=np.int64).reshape(-1, 2)
            self._check_range(rem, "remove")
            if rem.size:
                cur_keys = edges[:, 0] * self.n + edges[:, 1]
                rem_keys = rem[:, 0] * self.n + rem[:, 1]
                present = np.isin(rem_keys, cur_keys)
                if not present.all():
                    missing = rem[~present][0]
                    raise ValueError(
                        f"cannot remove edge ({int(missing[0])}, "
                        f"{int(missing[1])}): not in the graph")
                edges = edges[~np.isin(cur_keys, rem_keys)]
        if add is not None:
            ins = np.asarray(add, dtype=np.int64).reshape(-1, 2)
            self._check_range(ins, "add")
            edges = np.concatenate([edges, ins], axis=0)
        rebuilt = from_edges(self.n, edges)
        # replace() builds a fresh object: no _device_graphs of the parent
        return dataclasses.replace(rebuilt, version=self.version + 1)

    def add_edges(self, edges: np.ndarray) -> "Graph":
        """``with_edges(add=edges)``, the streaming insert."""
        return self.with_edges(add=edges)

    def remove_edges(self, edges: np.ndarray) -> "Graph":
        """``with_edges(remove=edges)``, the streaming delete; every edge
        must exist."""
        return self.with_edges(remove=edges)

    def _check_range(self, pairs: np.ndarray, what: str) -> None:
        if pairs.size and not ((pairs >= 0).all() and (pairs < self.n).all()):
            raise ValueError(f"{what} edges must have endpoints in "
                             f"[0, {self.n})")

    @classmethod
    def from_numpy(cls, n: int, indptr: np.ndarray, indices: np.ndarray,
                   rindptr: np.ndarray, rindices: np.ndarray,
                   esrc: np.ndarray, edst: np.ndarray,
                   version: int = 0) -> "Graph":
        """A graph over plain numpy arrays laid out as ``repro``'s
        ``Graph`` holds them (the state carried across packages)."""
        return cls(n=int(n), indptr=np.asarray(indptr, np.int64),
                   indices=np.asarray(indices, np.int32),
                   rindptr=np.asarray(rindptr, np.int64),
                   rindices=np.asarray(rindices, np.int32),
                   esrc=np.asarray(esrc, np.int32),
                   edst=np.asarray(edst, np.int32), version=int(version))

    def to(self, device: torch.device | str) -> DeviceGraph:
        """The graph's arrays as tensors on ``device``, made once per
        device and kept on the graph (graphs are immutable values)."""
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_device_graphs", {})
        held = cache.get(dev)
        if held is None:
            def put(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            held = DeviceGraph(n=self.n, indptr=put(self.indptr),
                               indices=put(self.indices),
                               rindptr=put(self.rindptr),
                               rindices=put(self.rindices),
                               esrc=put(self.esrc), edst=put(self.edst))
            cache[dev] = held
        return held


def from_edges(n: int, edges: np.ndarray, dedup: bool = True) -> Graph:
    """Build a Graph from an (m, 2) int array of directed edges.

    Self-loops are dropped and duplicates removed (unless ``dedup`` is
    False).  Edges are ordered by the fused key ``src * n + dst`` with a
    stable sort, which is the order of ``repro``'s lexsort by (src, dst)
    and costs one integer sort instead of a structured ``np.unique``.
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size:
        edges = edges[edges[:, 0] != edges[:, 1]]
    src = edges[:, 0]
    dst = edges[:, 1]
    nn = np.int64(n)

    def csr(a: np.ndarray, b: np.ndarray):
        key = a * nn + b
        if dedup:
            key = np.unique(key)           # sorted, so already in order
        else:
            key = key[np.argsort(key, kind="stable")]
        a_s, b_s = key // nn, key % nn
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(a_s, minlength=n), out=indptr[1:])
        return indptr, b_s.astype(np.int32), a_s.astype(np.int32)

    indptr, indices, esrc = csr(src, dst)
    rindptr, rindices, _ = csr(dst, src)
    return Graph(n=n, indptr=indptr, indices=indices, rindptr=rindptr,
                 rindices=rindices, esrc=esrc, edst=indices)


# ---------------------------------------------------------------------------
# Generators (numpy default_rng, draw for draw as in repro.core.graph)
# ---------------------------------------------------------------------------

def erdos_renyi(n: int, avg_deg: float, seed: int = 0) -> Graph:
    """Directed G(n, m) graph with m = n * avg_deg draws (deduplicated)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return from_edges(n, np.stack([src, dst], axis=1))


def power_law(n: int, avg_deg: float, alpha: float = 1.2,
              seed: int = 0) -> Graph:
    """Directed graph with Zipfian endpoint sampling (heavy-tailed
    out- and in-degree, the paper's social/web regime)."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    ranks = np.arange(1, n + 1, dtype=np.float64)
    probs = ranks ** (-alpha)
    probs /= probs.sum()
    perm_out = rng.permutation(n)
    perm_in = rng.permutation(n)
    src = perm_out[rng.choice(n, size=m, p=probs)]
    dst = perm_in[rng.choice(n, size=m, p=probs)]
    return from_edges(n, np.stack([src, dst], axis=1))


def layered_dag(layers: int, width: int, fanout: float,
                seed: int = 0) -> Graph:
    """Layered DAG with dense inter-layer wiring (s = n-2, t = n-1)."""
    rng = np.random.default_rng(seed)
    n = layers * width + 2
    s, t = n - 2, n - 1
    edges = [(s, v) for v in range(width)]
    for layer in range(layers - 1):
        base_a, base_b = layer * width, (layer + 1) * width
        cnt = int(width * fanout)
        a = rng.integers(0, width, size=cnt) + base_a
        b = rng.integers(0, width, size=cnt) + base_b
        edges.extend(zip(a.tolist(), b.tolist()))
    for v in range((layers - 1) * width, layers * width):
        edges.append((v, t))
    return from_edges(n, np.array(edges, dtype=np.int64))


def grid(rows: int, cols: int, bidirectional: bool = True) -> Graph:
    """rows x cols grid, edges right and down (and back if
    ``bidirectional``)."""
    n = rows * cols
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                edges.append((v, v + 1))
                if bidirectional:
                    edges.append((v + 1, v))
            if r + 1 < rows:
                edges.append((v, v + cols))
                if bidirectional:
                    edges.append((v + cols, v))
    return from_edges(n, np.array(edges, dtype=np.int64))


def complete(n: int) -> Graph:
    """Complete directed graph on n vertices (no self-loops)."""
    src, dst = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    return from_edges(n, np.stack([src.ravel(), dst.ravel()], axis=1))


def random_graph_suite(seed: int = 0) -> dict:
    """Small named workload suite used by tests (``repro``'s)."""
    return {
        "er_small": erdos_renyi(64, 3.0, seed),
        "er_dense": erdos_renyi(48, 6.0, seed + 1),
        "pl_hub": power_law(96, 4.0, seed=seed + 2),
        "dag": layered_dag(4, 8, 3.0, seed + 3),
        "grid": grid(6, 6),
    }
