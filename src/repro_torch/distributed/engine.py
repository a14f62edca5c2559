"""Distributed PathEnum: the paper's pipeline over a ``DeviceMesh``
(the port of ``repro.distributed.engine``).

The decomposition is ``repro``'s (DESIGN.md §2, last bullet):

* **queries over ``data``**: HcPE queries are independent, so a batch
  splits across the ``data`` ranks, each running the distance and
  walk-count passes for its slice;
* **edges over ``model``**: the edge list splits 1-D across the
  ``model`` ranks, each holding only its slice on the mesh's device.
  The bounded BFS and the Alg.-5 walk-count DP relax each rank's slice
  (scatter-min, scatter-add), then an all-reduce over the ``model``
  group (MIN for the BFS, SUM for the DP, once per level where ``repro``
  calls ``pmin`` / ``psum``) combines the per-rank vectors: the classic
  distributed SpMV.

``repro`` writes these passes as jnp under ``shard_map``, outside any
Pallas kernel, so plain torch ops are their counterpart here (the
arithmetic of ``core/bfs.py:bfs_edge_relax``).  Where ``repro`` vmaps
over a rank's queries, the port loops over them inside each level and
all-reduces the stacked ``(Q_local, n)`` vectors once per level: the
per-query ``(m_local,)`` temporaries bound the device memory, not
``Q_local * m_local``.

``repro`` is one controller over the mesh: it shards the distance pass
over ``data`` and then runs one host engine over the batch, each query's
expansion on its data shard.  The port is one process per rank, so
``enumerate_batch`` splits the batch itself: query (s, t) belongs to
data row ``s mod D``, which runs the mesh BFS for its own keys and its
batch engine over its own queries (with no walk-count DP and no gather
of distances), and the rows' items and counters are gathered over
``data`` so that every rank returns the same ``BatchOutput``.  The rule
keeps a key's duplicates, each shared-s group and a key's later batches
on one row, so dedup, sharing groups and the index LRU count what
``repro``'s one engine counts.
"""
from __future__ import annotations

import dataclasses
import pickle
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.batch import (DEFAULT_GRAPH_ID, BatchOutput, BatchPathEnum,
                          BatchTiming, CacheStats)
from ..core.device import resolve_device
from ..core.graph import Graph
from .wire import ReduceOp, Wire


def _pad_edges(esrc: np.ndarray, edst: np.ndarray, shards: int):
    """Pad the edge list to a multiple of ``shards`` with self-loops on
    vertex 0, which ``valid`` masks (inert for the BFS's min anyway)."""
    m = esrc.shape[0]
    pad = (-m) % shards
    if pad:
        esrc = np.concatenate([esrc, np.zeros(pad, esrc.dtype)])
        edst = np.concatenate([edst, np.zeros(pad, edst.dtype)])
    valid = np.ones(esrc.shape[0], bool)
    if pad:
        valid[-pad:] = False
    return esrc, edst, valid


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_distributed_bfs(mesh: DeviceMesh, n: int, k: int,
                         wire: Optional[Wire] = None):
    """Returns ``bfs(esrc_l, edst_l, valid_l, srcs_l, excludeds_l)`` ->
    ``(Q_local, n)`` int32 distances on the edges' device.

    The arguments are this rank's ``model`` slice of the padded edge list
    (int32, and its bool ``valid``) and its ``data`` slice of the sources
    and excluded vertices.  Each of the k levels relaxes the slice for
    every query (an edge out of its excluded vertex, or a padding edge,
    carries k + 1), then one MIN all-reduce over the ``model`` group
    combines the stacked rows.
    """
    wire = wire or Wire(mesh.get_group("model"))
    inf = k + 1

    def bfs(esrc_l: torch.Tensor, edst_l: torch.Tensor,
            valid_l: torch.Tensor, srcs_l: Sequence[int],
            excludeds_l: Sequence[int]) -> torch.Tensor:
        srcs = [int(x) for x in srcs_l]
        exc = [int(x) for x in excludeds_l]
        dev = esrc_l.device
        dist = torch.full((len(srcs), n), inf, dtype=torch.int32, device=dev)
        dist[torch.arange(len(srcs), device=dev),
             torch.tensor(srcs, dtype=torch.int64, device=dev)] = 0
        src, dst = esrc_l.long(), edst_l.long()
        invalid = ~valid_l
        for _ in range(k):
            new = torch.empty_like(dist)
            for q in range(len(srcs)):
                cand = torch.where((esrc_l == exc[q]) | invalid, inf,
                                   dist[q].index_select(0, src) + 1)
                new[q] = dist[q].scatter_reduce(0, dst, cand, reduce="amin",
                                                include_self=True)
            new.clamp_(max=inf)
            dist = wire.all_reduce(new, ReduceOp.MIN)
        return dist

    return bfs


def make_distributed_walk_dp(mesh: DeviceMesh, n: int, k: int,
                             wire: Optional[Wire] = None):
    """Returns ``dp(esrc_l, edst_l, valid_l, dist_s, dist_t)`` ->
    ``(q_prefix (Q_local, k+1), q_suffix (Q_local, k+1), total
    (Q_local,))``, float32: Alg. 5 at scale.

    One counting-semiring SpMV per level on this rank's edge slice, then
    a float32 SUM all-reduce over the ``model`` group; the (t, t)
    self-loop is added through ``dist_t == 0`` (t is the one vertex at
    distance 0 from t), and level i keeps the vertices with
    ``dist_s <= i`` and ``dist_t <= k - i``.
    """
    wire = wire or Wire(mesh.get_group("model"))

    def dp(esrc_l: torch.Tensor, edst_l: torch.Tensor,
           valid_l: torch.Tensor, ds: torch.Tensor, dt: torch.Tensor):
        Q = ds.shape[0]
        dev = ds.device
        src, dst = esrc_l.long(), edst_l.long()
        is_t = (dt == 0).to(torch.float32)

        def lvl(i: int) -> torch.Tensor:
            return (ds <= i) & (dt <= k - i)

        def step(c: torch.Tensor, i: int, backward: bool) -> torch.Tensor:
            contrib = torch.zeros((Q, n), dtype=torch.float32, device=dev)
            for q in range(Q):
                if backward:   # c = c_k^{i+1} over edges (u, v): into u
                    m = valid_l & (dt[q].index_select(0, dst) <= k - i - 1)
                    contrib[q].index_add_(0, src, torch.where(
                        m, c[q].index_select(0, dst), 0.0))
                else:          # c = c_{i-1}^0 over edges (u, v): into v
                    m = valid_l & (ds[q].index_select(0, src) <= i - 1)
                    contrib[q].index_add_(0, dst, torch.where(
                        m, c[q].index_select(0, src), 0.0))
            contrib = wire.all_reduce(contrib, ReduceOp.SUM)
            contrib = contrib + is_t * c        # the (t, t) self-loop
            return torch.where(lvl(i), contrib, 0.0)

        q_suffix = torch.zeros((Q, k + 1), dtype=torch.float32, device=dev)
        c = lvl(k).to(torch.float32)
        q_suffix[:, k] = c.sum(1)
        for i in range(k - 1, -1, -1):
            c = step(c, i, backward=True)
            q_suffix[:, i] = c.sum(1)

        q_prefix = torch.zeros((Q, k + 1), dtype=torch.float32, device=dev)
        c = lvl(0).to(torch.float32)
        q_prefix[:, 0] = c.sum(1)
        for i in range(1, k + 1):
            c = step(c, i, backward=False)
            q_prefix[:, i] = c.sum(1)
        return q_prefix, q_suffix, (c * is_t).sum(1)

    return dp


class DistributedPathEnum:
    """Query-batched index distances and cardinality estimation on a mesh.

    ``mesh`` is a ``DeviceMesh`` with ``"data"`` and ``"model"`` dims
    (``repro_torch.compat.make_mesh``) on ``device`` ("cuda" by default;
    the mesh's device type must match).  This rank holds only its
    ``model`` slice of the padded edge list (int32 endpoints and a bool
    ``valid``: 9 bytes an edge) on ``device``.
    """

    def __init__(self, mesh: DeviceMesh, graph: Graph, k: int,
                 device: torch.device | str = "cuda") -> None:
        self.device = resolve_device(device)
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type!r}, the "
                             f"engine on {self.device.type!r}")
        self.mesh = mesh
        self.graph = graph
        self.k = k
        self.model = Wire(mesh.get_group("model"))
        self.data = Wire(mesh.get_group("data"))
        es, ed, valid = _pad_edges(graph.esrc, graph.edst, self.model.size)
        per = es.shape[0] // self.model.size
        mine = slice(self.model.rank * per, (self.model.rank + 1) * per)
        self.esrc, self.edst, self.valid = (
            torch.from_numpy(np.ascontiguousarray(a[mine])).to(self.device)
            for a in (es.astype(np.int32), ed.astype(np.int32), valid))
        self._bfs = make_distributed_bfs(mesh, graph.n, k, self.model)
        self._dp = make_distributed_walk_dp(mesh, graph.n, k, self.model)
        # seconds of the last query_batch_stats call by stage
        self.last_timing: Dict[str, float] = {}
        # this row's share of the last enumerate_batch call: queries and
        # keys owned, stage seconds, its BatchTiming, the rows' payloads
        self.last_split: Dict[str, object] = {}

    def edge_bytes(self) -> int:
        """Device bytes of this rank's edge slice."""
        return sum(x.numel() * x.element_size()
                   for x in (self.esrc, self.edst, self.valid))

    def comm_counts(self) -> Dict[str, int]:
        """Collective calls and payload bytes so far, both groups summed."""
        a, b = self.model.counts(), self.data.counts()
        return {key: a[key] + b[key] for key in a}

    def query_batch_stats(self, queries: np.ndarray):
        """``queries`` (Q, 2) of (s, t); Q must be a multiple of the
        ``data`` dim's size.

        Returns ``(q_prefix, q_suffix, totals, (ds, dt))`` as host numpy
        arrays over all Q queries on every rank (each rank's slice is
        gathered over the ``data`` group); ``totals`` is δ_W, the
        full-fledged estimator output (exact walk counts).
        """
        q = np.asarray(queries, np.int32).reshape(-1, 2)
        if q.shape[0] % self.data.size:
            raise ValueError(f"{q.shape[0]} queries do not split over "
                             f"{self.data.size} data ranks")
        per = q.shape[0] // self.data.size
        mine = q[self.data.rank * per:(self.data.rank + 1) * per]
        srcs, tgts = mine[:, 0].tolist(), mine[:, 1].tolist()
        t0 = time.perf_counter()
        ds = self._bfs(self.esrc, self.edst, self.valid, srcs, tgts)
        # reverse BFS: edges reversed by swapping the endpoint arrays
        dt = self._bfs(self.edst, self.esrc, self.valid, tgts, srcs)
        _sync(self.device)
        t1 = time.perf_counter()
        qp, qs, tot = self._dp(self.esrc, self.edst, self.valid, ds, dt)
        _sync(self.device)
        t2 = time.perf_counter()
        out = [self.data.all_gather(x).cpu().numpy()
               for x in (qp, qs, tot, ds, dt)]
        self.last_timing = {"bfs_s": t1 - t0, "dp_s": t2 - t1,
                            "gather_s": time.perf_counter() - t2}
        return out[0], out[1], out[2], (out[3], out[4])

    def enumerate_batch(self, queries: np.ndarray, count_only: bool = True,
                        first_n: Optional[int] = None,
                        engine: Optional[BatchPathEnum] = None,
                        graph_id: str = DEFAULT_GRAPH_ID,
                        sharing: Optional[str] = None) -> BatchOutput:
        """Batch entry point: each ``data`` row enumerates the queries it
        owns, then the rows' results are gathered.

        ``queries`` is (Q, 2) of (s, t) at this instance's k.  Query (s,
        t) belongs to data row ``s mod D`` (D the ``data`` dim's size), so
        a key's duplicates, every query of a shared-s group and the same
        key in later batches all land on one row.  The row runs the two
        mesh BFS (``make_distributed_bfs``, MIN over ``model``) for its
        distinct keys only, and ``BatchPathEnum.run`` over its queries in
        input order, duplicates kept, with those distances keyed
        ``(graph_id, s, t, k, 0, graph.version)``: the engine skips its
        own BFS and goes straight to index assembly, planning and
        enumeration under its dedup and index LRU.  A row that owns no
        query skips the BFS on all its ranks together.  ``graph_id``
        names the tenant (it keys the hand-off and the engine's LRU);
        ``count_only``, ``first_n`` and ``sharing`` go to the engine.
        The default engine is ``BatchPathEnum()`` on this instance's
        device (its ``backend="device"``).

        The rows' items and counters come back over the ``data`` group
        through ``Wire`` (the lengths, then the padded bytes), and every
        rank returns the same ``BatchOutput``, items in input order.
        Items equal one engine's over the whole batch; plans come without
        their ``dp`` tables (two (k+1, n) float64 arrays a plan, which
        nothing reads after planning).  ``cache_stats``,
        ``distinct_queries``, ``sharing_groups``, ``shared_queries``,
        ``fused_queries`` and ``fused_dispatches`` are the rows' sums;
        below the LRU's capacity all but the fused ones equal one
        engine's.  Fused flags and counters are each row's own K5
        launch: a row with one eligible query runs it solo.  Each stage
        of ``timing`` is the slowest row's (distance seconds include the
        mesh BFS), ``total_seconds`` the call's wall on this rank.  The
        row's own split stays in ``last_split``.
        """
        engine = engine or BatchPathEnum(device=self.device)
        q = np.asarray(queries, np.int64).reshape(-1, 2)
        triples = [(int(s), int(t), self.k) for (s, t) in q]
        if q.shape[0] == 0:
            return engine.run(self.graph, [], graph_id=graph_id,
                              sharing=sharing)
        t_call = time.perf_counter()
        rows = self.data.size
        mine = [tr for tr in triples if tr[0] % rows == self.data.rank]
        keys = list(dict.fromkeys((graph_id, s, t, k, 0, self.graph.version)
                                  for s, t, k in mine))
        pre: Dict[tuple, Tuple[np.ndarray, np.ndarray]] = {}
        t0 = time.perf_counter()
        if keys:
            srcs, tgts = [key[1] for key in keys], [key[2] for key in keys]
            ds = self._bfs(self.esrc, self.edst, self.valid, srcs, tgts)
            dt = self._bfs(self.edst, self.esrc, self.valid, tgts, srcs)
            ds, dt = ds.cpu().numpy(), dt.cpu().numpy()
            pre = {key: (ds[i].copy(), dt[i].copy())
                   for i, key in enumerate(keys)}
        bfs_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = engine.run(self.graph, mine, count_only=count_only,
                         first_n=first_n, graph_id=graph_id, sharing=sharing,
                         _precomputed_distances=pre)
        run_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        row = _row_summary(out, bfs_s)
        parts = self._gather_rows(pickle.dumps(row))
        # the payloads are this mesh's own ranks' pickles
        got = [row if r == self.data.rank else pickle.loads(b)
               for r, b in enumerate(parts)]
        gather_s = time.perf_counter() - t0
        self.last_split = {
            "owned_queries": len(mine), "owned_keys": len(keys),
            "bfs_s": bfs_s, "run_s": run_s, "gather_s": gather_s,
            "row_timing": dataclasses.asdict(out.timing),
            "payload_bytes": [len(b) for b in parts]}
        return _merge_rows(triples, rows, got, graph_id, t_call)

    def _gather_rows(self, payload: bytes) -> List[bytes]:
        """Every data row's ``payload``, in row order: one all-gather of
        the lengths, one of the bytes padded to the longest."""
        dev = self.device if self.data.kind == "device" else torch.device(
            "cpu")
        lens = self.data.all_gather(torch.tensor(
            [len(payload)], dtype=torch.int64, device=dev)).tolist()
        buf = torch.zeros(max(lens), dtype=torch.uint8)
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
        every = self.data.all_gather(buf.to(dev)).cpu().numpy().reshape(
            len(lens), -1)
        return [every[r, :n].tobytes() for r, n in enumerate(lens)]


def _row_summary(out: BatchOutput, bfs_s: float) -> dict:
    """What a data row sends: its items (plans without their ``dp``
    tables), counters and stage seconds, the mesh BFS counted as
    distance seconds."""
    items = [dataclasses.replace(it, plan=dataclasses.replace(it.plan,
                                                              dp=None))
             for it in out.items]
    tm = out.timing
    return {"items": items,
            "cache_stats": dataclasses.astuple(out.cache_stats),
            "counters": [out.distinct_queries, out.sharing_groups,
                         out.shared_queries, out.fused_queries,
                         out.fused_dispatches],
            "stages": [tm.distance_seconds + bfs_s, tm.index_seconds,
                       tm.optimize_seconds, tm.enumerate_seconds]}


def _merge_rows(triples: Sequence[Tuple[int, int, int]], rows: int,
                got: Sequence[dict], graph_id: str,
                t_call: float) -> BatchOutput:
    """One ``BatchOutput`` from every row's summary: items back in input
    order (row r's are the queries with s mod rows == r, in order),
    counters summed, each stage the slowest row's."""
    items: List[object] = [None] * len(triples)
    taken = [iter(g["items"]) for g in got]
    for pos, (s, _t, _k) in enumerate(triples):
        items[pos] = next(taken[s % rows])
    counters = np.sum([g["counters"] for g in got], axis=0).tolist()
    stages = np.max([g["stages"] for g in got], axis=0).tolist()
    ended = time.perf_counter()
    timing = BatchTiming(*stages, total_seconds=ended - t_call,
                         started_at=t_call, ended_at=ended)
    return BatchOutput(
        items=items,  # type: ignore[arg-type]
        timing=timing,
        cache_stats=CacheStats(*np.sum([g["cache_stats"] for g in got],
                                       axis=0).tolist()),
        distinct_queries=counters[0], graph_id=graph_id,
        sharing_groups=counters[1], shared_queries=counters[2],
        fused_queries=counters[3], fused_dispatches=counters[4])


class DistributedTenantRouter:
    """Per-graph routing over a set of ``DistributedPathEnum`` instances
    (DESIGN.md §8's distributed leg).

    One mesh hosts several tenant graphs, each split over ``model`` by
    its own ``DistributedPathEnum``; one shared ``BatchPathEnum`` (one
    LRU, keyed by tenant) serves them all, by default a new one on
    ``device`` ("cuda" by default).
    """

    def __init__(self, tenants: Dict[str, DistributedPathEnum],
                 engine: Optional[BatchPathEnum] = None,
                 device: torch.device | str = "cuda") -> None:
        self.tenants = dict(tenants)
        self.engine = engine or BatchPathEnum(device=device)

    def enumerate(self, tagged_queries: Sequence[Tuple[str, int, int]],
                  count_only: bool = True,
                  first_n: Optional[int] = None,
                  sharing: Optional[str] = None,
                  ) -> Tuple[List[object], Dict[str, BatchOutput]]:
        """Serve ``(graph_id, s, t)`` queries; unknown ids raise KeyError.

        Returns ``(items, outputs)``: per-query ``BatchItem``s in input
        order and the ``BatchOutput`` of each tenant's group.
        """
        groups: Dict[str, List[int]] = {}
        for pos, (gid, _s, _t) in enumerate(tagged_queries):
            if gid not in self.tenants:
                raise KeyError(f"unknown graph_id {gid!r}")
            groups.setdefault(gid, []).append(pos)
        items: List[object] = [None] * len(tagged_queries)
        outputs: Dict[str, BatchOutput] = {}
        for gid, positions in groups.items():
            q = np.array([[tagged_queries[p][1], tagged_queries[p][2]]
                          for p in positions], np.int64)
            out = self.tenants[gid].enumerate_batch(
                q, count_only=count_only, first_n=first_n,
                engine=self.engine, graph_id=gid, sharing=sharing)
            outputs[gid] = out
            for p, item in zip(positions, out.items):
                items[p] = item
        return items, outputs
