"""BatchPathEnum, the online-workload engine (DESIGN.md §4), ported from
``repro.core.batch``.

The paper's headline numbers are measured on batches of queries (the
1000-query online sets of §7.1).  The engine shares work across a batch
and across batches:

1. **result dedup**: identical ``(s, t, k)`` queries in a batch run the
   pipeline once; duplicates receive the same ``EnumResult`` object.
2. **index cache**: ``LightweightIndex`` builds are kept in an LRU keyed
   on ``(graph_id, s, t, k, edge_mask_hash, graph_version)``, with
   global and per-tenant hit/miss/eviction stats and per-tenant quotas
   (DESIGN.md §8).
3. **stacked BFS on the device**: the two bounded-BFS distance passes of
   every cache-missing query relax together on the engine's device
   (``batched_index_distances``), and the host index build consumes the
   distances.
4. **cross-query sharing** (``core.sharing``, DESIGN.md §13) and **fused
   launches** (``core.fused``, DESIGN.md §9): overlap groups walk their
   shared prefixes once, and the remaining device-eligible IDX-DFS
   queries expand together, one kernel launch (K5) per round.

The planner runs once per distinct query, and every result is
byte-identical to a solo ``PathEnum`` run (tests/test_torch_batch.py
holds the port to ``repro``'s engine).  Like the port's ``PathEnum``,
the engine defaults to ``device="cuda"`` and ``backend="device"``.
Ranked batches (``order=``, DESIGN.md §10) keep construction sharing
only: they opt out of the shared walk and of fused launches, and each
query takes the solo ranked drivers.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..kernels import ops as kops
from . import fused as fused_mod
from . import planner as planner_mod
from . import rank
from . import sharing as sharing_mod
from . import trace
from .device import resolve_device
from .enumerate import (EnumResult, EnumStats, enumerate_paths_idx,
                        resolve_backend)
from .graph import Graph, from_edges
from .index import LightweightIndex, build_index
from .join import enumerate_paths_join
from .pathenum import PathEnum
from .planner import DEFAULT_TAU, Plan

# The engine's cache key.  ``graph_id`` is the tenant dimension
# (DESIGN.md §8): one engine — and therefore one LRU — serves many tenant
# graphs, and the id keeps their entries (and stats, and eviction
# pressure) apart.  Single-graph callers never see it: every entry point
# defaults to ``DEFAULT_GRAPH_ID``.  ``graph_version`` is the tenant
# graph's streaming-mutation epoch (DESIGN.md §12): mutating a graph bumps
# it, so every post-mutation lookup misses the pre-mutation entries by
# construction — correctness never depends on an eager purge.
# (graph_id, s, t, k, edge_mask_hash, graph_version)
QueryKey = Tuple[str, int, int, int, int, int]

DEFAULT_GRAPH_ID = "default"

# one query's (dist_s, dist_t) host distances
Dists = Tuple[np.ndarray, np.ndarray]


def tenant_of(key: Union[QueryKey, Tuple[int, ...]]) -> str:
    """The tenant a cache key belongs to.

    ``QueryKey``s carry their ``graph_id`` first (6-tuples since the
    streaming ``graph_version`` dimension, 5-tuples before it — both
    fold the same way); legacy all-int ``(s, t, k, edge_mask_hash)``
    keys (pre-tenancy callers poking the cache directly) fold onto
    ``DEFAULT_GRAPH_ID`` (DESIGN.md §8's single-graph compatibility
    contract).
    """
    if isinstance(key, tuple) and key and isinstance(key[0], str):
        return key[0]
    return DEFAULT_GRAPH_ID


def edge_mask_hash(edge_mask: Optional[np.ndarray]) -> int:
    """Stable 64-bit hash of an edge mask (0 for the unmasked graph)."""
    if edge_mask is None:
        return 0
    packed = np.packbits(np.asarray(edge_mask, dtype=bool))
    return int.from_bytes(hashlib.blake2b(packed.tobytes(),
                                          digest_size=8).digest(), "big")


@dataclasses.dataclass
class CacheStats:
    """Monotone hit/miss/eviction counters for one cache scope — the whole
    ``IndexCache`` or one tenant's slice of it (DESIGN.md §4, §8)."""
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def lookups(self) -> int:
        """Total lookups: hits + misses (evictions are not lookups)."""
        return self.hits + self.misses

    @property
    def hit_rate(self) -> float:
        """Hits over lookups; 0.0 (not NaN) when nothing was looked up."""
        return self.hits / self.lookups if self.lookups else 0.0

    def snapshot(self) -> "CacheStats":
        """A value copy, for later ``delta`` arithmetic."""
        return CacheStats(self.hits, self.misses, self.evictions)

    def delta(self, since: "CacheStats") -> "CacheStats":
        """Counters accumulated since ``since`` (an earlier snapshot)."""
        return CacheStats(self.hits - since.hits, self.misses - since.misses,
                          self.evictions - since.evictions)


class IndexCache:
    """Tenant-aware LRU over ``LightweightIndex`` keyed on ``QueryKey``
    (``(graph_id, s, t, k, edge_mask_hash, graph_version)``; legacy
    all-int 4-tuple keys fold onto ``DEFAULT_GRAPH_ID`` via
    ``tenant_of``).  DESIGN.md §4, §8 and — for the ``graph_version``
    dimension — §12.

    A hit moves the entry to the MRU slot; inserting past ``capacity``
    evicts the global LRU entry.  On top of the global bound, each tenant
    may carry a *quota* (``set_quota``): inserting past it evicts that
    tenant's own LRU entry first, so a noisy tenant churns its own slice
    of the cache and never squeezes out its neighbors' entries.  Stats are
    kept both globally (``stats``) and per tenant (``stats_for``).
    Indexes are immutable once built, so sharing one object across
    queries, batches and tenants is safe.
    """

    def __init__(self, capacity: int = 256,
                 tenant_quotas: Optional[Dict[str, int]] = None) -> None:
        if capacity < 0:
            raise ValueError("capacity must be >= 0")
        self.capacity = capacity
        self.stats = CacheStats()
        self._entries: "collections.OrderedDict[QueryKey, LightweightIndex]" \
            = collections.OrderedDict()
        self._quotas: Dict[str, int] = {}
        self._tenant_stats: Dict[str, CacheStats] = {}
        # per-tenant LRU-ordered key index (mirrors _entries' recency per
        # tenant) so quota eviction pops a tenant's LRU in O(1) instead
        # of scanning the global OrderedDict
        self._tenant_keys: "Dict[str, collections.OrderedDict]" = {}
        for gid, quota in (tenant_quotas or {}).items():
            self.set_quota(gid, quota)

    def __len__(self) -> int:
        return len(self._entries)

    def tenant_len(self, graph_id: str) -> int:
        """Entries currently held for one tenant."""
        return len(self._tenant_keys.get(graph_id, ()))

    def stats_for(self, graph_id: str) -> CacheStats:
        """This tenant's live hit/miss/eviction counters (zero if never
        seen); the same mutable object is returned across calls, so
        ``snapshot``/``delta`` arithmetic works per tenant too."""
        return self._tenant_stats.setdefault(graph_id, CacheStats())

    def tenant_ids(self) -> Tuple[str, ...]:
        """Every tenant the cache knows about — ids holding live entries
        plus ids with historical stats (a retired tenant's counters
        survive ``drop_tenant`` for post-mortems, DESIGN.md §8).  This is
        the iteration surface of the metrics control plane (DESIGN.md
        §12)."""
        ids = dict.fromkeys(self._tenant_keys)
        ids.update(dict.fromkeys(self._tenant_stats))
        return tuple(ids)

    def quota_for(self, graph_id: str) -> Optional[int]:
        """The tenant's entry quota, or None when only the global
        ``capacity`` bounds it."""
        return self._quotas.get(graph_id)

    def set_quota(self, graph_id: str, quota: Optional[int]) -> None:
        """Bound (or unbound, with None) one tenant's entry count; if the
        tenant already exceeds the new quota its LRU entries are evicted
        immediately."""
        if quota is None:
            self._quotas.pop(graph_id, None)
            return
        if quota < 0:
            raise ValueError("tenant quota must be >= 0")
        self._quotas[graph_id] = quota
        while self.tenant_len(graph_id) > quota:
            self._evict_tenant_lru(graph_id)

    def get(self, key: QueryKey) -> Optional[LightweightIndex]:
        """Look one key up; a hit refreshes its LRU position.  Updates the
        global and the key's tenant counters."""
        tenant = tenant_of(key)
        tstats = self.stats_for(tenant)
        idx = self._entries.get(key)
        if idx is None:
            self.stats.misses += 1
            tstats.misses += 1
            return None
        self._entries.move_to_end(key)
        self._tenant_keys[tenant].move_to_end(key)
        self.stats.hits += 1
        tstats.hits += 1
        return idx

    def peek(self, key: QueryKey) -> Optional[LightweightIndex]:
        """The entry for one key, or None, leaving its LRU position and
        every counter as they are (for reports over the cache)."""
        return self._entries.get(key)

    def put(self, key: QueryKey, idx: LightweightIndex) -> None:
        """Insert (or refresh) one entry, evicting first the owning
        tenant's LRU past its quota, then the global LRU past
        ``capacity``.  A zero quota (or zero capacity) stores nothing."""
        tenant = tenant_of(key)
        quota = self._quotas.get(tenant)
        if self.capacity == 0 or quota == 0:
            return
        if key in self._entries:
            self._entries.move_to_end(key)
            self._tenant_keys[tenant].move_to_end(key)
            self._entries[key] = idx
            return
        if quota is not None:
            while self.tenant_len(tenant) >= quota:
                self._evict_tenant_lru(tenant)
        while len(self._entries) >= self.capacity:
            self._evict(next(iter(self._entries)))
        self._entries[key] = idx
        self._tenant_keys.setdefault(
            tenant, collections.OrderedDict())[key] = None

    def _evict(self, key: QueryKey) -> None:
        tenant = tenant_of(key)
        del self._entries[key]
        tkeys = self._tenant_keys[tenant]
        del tkeys[key]
        if not tkeys:
            del self._tenant_keys[tenant]
        self.stats.evictions += 1
        self.stats_for(tenant).evictions += 1

    def _evict_tenant_lru(self, graph_id: str) -> None:
        self._evict(next(iter(self._tenant_keys[graph_id])))

    def drop_tenant(self, graph_id: str) -> int:
        """Administratively drop every entry (and the quota) of one tenant
        — the cache half of retiring a tenant graph.  Returns the number
        of entries dropped; unlike quota/capacity pressure this is not
        counted as evictions (it is a retirement, not churn), but the
        tenant's historical stats survive for post-mortems."""
        doomed = self._tenant_keys.pop(graph_id, None) or ()
        for k in doomed:
            del self._entries[k]
        self._quotas.pop(graph_id, None)
        return len(doomed)

    def clear(self) -> None:
        """Drop all entries and reset stats (global and per-tenant) — a
        fresh-cache baseline, so post-clear hit/miss/eviction counters
        describe only the new epoch.  Tenant quotas survive: they are
        configuration, not state."""
        self._entries.clear()
        self._tenant_keys.clear()
        self._tenant_stats.clear()
        self.stats = CacheStats()


# ---------------------------------------------------------------------------
# Stacked BFS on the device: all cache-missing queries relax together
# ---------------------------------------------------------------------------

def batched_bounded_bfs(esrc: torch.Tensor, edst: torch.Tensor, n: int,
                        srcs: Sequence[int], excluded: Sequence[int],
                        kmax: int) -> torch.Tensor:
    """(Q, n) int32 bounded distances on the edge list's device.

    ``esrc`` / ``edst`` are int64 edge endpoints; row q relaxes along the
    edges from ``srcs[q]``.  Semantics are ``repro``'s
    ``batched_bounded_bfs`` (and ``oracle.bfs_dist_np``): row q's
    ``excluded[q]`` vertex relays nothing but may still receive a
    distance, and unreached vertices hold the sentinel ``kmax + 1``.
    Each hop relaxes row by row with one ``scatter_reduce("amin")`` over
    the edge list (``core.bfs.bfs_edge_relax`` per row), so the working
    set is a few (m,) vectors, never a (Q, m) matrix; the rows stop
    together once a hop changes nothing (one host read per hop).
    """
    dev = esrc.device
    Q = len(srcs)
    inf = kmax + 1
    dist = torch.full((Q, n), inf, dtype=torch.int32, device=dev)
    if Q == 0:
        return dist
    rows = torch.arange(Q, device=dev)
    dist[rows, torch.as_tensor(np.asarray(srcs, np.int64)).to(dev)] = 0
    if esrc.shape[0] == 0:
        return dist
    exc = [int(x) for x in excluded]
    for _ in range(kmax):
        new = torch.empty_like(dist)
        for q in range(Q):
            cand = torch.where(esrc == exc[q], inf,
                               dist[q].index_select(0, esrc) + 1)
            new[q] = dist[q].scatter_reduce(0, edst, cand, reduce="amin",
                                            include_self=True)
        new.clamp_(max=inf)
        if torch.equal(new, dist):
            break
        dist = new
    return dist


def batched_index_distances(graph: Graph,
                            queries: Sequence[Tuple[int, int, int]],
                            block: int = 128,
                            device: torch.device | str = "cuda"
                            ) -> List[Dists]:
    """Per-query host ``(dist_s, dist_t)`` for ``(s, t, k)`` queries,
    relaxed on ``device``.

    Stacks ``block`` queries' forward passes into one relaxation (and
    likewise the reverse passes), runs to the block's largest k, then
    clips each row to its own ``k + 1`` sentinel: values ≤ k equal the
    bounded queue BFS, so the index build downstream is byte-identical
    to the sequential path.  One host copy per block brings both
    directions back.
    """
    dg = graph.to(device)
    esrc, edst = dg.esrc.long(), dg.edst.long()
    step = max(block, 1)
    out: List[Dists] = []
    for lo in range(0, len(queries), step):
        chunk = queries[lo:lo + step]
        ss = [int(q[0]) for q in chunk]
        tt = [int(q[1]) for q in chunk]
        kk = [int(q[2]) for q in chunk]
        kmax = max(kk)
        ds = batched_bounded_bfs(esrc, edst, graph.n, ss, tt, kmax)
        dt = batched_bounded_bfs(edst, esrc, graph.n, tt, ss, kmax)
        cap = torch.tensor(kk, dtype=torch.int32).to(esrc.device)[:, None] + 1
        both = torch.stack([torch.minimum(ds, cap),
                            torch.minimum(dt, cap)]).cpu().numpy()
        out.extend((both[0, r].copy(), both[1, r].copy())
                   for r in range(len(chunk)))
    return out

# ---------------------------------------------------------------------------
# Batch results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchItem:
    """Per-query outcome inside a batch (duplicates share ``result``)."""
    s: int
    t: int
    k: int
    result: EnumResult
    plan: Plan
    index_cached: bool          # index came from the LRU (no build)
    deduplicated: bool          # enumeration reused an earlier item's result
    latency_seconds: float      # attributable work for THIS query
    shared: bool = False        # enumerated via a shared group walk (§13)
    fused: bool = False         # enumerated via a fused device launch (§9)


@dataclasses.dataclass
class BatchTiming:
    """Per-phase attributable seconds for one batch (DESIGN.md §4);
    component times are CPU work and merge as sums, the wall-clock span
    merges as interval union when a serving front-end merges batches."""
    distance_seconds: float = 0.0
    index_seconds: float = 0.0
    optimize_seconds: float = 0.0
    enumerate_seconds: float = 0.0
    total_seconds: float = 0.0
    # wall-clock span of the batch in time.perf_counter() coordinates;
    # lets concurrent batches merge as max-of-overlapping rather than a
    # sum.  0.0 = span unknown.
    started_at: float = 0.0
    ended_at: float = 0.0


@dataclasses.dataclass
class BatchOutput:
    """One ``BatchPathEnum.run``'s results: per-query items (input order),
    phase timing, the cache-stats delta observed during the run, and the
    tenant (``graph_id``) the batch ran against (DESIGN.md §4, §8)."""
    items: List[BatchItem]
    timing: BatchTiming
    cache_stats: CacheStats          # delta for this batch
    distinct_queries: int
    graph_id: str = DEFAULT_GRAPH_ID  # the tenant this batch served
    sharing_groups: int = 0          # shared walks executed (DESIGN.md §13)
    shared_queries: int = 0          # distinct queries served off a walk
    fused_queries: int = 0           # distinct queries in the fused launch
    fused_dispatches: int = 0        # kernel dispatches the fusion issued

    @property
    def counts(self) -> np.ndarray:
        """Per-query result counts, input order."""
        return np.array([it.result.count for it in self.items], np.int64)

    @property
    def enum_stats(self) -> EnumStats:
        """Merged Fig.-6 enumeration counters (edges accessed, partials,
        invalid partials, results, chunks) across the batch's *distinct*
        results — deduplicated items share their twin's ``EnumResult``
        object and are counted once, so the merge reflects work done,
        not work served."""
        agg = EnumStats()
        seen = set()
        for it in self.items:
            if id(it.result) in seen:
                continue
            seen.add(id(it.result))
            agg.merge(it.result.stats)
        return agg

    @property
    def total_results(self) -> int:
        """Sum of all per-query counts."""
        return int(self.counts.sum())

    def latency_percentiles(self, qs: Sequence[int] = (50, 90, 99)
                            ) -> Dict[str, float]:
        """Attributable per-query latency percentiles in milliseconds."""
        lats = np.array([it.latency_seconds for it in self.items])
        if lats.size == 0:
            return {f"p{q}_ms": 0.0 for q in qs}
        return {f"p{q}_ms": float(np.percentile(lats, q) * 1e3) for q in qs}

    @property
    def throughput_qps(self) -> float:
        """Queries served per wall-clock second of this batch."""
        return len(self.items) / max(self.timing.total_seconds, 1e-12)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

class BatchPathEnum:
    """Batched front-end over the Figure-2 pipeline (DESIGN.md §4, §8).

    Accepts ``(s, t, k)`` triples against one graph per call; shares work
    across the batch (dedup, index LRU, stacked BFS, sharing, fused
    launches) and across calls (the LRU persists on the engine).  Each
    ``run`` names its tenant via ``graph_id``.  ``device`` is where the
    stacked BFS runs and the indexes' kernels run ("cuda" by default;
    "cpu" runs the plain versions); ``backend`` ("device" by default,
    "host" or "auto") steers IDX-DFS expansion and the DP as in
    ``PathEnum``.  ``sharing`` and ``fused`` ("auto" | "off") switch the
    two cross-query levers; results are byte-identical either way.
    """

    def __init__(self, tau: float = DEFAULT_TAU, chunk_size: int = 16384,
                 max_partials: Optional[int] = 20_000_000,
                 cache_capacity: int = 256, bfs_block: int = 128,
                 tenant_quotas: Optional[Dict[str, int]] = None,
                 backend: str = "device", sharing: str = "auto",
                 fused: str = "auto",
                 device: torch.device | str = "cuda") -> None:
        if sharing not in ("auto", "off"):
            raise ValueError(f"unknown sharing mode {sharing!r}")
        if fused not in ("auto", "off"):
            raise ValueError(f"unknown fused mode {fused!r}")
        self.device = resolve_device(device)
        self.engine = PathEnum(tau=tau, chunk_size=chunk_size,
                               max_partials=max_partials, backend=backend,
                               device=self.device)
        self.cache = IndexCache(capacity=cache_capacity,
                                tenant_quotas=tenant_quotas)
        self.bfs_block = bfs_block
        self.sharing = sharing
        self.fused = fused
        self.group_cache = sharing_mod.GroupIndexCache(capacity=64)

    # -- index acquisition --------------------------------------------------
    def _indexes_for(self, graph: Graph, keys: List[QueryKey],
                     edge_mask: Optional[np.ndarray],
                     precomputed: Optional[Dict[QueryKey, Dists]],
                     timing: BatchTiming,
                     group_builds: bool = False
                     ) -> Dict[QueryKey, Tuple[LightweightIndex, bool]]:
        """Resolve each distinct key to (index, was_cached).

        Cache misses on the unmasked graph batch their BFS passes through
        the stacked relaxation; masked queries build one by one (the mask
        changes the graph under the BFS).  With ``group_builds`` (sharing
        on) masked batches filter the graph once and stack their BFS on
        it, and misses sharing an s or t build over one edge arena
        (``sharing.build_member_indexes``); both are byte-identical to
        the solo build.
        """
        resolved: Dict[QueryKey, Tuple[LightweightIndex, bool]] = {}
        missing: List[QueryKey] = []
        for key in keys:
            if key in resolved:
                # a duplicate shares the resolved (or in-flight) build: a
                # hit, counted globally and for its tenant alike
                self.cache.stats.hits += 1
                self.cache.stats_for(tenant_of(key)).hits += 1
                continue
            idx = self.cache.get(key)
            if idx is not None:
                resolved[key] = (idx, True)
            else:
                resolved[key] = (None, False)  # type: ignore[assignment]
                missing.append(key)

        if not missing:
            return resolved
        trace.count("index.misses", len(missing))

        dists: Dict[QueryKey, Dists] = {}
        if precomputed:
            dists.update({k: precomputed[k] for k in missing
                          if k in precomputed})
        unmasked = [k for k in missing if k[4] == 0 and k not in dists]
        if unmasked:
            t0 = time.perf_counter()
            with trace.span("index.distances"):
                dists.update(self._stacked_dists(graph, unmasked,
                                                 group_builds))
            timing.distance_seconds += time.perf_counter() - t0

        build_graph = graph
        eff_mask = edge_mask
        if group_builds and edge_mask is not None and len(missing) > 1:
            # one filtered graph serves every masked miss; building on it
            # (mask dropped) is byte-identical to the per-key masked
            # build, which constructs exactly this graph internally
            t0 = time.perf_counter()
            keep = np.asarray(edge_mask, dtype=bool)
            edges = np.stack([graph.esrc[keep], graph.edst[keep]], axis=1)
            build_graph = from_edges(graph.n, edges, dedup=False)
            eff_mask = None
            masked_missing = [kk for kk in missing if kk not in dists]
            if masked_missing:
                with trace.span("index.distances"):
                    dists.update(self._stacked_dists(
                        build_graph, masked_missing, group_builds))
            timing.distance_seconds += time.perf_counter() - t0

        built: Dict[QueryKey, LightweightIndex] = {}
        if group_builds:
            groupable = [kk for kk in missing if kk in dists]
            for grp in sharing_mod.detect_groups(groupable):
                t0 = time.perf_counter()
                with trace.span("index.build"):
                    idxs = sharing_mod.build_member_indexes(
                        build_graph,
                        [(kk[1], kk[2], kk[3]) for kk in grp.keys],
                        [dists[kk] for kk in grp.keys], device=self.device)
                timing.index_seconds += time.perf_counter() - t0
                built.update(zip(grp.keys, idxs))

        for key in missing:
            _, s, t, k, _mh, _gv = key
            t0 = time.perf_counter()
            if key in built:
                idx = built[key]
            elif key in dists:
                # the mask still filters the edge set when the distances
                # are given (they were computed on the filtered graph)
                d_s, d_t = dists[key]
                with trace.span("index.build"):
                    idx = build_index(build_graph, s, t, k,
                                      dist_fn=lambda *_a, _d=(d_s, d_t): _d,
                                      edge_mask=eff_mask, device=self.device)
            else:  # masked query: the BFS runs on the filtered graph
                with trace.span("index.build"):
                    idx = build_index(build_graph, s, t, k,
                                      edge_mask=eff_mask, device=self.device)
            timing.index_seconds += time.perf_counter() - t0
            self.cache.put(key, idx)
            resolved[key] = (idx, False)
        return resolved

    def _stacked_dists(self, graph: Graph, keys: List[QueryKey],
                       dedup_pairs: bool
                       ) -> Dict[QueryKey, Dists]:
        """Stacked device BFS for a list of distinct keys.

        With ``dedup_pairs`` (sharing on) the BFS runs one row per
        distinct ``(s, t)`` pair at the pair's largest k and clips each
        key's copy to its own ``k + 1`` sentinel, which is byte-identical
        to per-key rows.
        """
        if not dedup_pairs:
            stacked = batched_index_distances(
                graph, [(s, t, k) for (_, s, t, k, _, _) in keys],
                block=self.bfs_block, device=self.device)
            return dict(zip(keys, stacked))
        pair_k: Dict[Tuple[int, int], int] = {}
        for (_, s, t, k, _mh, _gv) in keys:
            pair_k[(s, t)] = max(pair_k.get((s, t), 0), k)
        pairs = list(pair_k)
        stacked = batched_index_distances(
            graph, [(s, t, pair_k[(s, t)]) for (s, t) in pairs],
            block=self.bfs_block, device=self.device)
        by_pair = dict(zip(pairs, stacked))
        out: Dict[QueryKey, Dists] = {}
        for key in keys:
            _, s, t, k, _mh, _gv = key
            d_s, d_t = by_pair[(s, t)]
            out[key] = (np.minimum(d_s, k + 1).astype(np.int32),
                        np.minimum(d_t, k + 1).astype(np.int32))
        return out

    # -- planning -----------------------------------------------------------
    def _plan_for(self, idx: LightweightIndex, k: int, mode: str) -> Plan:
        """One distinct query's plan under the batch ``mode`` knob; the
        engine backend steers where the full DP runs."""
        with trace.span("planner.plan"):
            if mode == "auto":
                return planner_mod.plan_query(idx, tau=self.engine.tau,
                                              backend=self.engine.backend)
            if mode == "dfs":
                return Plan(method="dfs", cut=None, preliminary=-1.0,
                            used_full_estimator=False)
            if mode == "join":
                dp_plan = planner_mod.plan_query(idx, tau=-1.0,
                                                 backend=self.engine.backend)
                cut = dp_plan.cut if dp_plan.cut else max(1, k // 2)
                return Plan(method="join", cut=cut, preliminary=-1.0,
                            used_full_estimator=True)
            raise ValueError(f"unknown mode {mode!r}")

    # -- enumeration --------------------------------------------------------
    def _enumerate(self, idx: LightweightIndex, plan: Plan, count_only: bool,
                   first_n: Optional[int], deadline: Optional[float],
                   order: Optional[str] = None,
                   weights: Optional[np.ndarray] = None) -> EnumResult:
        """One query's solo enumeration under its plan."""
        if plan.method == "dfs":
            with trace.span("enumeration.dfs"):
                return enumerate_paths_idx(
                    idx, chunk_size=self.engine.chunk_size,
                    count_only=count_only, first_n=first_n,
                    deadline=deadline, backend=self.engine.backend,
                    order=order, weights=weights, device=idx.device)
        with trace.span("enumeration.join"):
            return enumerate_paths_join(
                idx, cut=plan.cut, count_only=count_only, first_n=first_n,
                max_partials=self.engine.max_partials, deadline=deadline,
                order=order, weights=weights)

    def run(self, graph: Graph, queries: Sequence[Tuple[int, int, int]],
            count_only: bool = True, first_n: Optional[int] = None,
            mode: str = "auto", edge_mask: Optional[np.ndarray] = None,
            deadline: Optional[float] = None,
            graph_id: str = DEFAULT_GRAPH_ID,
            order: Optional[str] = None,
            weights: Optional[np.ndarray] = None,
            sharing: Optional[str] = None,
            _precomputed_distances: Optional[Dict[QueryKey, Dists]] = None,
            ) -> BatchOutput:
        """Serve a batch; returns per-query items in input order.

        ``sharing`` overrides the engine's sharing knob for this run
        (``REPRO_SHARING=off`` forces it off).  ``graph_id`` names the
        tenant ``graph`` belongs to and prefixes every cache key of the
        run.  ``deadline`` (absolute ``core.clock.now()``) stops
        enumeration at the next chunk boundary after it passes; queries
        not yet enumerated return empty with ``exhausted=False``.
        ``_precomputed_distances`` injects ``(dist_s, dist_t)`` per full
        ``QueryKey`` so the build skips its BFS (for a masked key they
        must come from the filtered graph).  ``order`` requests ranked
        enumeration for the whole batch (DESIGN.md §10): each query's
        paths come back in non-decreasing hop or weight rank
        (``weights``: graph edge order, non-negative), ``first_n`` is the
        per-query top n and a deadline truncation a rank-optimal prefix.
        """
        # the query count now, the distinct count once the keys are made
        attrs = {"queries": len(queries)} if trace.enabled() else None
        with trace.span("engine.run", attrs):
            rank.make_rank_spec(order, weights)
            t_batch = time.perf_counter()
            timing = BatchTiming()
            stats_before = self.cache.stats.snapshot()
            for (s, t, k) in queries:
                if k < 2:
                    raise ValueError("paper assumes k >= 2")
                if s == t:
                    raise ValueError("s and t must be distinct")
            mh = edge_mask_hash(edge_mask)
            gv = int(graph.version)
            keys = [(graph_id, int(s), int(t), int(k), mh, gv)
                    for (s, t, k) in queries]
            if attrs is not None:
                attrs["distinct"] = len(dict.fromkeys(keys))
            eff_sharing: str = sharing_mod.resolve_sharing(
                self.sharing if sharing is None else sharing)

            with trace.span("index.resolve"):
                resolved = self._indexes_for(
                    graph, keys, edge_mask, _precomputed_distances, timing,
                    group_builds=eff_sharing == "auto")

            # sharing phase (DESIGN.md §13): plan the distinct keys up front,
            # then serve whole overlap groups off one shared prefix walk.
            # Ranked batches opt out (a shared walk does not emit in rank
            # order) and keep construction sharing only
            shared_results: Dict[QueryKey, EnumResult] = {}
            shared_latency: Dict[QueryKey, float] = {}
            plans_pre: Dict[QueryKey, Plan] = {}
            plan_wall: Dict[QueryKey, float] = {}
            n_groups = 0

            def plan_all() -> None:
                for key in keys:
                    if key in plans_pre:
                        continue
                    t0 = time.perf_counter()
                    plan = self._plan_for(resolved[key][0], key[3], mode)
                    plan_wall[key] = time.perf_counter() - t0
                    timing.optimize_seconds += plan.optimize_seconds
                    plans_pre[key] = plan

            if eff_sharing == "auto" and order is None:
                plan_all()
                if len(plans_pre) > 1:
                    t1 = time.perf_counter()
                    with trace.span("enumeration.shared"):
                        shared_results, shared_latency, n_groups = \
                            sharing_mod.run_shared_groups(
                                self, resolved, plans_pre,
                                count_only=count_only, first_n=first_n,
                                deadline=deadline, graph_id=graph_id)
                    timing.enumerate_seconds += time.perf_counter() - t1

            # fused device phase (DESIGN.md §9): the remaining dfs-plan
            # queries that resolve to the device backend expand together,
            # one K5 launch per round for the whole batch; ranked batches
            # keep the solo path
            fused_results: Dict[QueryKey, EnumResult] = {}
            fused_latency: Dict[QueryKey, float] = {}
            fused_dispatches = 0
            if order is None and self.fused != "off" \
                    and self.engine.backend in ("device", "auto"):
                plan_all()
                elig = [kk for kk in dict.fromkeys(keys)
                        if kk not in shared_results
                        and plans_pre[kk].method == "dfs"
                        and resolve_backend(resolved[kk][0],
                                            self.engine.backend) == "device"]
                if len(elig) >= 2:
                    t1 = time.perf_counter()
                    before = kops.device_dispatch_count()
                    with trace.span("enumeration.fused"):
                        res_list = fused_mod.enumerate_fused_device(
                            [resolved[kk][0] for kk in elig],
                            chunk_size=self.engine.chunk_size,
                            count_only=count_only, first_n=first_n,
                            deadline=deadline)
                    fused_dispatches = kops.device_dispatch_count() - before
                    wall = time.perf_counter() - t1
                    timing.enumerate_seconds += wall
                    fused_results = dict(zip(elig, res_list))
                    share = wall / len(elig)
                    fused_latency = {kk: share for kk in elig}

            items: List[Optional[BatchItem]] = [None] * len(keys)
            memo: Dict[QueryKey, BatchItem] = {}
            for pos, key in enumerate(keys):
                t0 = time.perf_counter()
                prior = memo.get(key)
                if prior is not None:
                    items[pos] = dataclasses.replace(
                        prior, deduplicated=True, index_cached=True,
                        latency_seconds=time.perf_counter() - t0)
                    continue
                idx, was_cached = resolved[key]
                plan_opt = plans_pre.get(key)
                if plan_opt is None:
                    plan = self._plan_for(idx, key[3], mode)
                    timing.optimize_seconds += plan.optimize_seconds
                else:
                    plan = plan_opt
                res_opt = shared_results.get(key)
                fused_opt = fused_results.get(key)
                if res_opt is not None:
                    res = res_opt
                    extra = shared_latency[key] + plan_wall.get(key, 0.0)
                elif fused_opt is not None:
                    res = fused_opt
                    extra = fused_latency[key] + plan_wall.get(key, 0.0)
                else:
                    extra = plan_wall.get(key, 0.0)
                    t1 = time.perf_counter()
                    res = self._enumerate(idx, plan, count_only, first_n,
                                          deadline, order=order,
                                          weights=weights)
                    timing.enumerate_seconds += time.perf_counter() - t1
                item = BatchItem(s=key[1], t=key[2], k=key[3], result=res,
                                 plan=plan, index_cached=was_cached,
                                 deduplicated=False,
                                 latency_seconds=(time.perf_counter() - t0
                                                  + extra),
                                 shared=res_opt is not None,
                                 fused=fused_opt is not None)
                memo[key] = item
                items[pos] = item

            timing.started_at = t_batch
            timing.ended_at = time.perf_counter()
            timing.total_seconds = timing.ended_at - t_batch
            return BatchOutput(items=list(items),  # type: ignore[arg-type]
                               timing=timing,
                               cache_stats=self.cache.stats.delta(
                                   stats_before),
                               distinct_queries=len(memo), graph_id=graph_id,
                               sharing_groups=n_groups,
                               shared_queries=len(shared_results),
                               fused_queries=len(fused_results),
                               fused_dispatches=fused_dispatches)

    def counts(self, graph: Graph, queries: Sequence[Tuple[int, int, int]],
               **kw) -> np.ndarray:
        """``run(..., count_only=True)`` reduced to the per-query count
        vector."""
        return self.run(graph, queries, count_only=True, **kw).counts
