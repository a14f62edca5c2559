"""HcPE batch serving front-end (the port of ``repro.serving.hcpe``;
DESIGN.md §4, tenancy §8).

Request/response dataclasses around ``core.batch.BatchPathEnum``: a
server owns a ``GraphRegistry`` of tenant graphs (or one bare graph,
wrapped) plus one engine, whose tenant-keyed index LRU persists across
batches; it turns a list of ``PathQueryRequest`` into
``PathQueryResponse`` objects and reports batch-level serving metrics:
latency percentiles, throughput, and cache reuse (global and per
tenant).  This is the paper's online scenario (§7.1) as a service API.

The port's default engine is its own default: ``backend="device"`` on
``device="cuda"`` (K1, K2 and K5 on the card), raising without a card.
``repro``'s front-ends default to its host backend; callers that want the
CPU pass ``device="cpu"`` (the plain versions), or hand in an engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING, Union

import numpy as np
import torch

from ..core.batch import (BatchItem, BatchOutput, BatchPathEnum, BatchTiming,
                          CacheStats, DEFAULT_GRAPH_ID)
from ..core import trace
from ..core.enumerate import EnumStats
from ..core.graph import Graph
from .registry import GraphRegistry

if TYPE_CHECKING:  # deferred: metrics imports this module at runtime
    from .metrics import MetricsSnapshot


# Response statuses.  Rejections are *responses*, not exceptions: an
# admission-controlled server must answer every request it saw, and a
# client telling rejected from crashed needs the distinction in-band.
STATUS_OK = "ok"
STATUS_REJECTED_QUEUE_FULL = "rejected_queue_full"
STATUS_REJECTED_QUOTA = "rejected_quota"
STATUS_REJECTED_TENANT_QUOTA = "rejected_tenant_quota"
STATUS_REJECTED_UNKNOWN_GRAPH = "rejected_unknown_graph"
STATUS_REJECTED_SHUTDOWN = "rejected_shutdown"
STATUS_REJECTED_NO_WEIGHTS = "rejected_no_weights"


@dataclasses.dataclass
class PathQueryRequest:
    """One HcPE query q(s, t, k) plus serving options (DESIGN.md §4, §8).

    ``graph_id`` names the tenant graph the query runs against; the
    default id is the single-graph compatibility contract — servers built
    from a bare ``Graph`` serve it under ``DEFAULT_GRAPH_ID`` and every
    pre-tenancy call site works unchanged.

    ``deadline_ms`` is the per-request SLO (relative to submission).  The
    sync server ignores it; the async front-end (async_server.py) uses it
    for earliest-deadline-first scheduling and the ``slo_met`` flag, and —
    when deadline enforcement is on — as the cooperative enumeration
    budget of its micro-batch.

    ``order`` requests ranked (any-k) enumeration (DESIGN.md §10):
    ``"hops"`` needs nothing extra; ``"weight"`` ranks by the tenant's
    registered ``edge_weights`` — tenants without weights reject such
    requests with ``STATUS_REJECTED_NO_WEIGHTS``.  Under ``order``,
    ``first_n`` means the top-n and every deadline truncation is a
    rank-optimal prefix, which is what turns the async server's EDF
    truncations from "some paths" into "the best paths seen so far".
    """
    uid: int
    s: int
    t: int
    k: int
    count_only: bool = True
    first_n: Optional[int] = None     # response-time mode: first-n results
    deadline_ms: Optional[float] = None
    graph_id: str = DEFAULT_GRAPH_ID  # tenant graph (DESIGN.md §8)
    order: Optional[str] = None       # ranked mode (DESIGN.md §10)


@dataclasses.dataclass
class PathQueryResponse:
    """The wire response for one ``PathQueryRequest`` (DESIGN.md §4, §8):
    result payload, plan/cache observability, the end-to-end latency
    split, and the admission status (``STATUS_*``; ``rejected`` requests
    carry zero results, never an exception)."""
    uid: int
    count: int
    paths: Optional[np.ndarray]       # (r, k+1) int32 when materialized
    plan_method: str
    index_cached: bool                # served off the warm index LRU
    deduplicated: bool                # shared an identical in-batch query
    latency_ms: float                 # attributable engine work for this query
    exhausted: bool = True            # False: truncated by first_n / deadline
    status: str = STATUS_OK
    # end-to-end latency split (async front-end; sync leaves queue at 0)
    queue_ms: float = 0.0             # submission -> micro-batch dispatch
    service_ms: float = 0.0           # dispatch -> response ready
    total_ms: float = 0.0             # submission -> response ready
    slo_met: Optional[bool] = None    # None: request carried no deadline
    graph_id: str = DEFAULT_GRAPH_ID  # tenant that served (or rejected) it

    @property
    def rejected(self) -> bool:
        """True when the request was shed at admission (any non-OK
        status): no engine work happened for it."""
        return self.status != STATUS_OK


@dataclasses.dataclass
class BatchServeReport:
    """Per-batch serving metrics (the paper's Table-3 axes, batch form;
    DESIGN.md §4).  ``cache`` is the batch-level delta; ``tenant_cache``
    splits it by ``graph_id`` so per-tenant reuse (and eviction churn) is
    observable per serve call (DESIGN.md §8).  ``enum_stats`` carries the
    merged Fig.-6 enumeration counters of the batch's distinct results —
    including ``chunks``, the one field earlier aggregation dropped."""
    batch_size: int
    distinct_queries: int
    total_results: int
    wall_seconds: float
    throughput_qps: float             # queries / s for the batch
    results_per_second: float
    p50_ms: float
    p90_ms: float
    p99_ms: float
    cache: CacheStats                 # hits/misses/evictions for this batch
    enum_stats: EnumStats = dataclasses.field(
        default_factory=EnumStats)    # merged Fig.-6 enumeration counters
    tenant_cache: Dict[str, CacheStats] = dataclasses.field(
        default_factory=dict)         # the same delta, split per graph_id
    sharing_groups: int = 0           # structure-sharing groups (§13)
    shared_queries: int = 0           # queries served off a shared walk

    @property
    def chunks(self) -> int:
        """Enumeration chunks processed for this batch's distinct results
        — the work-granularity counter behind the cooperative deadline
        budget, surfaced from ``enum_stats`` so chunk-level load is
        observable per serve call."""
        return self.enum_stats.chunks

    @classmethod
    def from_output(cls, out: BatchOutput) -> "BatchServeReport":
        """Fold one (possibly merged) engine output into a report."""
        pct = out.latency_percentiles((50, 90, 99))
        wall = out.timing.total_seconds
        return cls(batch_size=len(out.items),
                   distinct_queries=out.distinct_queries,
                   total_results=out.total_results,
                   wall_seconds=wall,
                   throughput_qps=out.throughput_qps,
                   results_per_second=out.total_results / max(wall, 1e-12),
                   p50_ms=pct["p50_ms"], p90_ms=pct["p90_ms"],
                   p99_ms=pct["p99_ms"], cache=out.cache_stats,
                   enum_stats=out.enum_stats,
                   sharing_groups=out.sharing_groups,
                   shared_queries=out.shared_queries)

    @classmethod
    def from_outputs(cls, outputs: List[BatchOutput]) -> "BatchServeReport":
        """Merge per-group outputs (``_merge_outputs`` semantics) and keep
        the per-tenant cache-delta split that the merge would flatten."""
        report = cls.from_output(_merge_outputs(outputs))
        tenant: Dict[str, CacheStats] = {}
        for o in outputs:
            agg = tenant.setdefault(o.graph_id, CacheStats())
            agg.hits += o.cache_stats.hits
            agg.misses += o.cache_stats.misses
            agg.evictions += o.cache_stats.evictions
        report.tenant_cache = tenant
        return report


# ---------------------------------------------------------------------------
# Grouping / response assembly — one code path shared by the sync server
# below and the async front-end (async_server.py)
# ---------------------------------------------------------------------------

# (graph_id, count_only, first_n, order)
GroupKey = Tuple[str, bool, Optional[int], Optional[str]]


def request_group_key(req: PathQueryRequest) -> GroupKey:
    """The engine-batch compatibility key: requests sharing it can be
    served by one ``BatchPathEnum.run`` call (the engine takes the graph,
    count_only, first_n and order per batch, not per query — so the
    tenant dimension groups first, DESIGN.md §8).  Both front-ends derive
    their grouping from this one function — extend it here, never
    inline."""
    return (req.graph_id, req.count_only, req.first_n, req.order)


def group_requests(requests: Sequence[PathQueryRequest],
                   ) -> Dict[GroupKey, List[int]]:
    """Positions of ``requests`` grouped by their serving options;
    positions let the caller reassemble responses in request order."""
    groups: Dict[GroupKey, List[int]] = {}
    for pos, req in enumerate(requests):
        groups.setdefault(request_group_key(req), []).append(pos)
    return groups


def response_from_item(req: PathQueryRequest,
                       item: BatchItem) -> PathQueryResponse:
    """Fold one engine ``BatchItem`` into the wire response for ``req``."""
    return PathQueryResponse(
        uid=req.uid, count=item.result.count,
        paths=None if req.count_only else item.result.paths,
        plan_method=item.plan.method,
        index_cached=item.index_cached,
        deduplicated=item.deduplicated,
        latency_ms=item.latency_seconds * 1e3,
        exhausted=item.result.exhausted,
        graph_id=req.graph_id)


def rejection_response(req: PathQueryRequest, status: str,
                       queue_ms: float = 0.0) -> PathQueryResponse:
    """An admission-control rejection as a well-formed response."""
    slo_met = False if req.deadline_ms is not None else None
    return PathQueryResponse(
        uid=req.uid, count=0, paths=None, plan_method="none",
        index_cached=False, deduplicated=False, latency_ms=0.0,
        exhausted=False, status=status, queue_ms=queue_ms,
        service_ms=0.0, total_ms=queue_ms, slo_met=slo_met,
        graph_id=req.graph_id)


class HcPEServer:
    """Batch HcPE serving over a registry of tenant graphs (DESIGN.md §4,
    §8) — or one bare graph, which wraps into a single-tenant registry
    under ``DEFAULT_GRAPH_ID`` (the pre-tenancy call sites run unchanged).

    Groups requests by their (graph_id, count_only, first_n) serving
    options — each group is one BatchPathEnum.run against its tenant's
    graph — and reassembles responses in request order.  Requests naming
    an unregistered ``graph_id`` come back as
    ``STATUS_REJECTED_UNKNOWN_GRAPH`` responses, never exceptions.  The
    engine (and therefore the tenant-keyed index LRU) is shared across
    groups, tenants and serve() calls.  The call blocks until the whole
    batch finishes; for an online workload with per-request SLOs use
    ``AsyncHcPEServer`` (async_server.py), which shares these helpers.
    """

    def __init__(self, graph: Union[Graph, GraphRegistry],
                 engine: Optional[BatchPathEnum] = None,
                 backend: str = "device",
                 sharing: str = "auto",
                 device: torch.device | str = "cuda") -> None:
        self.registry = GraphRegistry.wrap(graph)
        # `backend`, `sharing` and `device` configure the
        # default-constructed engine (DESIGN.md §9, §13); callers handing
        # their own engine set them there instead.
        self.engine = engine or BatchPathEnum(backend=backend,
                                              sharing=sharing,
                                              device=device)
        self.registry.bind_engine(self.engine)
        # lifetime Fig.-6 counters across serve() calls, feeding the
        # metrics control plane (serving/metrics.py, DESIGN.md §12)
        self.enum_totals = EnumStats()

    def metrics_snapshot(self) -> "MetricsSnapshot":
        """One consistent ``serving.metrics.MetricsSnapshot`` of this
        server: per-tenant cache and quota state, graph versions, and
        lifetime Fig.-6 enumeration totals (DESIGN.md §12).  The sync
        server has no admission control, so the snapshot's ``serve``
        block is absent (None)."""
        from .metrics import snapshot
        return snapshot(self)

    @property
    def graph(self) -> Optional[Graph]:
        """The default tenant's graph (back-compat accessor for
        single-graph callers); None when no default tenant exists."""
        if DEFAULT_GRAPH_ID in self.registry:
            return self.registry.get(DEFAULT_GRAPH_ID)
        return None

    def serve(self, requests: Sequence[PathQueryRequest],
              ) -> Tuple[List[PathQueryResponse], BatchServeReport]:
        """Serve one request batch; responses come back in request order,
        alongside the batch-level ``BatchServeReport`` (latency
        percentiles, throughput, cache deltas global + per tenant)."""
        attrs = ({"uids": [r.uid for r in requests]} if trace.enabled()
                 else None)
        with trace.span("serve", attrs):
            responses: List[Optional[PathQueryResponse]] = \
                [None] * len(requests)
            outputs: List[BatchOutput] = []
            for key, positions in group_requests(requests).items():
                graph_id, count_only, first_n, order = key
                if graph_id not in self.registry:
                    for p in positions:
                        responses[p] = rejection_response(
                            requests[p], STATUS_REJECTED_UNKNOWN_GRAPH)
                    continue
                weights = None
                if order == "weight":
                    weights = self.registry.entry(graph_id).edge_weights
                    if weights is None:
                        for p in positions:
                            responses[p] = rejection_response(
                                requests[p], STATUS_REJECTED_NO_WEIGHTS)
                        continue
                queries = [(requests[p].s, requests[p].t, requests[p].k)
                           for p in positions]
                out = self.engine.run(self.registry.get(graph_id), queries,
                                      count_only=count_only, first_n=first_n,
                                      graph_id=graph_id, order=order,
                                      weights=weights)
                outputs.append(out)
                self.enum_totals.merge(out.enum_stats)
                for p, item in zip(positions, out.items):
                    resp = response_from_item(requests[p], item)
                    resp.service_ms = resp.total_ms = resp.latency_ms
                    responses[p] = resp
            report = BatchServeReport.from_outputs(outputs)
            # the per-group sum double-counts a (s,t,k) served under several
            # serving options; the request list is the truth (rejected
            # requests did no engine work and don't count)
            report.distinct_queries = len(
                {(r.graph_id, r.s, r.t, r.k) for r in requests
                 if r.graph_id in self.registry})
            return list(responses), report  # type: ignore[arg-type]


def _interval_union_seconds(spans: List[Tuple[float, float]]) -> float:
    """Total length covered by a set of [start, end] intervals."""
    total = 0.0
    hi = -math.inf
    for start, end in sorted(spans):
        if end <= hi:
            continue
        total += end - max(start, hi)
        hi = end
    return total


def _merge_outputs(outputs: List[BatchOutput]) -> BatchOutput:
    """Fold the per-group outputs into one batch-level view.

    ``serve([])`` produces no groups, hence no outputs: fold to a
    well-formed zero output so BatchServeReport.from_output reports
    all-zero percentiles/throughput rather than taking statistics of an
    empty latency list.

    Wall time merges as the *union of the groups' busy intervals* in
    perf_counter coordinates: concurrent groups (the async scheduler) do
    not double-count their overlap the way summing per-group walls would,
    and idle gaps between micro-batches (a drained async server between
    traffic bursts) are not billed as serving time the way a max-end
    minus min-start span would.  For back-to-back sequential groups the
    union equals the sum.  Component times (distance/index/optimize/
    enumerate) remain sums: they are attributable CPU work, not elapsed
    time.  Outputs lacking span timestamps (hand-built, e.g. in tests)
    fall back to the sum.
    """
    if not outputs:
        return BatchOutput(items=[], timing=BatchTiming(),
                           cache_stats=CacheStats(), distinct_queries=0)
    if len(outputs) == 1:
        return outputs[0]
    items = [it for o in outputs for it in o.items]
    timing = dataclasses.replace(outputs[0].timing)
    for o in outputs[1:]:
        timing.distance_seconds += o.timing.distance_seconds
        timing.index_seconds += o.timing.index_seconds
        timing.optimize_seconds += o.timing.optimize_seconds
        timing.enumerate_seconds += o.timing.enumerate_seconds
        timing.total_seconds += o.timing.total_seconds
    if all(o.timing.ended_at > o.timing.started_at > 0.0 for o in outputs):
        timing.started_at = min(o.timing.started_at for o in outputs)
        timing.ended_at = max(o.timing.ended_at for o in outputs)
        timing.total_seconds = _interval_union_seconds(
            [(o.timing.started_at, o.timing.ended_at) for o in outputs])
    cache = CacheStats()
    for o in outputs:
        cache.hits += o.cache_stats.hits
        cache.misses += o.cache_stats.misses
        cache.evictions += o.cache_stats.evictions
    return BatchOutput(items=items, timing=timing, cache_stats=cache,
                       distinct_queries=sum(o.distinct_queries
                                            for o in outputs),
                       sharing_groups=sum(o.sharing_groups
                                          for o in outputs),
                       shared_queries=sum(o.shared_queries
                                          for o in outputs))
