"""Async deadline-aware HcPE serving front-end (the port of
``repro.serving.async_server``; DESIGN.md §7).

``HcPEServer.serve`` is a blocking batch call: one heavy (s, t, k) query
stalls every request queued behind it.  This module puts an asyncio
front-end over the same ``BatchPathEnum`` engine:

  * **request queue + admission control**: ``submit`` bounds the queue
    (``max_queue_depth``), the per-uid and the per-tenant in-flight
    counts; rejected requests get an explicit ``PathQueryResponse``
    status (hcpe.STATUS_REJECTED_*), never an exception.
  * **deadline-aware micro-batching**: accepted requests accumulate for
    a batching window, then coalesce into engine batches of identical
    serving options (``hcpe.request_group_key``) *and* nearby deadlines
    (``deadline_slack_ms``).
  * **earliest-deadline-first dispatch**: the pending set is re-sorted
    by absolute deadline before every micro-batch.
  * **non-blocking service**: each micro-batch runs in a worker thread
    via ``asyncio.to_thread``; the event loop keeps admitting (and
    rejecting) requests while enumeration is busy.  Every device sync
    (a kernel's read-back) happens in that worker, never in an
    ``async def`` body; the worker enters the engine's CUDA device first,
    so no launch depends on which device the pool thread has current.

Every response carries the queue/service/total latency split and an
``slo_met`` flag.  With ``enforce_deadlines=True`` the group's deadline
is handed to ``BatchPathEnum.run`` as the cooperative enumeration budget,
so an in-flight batch stops at the next chunk boundary past its deadline
(on the device path: after the K2 round or K1 hop in flight) and reports
``exhausted=False``.  Left off (the default), deadlines shape scheduling
order and reporting only, and results stay byte-identical to the sync
engine.  Deadlines read the port's own ``core.clock``.

Requests carrying ``order=`` run ranked (DESIGN.md §10), which turns an
enforced deadline's truncation into a rank-optimal prefix: the engine
emits in non-decreasing rank.  ``order="weight"`` requires the tenant's
registry entry to carry ``edge_weights``; submissions against weightless
tenants resolve to ``STATUS_REJECTED_NO_WEIGHTS``.
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import itertools
import math
from typing import Deque, Dict, List, Optional, Sequence, Tuple, TYPE_CHECKING

from typing import Union

import torch

if TYPE_CHECKING:  # deferred: metrics imports this module at runtime
    from .metrics import MetricsSnapshot

from ..core import clock
from ..core.batch import BatchOutput, BatchPathEnum, DEFAULT_GRAPH_ID
from ..core.enumerate import EnumStats
from ..core.graph import Graph
from ..core.rank import ORDERS
from .hcpe import (BatchServeReport, PathQueryRequest, PathQueryResponse,
                   STATUS_REJECTED_NO_WEIGHTS, STATUS_REJECTED_QUEUE_FULL,
                   STATUS_REJECTED_QUOTA, STATUS_REJECTED_SHUTDOWN,
                   STATUS_REJECTED_TENANT_QUOTA,
                   STATUS_REJECTED_UNKNOWN_GRAPH, rejection_response,
                   request_group_key, response_from_item)
from .registry import GraphRegistry


@dataclasses.dataclass
class AsyncServeStats:
    """Counters over the server's lifetime (admission + SLO outcomes;
    DESIGN.md §7, tenancy §8, metrics §12).

    Two exact identities hold at every instant, and the metrics control
    plane exports and re-checks them
    (serving/metrics.MetricsSnapshot.violations, DESIGN.md §12):

      * **admission**: ``submitted == accepted + rejected_total`` —
        ``submit`` bumps ``submitted`` and exactly one of ``accepted`` /
        ``rejected_*`` before it returns or parks.  The ``rejected_*``
        counters are admission-time only.
      * **settlement**: ``accepted == completed + rejected_mid_flight +
        cancelled + failed + inflight`` — every admitted request ends in
        exactly one bucket: a served response, a dispatch-time rejection
        (tenant retired / weights dropped between admission and
        dispatch; the response still carries the ``STATUS_REJECTED_*``
        status), a caller-cancelled future, an engine-raised exception,
        or it is still in flight (``AsyncHcPEServer.queue_depth``).

    The ``*_ms_total`` fields accumulate the queue/service/total latency
    split over completed responses (``completed`` is their shared
    denominator), so an exporter can derive lifetime means without
    retaining per-response data."""
    submitted: int = 0
    accepted: int = 0
    completed: int = 0
    rejected_queue_full: int = 0
    rejected_quota: int = 0
    rejected_tenant_quota: int = 0
    rejected_unknown_graph: int = 0
    rejected_shutdown: int = 0
    rejected_no_weights: int = 0
    rejected_mid_flight: int = 0   # accepted, then shed at dispatch
    cancelled: int = 0             # accepted, future cancelled by caller
    failed: int = 0                # accepted, engine raised
    micro_batches: int = 0
    slo_met: int = 0
    slo_missed: int = 0
    # completed-response latency split, accumulated (ms); mean = /completed
    queue_ms_total: float = 0.0
    service_ms_total: float = 0.0
    total_ms_total: float = 0.0

    @property
    def rejected_total(self) -> int:
        """Sum of the admission-time rejection counters — the shed side
        of ``submitted == accepted + rejected_total``
        (``rejected_mid_flight`` is a settlement bucket, not an
        admission one, and is deliberately excluded)."""
        return (self.rejected_queue_full + self.rejected_quota
                + self.rejected_tenant_quota + self.rejected_unknown_graph
                + self.rejected_shutdown + self.rejected_no_weights)


@dataclasses.dataclass
class _Pending:
    req: PathQueryRequest
    enqueued_at: float                 # core.clock.now() at admission
    deadline_at: Optional[float]       # absolute core.clock; None = no SLO
    seq: int                           # arrival order, the EDF tiebreak
    future: "asyncio.Future[PathQueryResponse]"

    @property
    def edf_key(self) -> Tuple[float, int]:
        return (self.deadline_at if self.deadline_at is not None else math.inf,
                self.seq)


class AsyncHcPEServer:
    """Asyncio front-end over a tenant-graph registry + one
    ``BatchPathEnum`` engine (DESIGN.md §7, tenancy §8).

    Usage::

        async with AsyncHcPEServer(graph_or_registry) as server:
            resp = await server.submit(PathQueryRequest(uid=0, s=3, t=9, k=4,
                                                        deadline_ms=50.0))

    A bare ``Graph`` wraps into a single-tenant registry under
    ``DEFAULT_GRAPH_ID``, so pre-tenancy call sites run unchanged.  The
    engine — and therefore the tenant-keyed index LRU — is shared across
    all micro-batches and tenants, exactly as it is across
    ``HcPEServer.serve`` calls.  Micro-batches group by
    ``(graph_id, count_only, first_n, order)``: one engine batch never
    mixes tenants or ranking modes.

    Parameters
    ----------
    batch_window_ms:
        How long the scheduler lets a micro-batch accumulate after work
        becomes available, trading first-request latency for batch
        sharing (dedup / stacked BFS).
    max_queue_depth:
        Admission bound on requests queued or in flight; past it,
        ``submit`` resolves immediately to STATUS_REJECTED_QUEUE_FULL.
    max_pending_per_uid:
        Per-uid (client) in-flight quota → STATUS_REJECTED_QUOTA.
    max_pending_per_graph:
        Per-tenant-graph in-flight quota → STATUS_REJECTED_TENANT_QUOTA.
        ``None`` (default) leaves tenants unbounded unless their registry
        entry carries its own ``max_pending``, which always wins over
        this server-wide default.
    deadline_slack_ms:
        Two requests share a micro-batch only if their absolute deadlines
        are within this slack (and their serving options match) — keeps a
        loose-deadline heavy query from riding in a tight group, whose
        members would otherwise wait on it.
    default_deadline_ms:
        Applied to requests that carry no ``deadline_ms``; ``None`` means
        such requests have no deadline (they schedule last, FIFO).
    enforce_deadlines:
        Hand each group's deadline to the engine as a cooperative stop
        (truncated results, ``exhausted=False``).  Off by default: then
        deadlines order the work and grade SLOs, but never change results.
    backend:
        DFS-expansion backend ("device" / "host" / "auto", DESIGN.md §9)
        for the default-constructed engine; callers handing their own
        ``engine`` set the knob there instead.
    sharing:
        Cross-query structure sharing for the default-constructed engine
        ("auto" / "off", DESIGN.md §13); micro-batches group eligible
        same-tenant queries through one shared walk.
    device:
        Where the default-constructed engine runs ("cuda" by default,
        raising without a card; "cpu" runs the kernels' plain versions).
    """

    def __init__(self, graph: Union[Graph, GraphRegistry],
                 engine: Optional[BatchPathEnum] = None,
                 *, batch_window_ms: float = 2.0, max_queue_depth: int = 1024,
                 max_pending_per_uid: int = 256,
                 max_pending_per_graph: Optional[int] = None,
                 deadline_slack_ms: float = 25.0,
                 default_deadline_ms: Optional[float] = None,
                 enforce_deadlines: bool = False,
                 report_capacity: int = 256,
                 backend: str = "device",
                 sharing: str = "auto",
                 device: torch.device | str = "cuda") -> None:
        self.registry = GraphRegistry.wrap(graph)
        self.engine = engine or BatchPathEnum(backend=backend,
                                              sharing=sharing,
                                              device=device)
        self.registry.bind_engine(self.engine)
        self.batch_window_ms = batch_window_ms
        self.max_queue_depth = max_queue_depth
        self.max_pending_per_uid = max_pending_per_uid
        self.max_pending_per_graph = max_pending_per_graph
        self.deadline_slack_ms = deadline_slack_ms
        self.default_deadline_ms = default_deadline_ms
        self.enforce_deadlines = enforce_deadlines
        self.stats = AsyncServeStats()
        self._pending: List[_Pending] = []
        self._inflight = 0                 # admitted, response not yet sent
        self._per_uid: Dict[int, int] = {}
        self._per_graph: Dict[str, int] = {}
        self._seq = itertools.count()
        # drain_report's source, capped: count_only=False outputs hold the
        # full path arrays, so an undrained server must not retain every
        # micro-batch forever — past capacity the oldest outputs fall off
        self._outputs: Deque[BatchOutput] = collections.deque(
            maxlen=report_capacity)
        # lifetime Fig.-6 counters: every micro-batch's enum_stats merged
        # as it completes — unlike _outputs this never drains or caps, so
        # the metrics control plane (serving/metrics.py, DESIGN.md §12)
        # exports engine work since server construction
        self.enum_totals = EnumStats()
        self._wakeup: Optional[asyncio.Event] = None
        self._stop_evt: Optional[asyncio.Event] = None
        self._task: Optional[asyncio.Task] = None
        self._closing = False

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        """Start the scheduler task; ``async with`` calls this for you."""
        if self._task is not None:
            raise RuntimeError("server already started")
        self._closing = False
        self._wakeup = asyncio.Event()
        self._stop_evt = asyncio.Event()
        self._task = asyncio.create_task(self._scheduler())

    async def stop(self) -> None:
        """Drain the queue (every admitted request gets its response),
        then stop the scheduler.  Submissions after stop() begins resolve
        to STATUS_REJECTED_SHUTDOWN.  Drain latency is service-bound, not
        window-bound: the scheduler's batching window is interrupted (and
        skipped for later rounds) the moment stop() is called — there is
        nothing left to accumulate for once admissions are shut."""
        if self._task is None:
            return
        self._closing = True
        self._wakeup.set()
        self._stop_evt.set()
        await self._task
        self._task = None

    async def __aenter__(self) -> "AsyncHcPEServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # -- submission ---------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Requests admitted whose responses have not been sent yet."""
        return self._inflight

    def inflight_by_graph(self) -> Dict[str, int]:
        """Per-tenant admitted-but-unanswered request counts — the live
        numerator of each tenant's ``max_pending`` quota, exported by the
        metrics control plane (DESIGN.md §12)."""
        return dict(self._per_graph)

    def metrics_snapshot(self) -> "MetricsSnapshot":
        """One consistent ``serving.metrics.MetricsSnapshot`` of this
        server: admission/SLO/latency counters, per-tenant cache and
        quota state, graph versions, and lifetime Fig.-6 enumeration
        totals (DESIGN.md §12).  Safe to call at any point in the
        server's lifecycle (counters are read, never reset)."""
        from .metrics import snapshot
        return snapshot(self)

    @property
    def graph(self) -> Optional[Graph]:
        """The default tenant's graph (back-compat accessor for
        single-graph callers); None when no default tenant exists."""
        if DEFAULT_GRAPH_ID in self.registry:
            return self.registry.get(DEFAULT_GRAPH_ID)
        return None

    def _tenant_quota(self, graph_id: str) -> Optional[int]:
        """The in-flight quota for one tenant: its registry entry's
        ``max_pending`` if set, else the server-wide default."""
        entry = self.registry.entry(graph_id)
        return (entry.max_pending if entry.max_pending is not None
                else self.max_pending_per_graph)

    async def submit(self, req: PathQueryRequest) -> PathQueryResponse:
        """Admit one request and await its response.

        Admission failures — queue depth, per-uid quota, per-tenant
        quota, unknown ``graph_id``, shutdown — *return* a rejection
        response; malformed queries (k < 2, s == t, s/t out of range for
        the tenant's graph) raise ValueError like the engine would.
        """
        if self._task is None:
            raise RuntimeError("server not started (use `async with` or "
                               "await start())")
        # full validation up front: a malformed query must fail its own
        # submit, never reach engine.run and poison an entire micro-batch
        if req.k < 2:
            raise ValueError("paper assumes k >= 2")
        if req.s == req.t:
            raise ValueError("s and t must be distinct")
        if req.order is not None and req.order not in ORDERS:
            raise ValueError(f"unknown order {req.order!r}; expected one "
                             f"of {ORDERS} or None")
        if req.graph_id not in self.registry:
            # admission, not validation: tenants register/retire at
            # runtime, so an unknown graph is load-shed state the client
            # must see in-band (a retired tenant is not a client bug)
            self.stats.submitted += 1
            self.stats.rejected_unknown_graph += 1
            return self._rejected(req, STATUS_REJECTED_UNKNOWN_GRAPH)
        graph = self.registry.get(req.graph_id)
        # range check before the submitted counter: a ValueError is a
        # client bug, not traffic — submitted must stay equal to
        # accepted + sum(rejected_*)
        if not (0 <= req.s < graph.n and 0 <= req.t < graph.n):
            raise ValueError(f"s/t out of range for graph "
                             f"{req.graph_id!r} with n={graph.n}")
        if req.order == "weight" and \
                self.registry.entry(req.graph_id).edge_weights is None:
            # admission, not validation: weights are tenant configuration
            # (registered at runtime), so their absence is in-band state
            self.stats.submitted += 1
            self.stats.rejected_no_weights += 1
            return self._rejected(req, STATUS_REJECTED_NO_WEIGHTS)
        self.stats.submitted += 1
        if self._closing:
            self.stats.rejected_shutdown += 1
            return self._rejected(req, STATUS_REJECTED_SHUTDOWN)
        if self._inflight >= self.max_queue_depth:
            self.stats.rejected_queue_full += 1
            return self._rejected(req, STATUS_REJECTED_QUEUE_FULL)
        if self._per_uid.get(req.uid, 0) >= self.max_pending_per_uid:
            self.stats.rejected_quota += 1
            return self._rejected(req, STATUS_REJECTED_QUOTA)
        tenant_quota = self._tenant_quota(req.graph_id)
        if tenant_quota is not None and \
                self._per_graph.get(req.graph_id, 0) >= tenant_quota:
            self.stats.rejected_tenant_quota += 1
            return self._rejected(req, STATUS_REJECTED_TENANT_QUOTA)

        # admission timestamp and absolute deadline both read the engine's
        # deadline clock (core.clock) — the same source the enumeration
        # drivers compare against, so enforced truncation can't be skewed
        # by a clock-origin mismatch (tests/test_deadline_clock.py)
        now = clock.now()
        dl_ms = (req.deadline_ms if req.deadline_ms is not None
                 else self.default_deadline_ms)
        pending = _Pending(
            req=req, enqueued_at=now,
            deadline_at=now + dl_ms / 1e3 if dl_ms is not None else None,
            seq=next(self._seq),
            future=asyncio.get_running_loop().create_future())
        self.stats.accepted += 1
        self._inflight += 1
        self._per_uid[req.uid] = self._per_uid.get(req.uid, 0) + 1
        self._per_graph[req.graph_id] = \
            self._per_graph.get(req.graph_id, 0) + 1
        self._pending.append(pending)
        self._wakeup.set()
        return await pending.future

    def _rejected(self, req: PathQueryRequest,
                  status: str) -> PathQueryResponse:
        """A rejection response, with the SLO counters kept in agreement:
        a shed deadline-carrying request is a missed SLO in the stats,
        exactly as its response reports."""
        resp = rejection_response(req, status)
        if resp.slo_met is False:
            self.stats.slo_missed += 1
        return resp

    async def serve(self, requests: Sequence[PathQueryRequest],
                    ) -> List[PathQueryResponse]:
        """Burst-submit a batch and gather responses in request order —
        the async mirror of ``HcPEServer.serve`` (sans report)."""
        return list(await asyncio.gather(*(self.submit(r) for r in requests)))

    def drain_report(self) -> BatchServeReport:
        """Merge (and clear) the engine outputs accumulated since the last
        call — at most the ``report_capacity`` most recent micro-batches —
        into one ``BatchServeReport``; concurrent spans merge as
        max-of-overlapping wall time (hcpe._merge_outputs) and the cache
        delta stays split per tenant (``tenant_cache``)."""
        outputs = list(self._outputs)
        self._outputs.clear()
        return BatchServeReport.from_outputs(outputs)

    # -- scheduling ---------------------------------------------------------

    def _pop_edf_group(self) -> List[_Pending]:
        """Remove and return the next micro-batch: the earliest-deadline
        request plus every pending request with the same serving options
        whose deadline is within ``deadline_slack_ms`` of it."""
        self._pending.sort(key=lambda p: p.edf_key)
        head = self._pending[0]
        opts = request_group_key(head.req)
        slack = self.deadline_slack_ms / 1e3
        group: List[_Pending] = []
        rest: List[_Pending] = []
        for p in self._pending:
            close = (head.deadline_at is None if p.deadline_at is None
                     else (head.deadline_at is not None
                           and p.deadline_at - head.deadline_at <= slack))
            if request_group_key(p.req) == opts and close:
                group.append(p)
            else:
                rest.append(p)
        self._pending = rest
        return group

    async def _scheduler(self) -> None:
        while True:
            if not self._pending:
                if self._closing:
                    return
                self._wakeup.clear()
                await self._wakeup.wait()
                continue
            if self.batch_window_ms > 0 and not self._closing:
                # let the micro-batch fill; new arrivals during the window
                # (and during service below) join the EDF sort next round.
                # The wait is interruptible: stop() sets _stop_evt, so a
                # drain never sits out the rest of a batching window — no
                # new admissions can arrive to fill it anyway
                try:
                    await asyncio.wait_for(self._stop_evt.wait(),
                                           self.batch_window_ms / 1e3)
                except asyncio.TimeoutError:
                    pass
            while self._pending:
                await self._serve_group(self._pop_edf_group())

    async def _serve_group(self, group: List[_Pending]) -> None:
        """Run one micro-batch (all members share a ``request_group_key``,
        so one tenant graph) in a worker thread and settle its futures.
        A tenant retired between admission and dispatch fails soft: its
        group resolves to ``STATUS_REJECTED_UNKNOWN_GRAPH`` responses."""
        self.stats.micro_batches += 1
        head = group[0].req
        count_only, first_n, order = head.count_only, head.first_n, head.order
        if head.graph_id not in self.registry:
            # dispatch-time shed: these were *accepted*, so they settle
            # as rejected_mid_flight — the admission rejected_* counters
            # must keep submitted == accepted + rejected_total exact
            self._reject_group_mid_flight(group,
                                          STATUS_REJECTED_UNKNOWN_GRAPH)
            return
        graph = self.registry.get(head.graph_id)
        weights = None
        if order == "weight":
            weights = self.registry.entry(head.graph_id).edge_weights
            if weights is None:
                # tenant re-registered without weights between admission
                # and dispatch: fail soft, like a retired tenant
                self._reject_group_mid_flight(group,
                                              STATUS_REJECTED_NO_WEIGHTS)
                return
        deadline = None
        if self.enforce_deadlines:
            deadlines = [p.deadline_at for p in group]
            if all(d is not None for d in deadlines):
                # the group's deadline: when its last member's SLO expires
                deadline = max(deadlines)
        queries = [(p.req.s, p.req.t, p.req.k) for p in group]
        dispatched = clock.now()
        try:
            out = await asyncio.to_thread(
                self._run_engine, graph, queries, count_only=count_only,
                first_n=first_n, deadline=deadline,
                graph_id=head.graph_id, order=order, weights=weights)
        except BaseException as exc:  # engine bug: fail the group, not the loop
            for p in group:
                if not p.future.done():
                    p.future.set_exception(exc)
                    self.stats.failed += 1
                else:
                    self.stats.cancelled += 1
                self._settle(p)
            return
        done = clock.now()
        self._outputs.append(out)
        self.enum_totals.merge(out.enum_stats)
        for p, item in zip(group, out.items):
            if p.future.done():      # submit cancelled (e.g. wait_for timeout)
                self.stats.cancelled += 1
                self._settle(p)      # — drop the response, keep the scheduler
                continue
            resp = response_from_item(p.req, item)
            resp.queue_ms = (dispatched - p.enqueued_at) * 1e3
            resp.service_ms = (done - dispatched) * 1e3
            resp.total_ms = (done - p.enqueued_at) * 1e3
            if p.deadline_at is not None:
                resp.slo_met = done <= p.deadline_at
                if resp.slo_met:
                    self.stats.slo_met += 1
                else:
                    self.stats.slo_missed += 1
            self.stats.completed += 1
            self.stats.queue_ms_total += resp.queue_ms
            self.stats.service_ms_total += resp.service_ms
            self.stats.total_ms_total += resp.total_ms
            p.future.set_result(resp)
            self._settle(p)

    def _run_engine(self, *args, **kw) -> BatchOutput:
        """``engine.run`` as the worker thread runs it: inside the
        engine's CUDA device, which a pool thread never made current
        (the kernels launch on the calling thread's current device)."""
        dev = self.engine.device
        if dev.type != "cuda":
            return self.engine.run(*args, **kw)
        with torch.cuda.device(dev):
            return self.engine.run(*args, **kw)

    def _reject_group_mid_flight(self, group: List[_Pending],
                                 status: str) -> None:
        """Settle a whole micro-batch as dispatch-time rejections (tenant
        retired / weights dropped between admission and dispatch): every
        live future resolves to a ``status`` rejection response counted
        under ``rejected_mid_flight``; already-cancelled futures settle
        under ``cancelled``."""
        for p in group:
            if not p.future.done():
                self.stats.rejected_mid_flight += 1
                p.future.set_result(self._rejected(p.req, status))
            else:
                self.stats.cancelled += 1
            self._settle(p)

    def _settle(self, p: _Pending) -> None:
        self._inflight -= 1
        left = self._per_uid.get(p.req.uid, 0) - 1
        if left > 0:
            self._per_uid[p.req.uid] = left
        else:
            self._per_uid.pop(p.req.uid, None)
        gleft = self._per_graph.get(p.req.graph_id, 0) - 1
        if gleft > 0:
            self._per_graph[p.req.graph_id] = gleft
        else:
            self._per_graph.pop(p.req.graph_id, None)
