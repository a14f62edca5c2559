"""Metrics control plane (the port of ``repro.serving.metrics``;
DESIGN.md §12): one consistent snapshot of a serving stack, exportable as
JSON or Prometheus text.

  * ``snapshot(server)`` captures a ``MetricsSnapshot`` from either
    front-end (``HcPEServer`` or ``AsyncHcPEServer``).  Every counter is
    a value copy taken at capture time, so later traffic never mutates a
    snapshot.
  * ``MetricsSnapshot.to_json()`` / ``to_prometheus()`` export the same
    numbers as a JSON document or Prometheus text-format lines
    (``pathenum_*`` metric families, tenants as ``graph_id`` labels).
  * ``MetricsSnapshot.violations()`` re-checks the counter identities
    the stack promises (admission: ``submitted == accepted +
    rejected_total``; settlement; global cache == sum of the tenants').

The write path lives on the registry (``GraphRegistry.set_cache_quota``
/ ``set_max_pending``), so capturing metrics never perturbs the system.
Nothing here reads the card.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Union

from ..core.batch import CacheStats
from ..core.enumerate import EnumStats
from .async_server import AsyncHcPEServer, AsyncServeStats
from .hcpe import HcPEServer


@dataclasses.dataclass
class TenantMetrics:
    """One tenant's slice of a ``MetricsSnapshot`` (DESIGN.md §12):
    graph shape and streaming version, cache occupancy/quota/counters,
    and — on the async front-end — the live in-flight count its
    ``max_pending`` quota meters.  ``registered`` is False for a tenant
    that only survives as historical cache stats (retired, but its
    counters kept for post-mortems, DESIGN.md §8)."""
    graph_id: str
    registered: bool
    graph_version: int = -1        # -1: tenant not registered
    vertices: int = 0
    edges: int = 0
    cache_entries: int = 0
    cache_quota: Optional[int] = None
    cache: CacheStats = dataclasses.field(default_factory=CacheStats)
    max_pending: Optional[int] = None
    inflight: int = 0


@dataclasses.dataclass
class MetricsSnapshot:
    """A point-in-time value copy of every operational counter a serving
    stack exposes (DESIGN.md §12): global + per-tenant index-cache
    stats, merged Fig.-6 enumeration totals, and — for the async
    front-end — admission/SLO/latency counters and queue depth.
    ``serve`` is None for the sync server (it has no admission plane).
    """
    captured_at: float             # time.time() at capture
    cache: CacheStats              # global engine cache counters
    cache_entries: int
    cache_capacity: int
    enum_stats: EnumStats          # lifetime Fig.-6 totals (server scope)
    tenants: Dict[str, TenantMetrics]
    serve: Optional[AsyncServeStats] = None
    queue_depth: int = 0

    def to_dict(self) -> Dict[str, object]:
        """The snapshot as plain nested dicts/lists — ``json.loads
        (snapshot.to_json())`` equals this, and tests diff it against
        ground-truth counters."""
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = None) -> str:
        """JSON export (the admin-API shape); ``indent`` pretty-prints."""
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text-format export: ``pathenum_*`` metric families,
        one ``# TYPE`` header each, tenants as ``graph_id`` labels.
        Counters export as ``*_total``; occupancy, quotas, versions and
        queue depth as gauges (an unset quota exports no sample rather
        than a fake bound)."""
        lines: List[str] = []

        def counter(name: str, value: Union[int, float],
                    label: Optional[str] = None) -> None:
            self._sample(lines, name, "counter", value, label)

        def gauge(name: str, value: Union[int, float],
                  label: Optional[str] = None) -> None:
            self._sample(lines, name, "gauge", value, label)

        counter("pathenum_cache_hits_total", self.cache.hits)
        counter("pathenum_cache_misses_total", self.cache.misses)
        counter("pathenum_cache_evictions_total", self.cache.evictions)
        gauge("pathenum_cache_entries", self.cache_entries)
        gauge("pathenum_cache_capacity", self.cache_capacity)
        for fld in dataclasses.fields(EnumStats):
            counter(f"pathenum_enum_{fld.name}_total",
                    getattr(self.enum_stats, fld.name))
        if self.serve is not None:
            for fld in dataclasses.fields(AsyncServeStats):
                suffix = "" if fld.name.endswith("_total") else "_total"
                counter(f"pathenum_serve_{fld.name}{suffix}",
                        getattr(self.serve, fld.name))
            counter("pathenum_serve_rejected_total",
                    self.serve.rejected_total)
            gauge("pathenum_serve_queue_depth", self.queue_depth)
        for gid, tm in self.tenants.items():
            counter("pathenum_tenant_cache_hits_total", tm.cache.hits, gid)
            counter("pathenum_tenant_cache_misses_total", tm.cache.misses,
                    gid)
            counter("pathenum_tenant_cache_evictions_total",
                    tm.cache.evictions, gid)
            gauge("pathenum_tenant_cache_entries", tm.cache_entries, gid)
            if tm.cache_quota is not None:
                gauge("pathenum_tenant_cache_quota", tm.cache_quota, gid)
            if tm.registered:
                gauge("pathenum_tenant_graph_version", tm.graph_version, gid)
                gauge("pathenum_tenant_graph_edges", tm.edges, gid)
                if tm.max_pending is not None:
                    gauge("pathenum_tenant_max_pending", tm.max_pending, gid)
            if self.serve is not None:
                gauge("pathenum_tenant_inflight", tm.inflight, gid)
        return "\n".join(lines) + "\n"

    def _sample(self, lines: List[str], name: str, kind: str,
                value: Union[int, float], label: Optional[str]) -> None:
        header = f"# TYPE {name} {kind}"
        if header not in lines:
            lines.append(header)
        if label is None:
            lines.append(f"{name} {value}")
        else:
            esc = (label.replace("\\", r"\\").replace('"', r"\"")
                   .replace("\n", r"\n"))
            lines.append(f'{name}{{graph_id="{esc}"}} {value}')

    def violations(self) -> List[str]:
        """Re-check the counter identities the serving stack promises
        (AsyncServeStats' admission and settlement identities, and the
        per-tenant/global cache agreement the tenant-stat drift bug used
        to break).  Returns human-readable violation strings — an empty
        list is the invariant the fuzzed property suite asserts."""
        out: List[str] = []
        agg = CacheStats()
        for tm in self.tenants.values():
            agg.hits += tm.cache.hits
            agg.misses += tm.cache.misses
            agg.evictions += tm.cache.evictions
        for fld in ("hits", "misses", "evictions"):
            got, want = getattr(agg, fld), getattr(self.cache, fld)
            if got != want:
                out.append(f"cache {fld}: global {want} != tenant sum {got}")
        entry_sum = sum(tm.cache_entries for tm in self.tenants.values())
        if entry_sum != self.cache_entries:
            out.append(f"cache entries: global {self.cache_entries} != "
                       f"tenant sum {entry_sum}")
        s = self.serve
        if s is not None:
            if s.submitted != s.accepted + s.rejected_total:
                out.append(f"admission: submitted {s.submitted} != accepted "
                           f"{s.accepted} + rejected {s.rejected_total}")
            settled = (s.completed + s.rejected_mid_flight + s.cancelled
                       + s.failed)
            if settled + self.queue_depth != s.accepted:
                out.append(f"settlement: accepted {s.accepted} != settled "
                           f"{settled} + inflight {self.queue_depth}")
            if s.slo_met + s.slo_missed > s.submitted:
                out.append(f"slo: met {s.slo_met} + missed {s.slo_missed} "
                           f"> submitted {s.submitted}")
            inflight_sum = sum(tm.inflight for tm in self.tenants.values())
            if inflight_sum != self.queue_depth:
                out.append(f"inflight: queue depth {self.queue_depth} != "
                           f"tenant sum {inflight_sum}")
        return out


def snapshot(server: Union[HcPEServer, AsyncHcPEServer]) -> MetricsSnapshot:
    """Capture a ``MetricsSnapshot`` from either HcPE front-end
    (DESIGN.md §12).

    Reads the server's registry, engine cache and — on the async
    front-end — its ``AsyncServeStats``; every counter lands in the
    snapshot as a value copy (``CacheStats.snapshot`` /
    ``dataclasses.replace``), so later traffic never mutates captured
    evidence.  Tenants are the union of registered ids and ids with
    surviving cache stats (a retired tenant appears with
    ``registered=False``).
    """
    cache = server.engine.cache
    inflight: Dict[str, int] = {}
    serve: Optional[AsyncServeStats] = None
    queue_depth = 0
    if isinstance(server, AsyncHcPEServer):
        inflight = server.inflight_by_graph()
        serve = dataclasses.replace(server.stats)
        queue_depth = server.queue_depth
    ids = dict.fromkeys(server.registry.graph_ids())
    ids.update(dict.fromkeys(cache.tenant_ids()))
    ids.update(dict.fromkeys(inflight))
    tenants: Dict[str, TenantMetrics] = {}
    for gid in ids:
        tm = TenantMetrics(
            graph_id=gid, registered=gid in server.registry,
            cache_entries=cache.tenant_len(gid),
            cache_quota=cache.quota_for(gid),
            cache=cache.stats_for(gid).snapshot(),
            inflight=inflight.get(gid, 0))
        if tm.registered:
            entry = server.registry.entry(gid)
            tm.graph_version = int(entry.graph.version)
            tm.vertices = int(entry.graph.n)
            tm.edges = int(entry.graph.m)
            tm.cache_quota = entry.cache_quota
            tm.max_pending = entry.max_pending
        tenants[gid] = tm
    enum_totals = EnumStats()
    enum_totals.merge(server.enum_totals)
    return MetricsSnapshot(
        captured_at=time.time(),
        cache=cache.stats.snapshot(),
        cache_entries=len(cache),
        cache_capacity=cache.capacity,
        enum_stats=enum_totals,
        tenants=tenants,
        serve=serve,
        queue_depth=queue_depth)
