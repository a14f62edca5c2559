"""GraphRegistry, the tenant dimension of the serving stack (the port of
``repro.serving.registry``; DESIGN.md §8).

One deployment serves many tenant graphs behind one front-end.  The
registry is the authority on which ``graph_id``s exist:

  * **register / retire**: tenants come and go at runtime; retiring a
    tenant also drops its entries (and quota) from every engine cache
    bound to the registry, so a retired graph cannot keep serving stale
    indexes.
  * **per-tenant knobs**: an index-cache entry quota (``cache_quota``,
    enforced by ``core.batch.IndexCache``) and an in-flight request
    quota (``max_pending``, enforced at admission by
    ``AsyncHcPEServer``), both adjustable live through
    ``set_cache_quota`` / ``set_max_pending`` (DESIGN.md §12).
  * **streaming mutation**: ``mutate`` applies edge inserts/deletes to a
    tenant's graph (``Graph.with_edges``, which bumps the
    ``Graph.version`` folded into every cache key) and purges the
    tenant's stale entries from every bound engine, both the index LRU
    and the merged group indexes.  Those entries are what hold the old
    version's index arrays on the card; the old graph's own device copy
    goes with the old ``Graph`` object once nothing else holds it.
    ``register`` over an existing id is the hot-swap path.
  * **single-graph compatibility**: ``GraphRegistry.wrap(graph)`` puts a
    bare graph under ``DEFAULT_GRAPH_ID``.

The registry is host-local and synchronous: it names graphs and owns
their quotas, nothing else.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional, Tuple, Union

import numpy as np

from ..core.batch import BatchPathEnum, DEFAULT_GRAPH_ID
from ..core.graph import Graph


@dataclasses.dataclass
class TenantEntry:
    """One registered tenant: its graph plus per-tenant serving knobs
    (DESIGN.md §8).  ``cache_quota`` bounds the tenant's index-cache
    entries; ``max_pending`` bounds its admitted-but-unanswered requests
    in the async front-end (None = the server's default applies).
    ``edge_weights`` (graph edge order, non-negative) makes the tenant
    servable under ``order="weight"`` ranked queries (DESIGN.md §10);
    tenants without weights reject those requests at admission."""
    graph_id: str
    graph: Graph
    cache_quota: Optional[int] = None
    max_pending: Optional[int] = None
    edge_weights: Optional[np.ndarray] = None


class GraphRegistry:
    """Mutable ``graph_id -> TenantEntry`` map shared by the serving
    front-ends (DESIGN.md §8).

    Engines *bind* to the registry (``bind_engine``): binding pushes each
    tenant's ``cache_quota`` into the engine's ``IndexCache``, and
    ``retire`` drops the tenant's cache entries from every bound engine.
    Both servers bind their engine automatically.
    """

    def __init__(self, default_graph: Optional[Graph] = None) -> None:
        self._entries: Dict[str, TenantEntry] = {}
        # weak: a registry outliving its servers (per-batch HcPEServer
        # over a long-lived registry) must not pin their engines/caches
        self._engines: "weakref.WeakSet[BatchPathEnum]" = weakref.WeakSet()
        if default_graph is not None:
            self.register(DEFAULT_GRAPH_ID, default_graph)

    @classmethod
    def wrap(cls, graph_or_registry: Union[Graph, "GraphRegistry"],
             ) -> "GraphRegistry":
        """The single-graph compatibility shim: a bare ``Graph`` becomes a
        one-tenant registry under ``DEFAULT_GRAPH_ID``; a registry passes
        through untouched."""
        if isinstance(graph_or_registry, GraphRegistry):
            return graph_or_registry
        return cls(default_graph=graph_or_registry)

    # -- tenant lifecycle ---------------------------------------------------

    def register(self, graph_id: str, graph: Graph, *,
                 cache_quota: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 edge_weights: Optional[np.ndarray] = None) -> TenantEntry:
        """Add (or replace) one tenant; quotas propagate to every bound
        engine's cache immediately.  Replacing a tenant's graph drops its
        old cache entries first — indexes built against the old graph must
        not answer queries against the new one.  ``edge_weights`` (one
        non-negative float per graph edge) enables ``order="weight"``
        ranked serving for the tenant (DESIGN.md §10)."""
        if not graph_id:
            raise ValueError("graph_id must be a non-empty string")
        if edge_weights is not None:
            edge_weights = np.asarray(edge_weights, dtype=np.float64)
            if edge_weights.shape != (graph.m,):
                raise ValueError(
                    f"edge_weights must have shape ({graph.m},), got "
                    f"{edge_weights.shape}")
        if graph_id in self._entries:
            self._drop_from_engines(graph_id)
        entry = TenantEntry(graph_id=graph_id, graph=graph,
                            cache_quota=cache_quota, max_pending=max_pending,
                            edge_weights=edge_weights)
        self._entries[graph_id] = entry
        for engine in self._engines:
            engine.cache.set_quota(graph_id, cache_quota)
        return entry

    def retire(self, graph_id: str) -> TenantEntry:
        """Remove one tenant and purge its entries from every bound
        engine cache.  In-flight requests already grouped against the
        graph finish; requests admitted after retirement are rejected
        with ``STATUS_REJECTED_UNKNOWN_GRAPH``."""
        entry = self._entries.pop(graph_id)
        self._drop_from_engines(graph_id)
        return entry

    def mutate(self, graph_id: str, *,
               add: Optional[np.ndarray] = None,
               remove: Optional[np.ndarray] = None,
               edge_weights: Optional[np.ndarray] = None) -> TenantEntry:
        """Stream edge inserts/deletes into one tenant's graph
        (DESIGN.md §12).

        Applies ``Graph.with_edges(add=..., remove=...)`` — the copy's
        ``version`` bump makes every pre-mutation cache entry
        unreachable — then purges the tenant's stale entries from every
        bound engine (the version guarantees correctness; the purge
        returns the capacity).  Quotas survive unchanged.  A tenant
        registered with ``edge_weights`` must supply the new per-edge
        weights here (the edge set changed, so the old vector no longer
        lines up); weightless tenants may also supply weights to become
        weight-servable.  Returns the updated entry; its
        ``entry.graph.version`` is the new epoch.
        """
        entry = self._entries[graph_id]
        new_graph = entry.graph.with_edges(add=add, remove=remove)
        if entry.edge_weights is not None and edge_weights is None:
            raise ValueError(
                f"tenant {graph_id!r} serves order='weight': mutate() "
                f"needs the new edge_weights (one per edge of the "
                f"mutated graph)")
        if edge_weights is not None:
            edge_weights = np.asarray(edge_weights, dtype=np.float64)
            if edge_weights.shape != (new_graph.m,):
                raise ValueError(
                    f"edge_weights must have shape ({new_graph.m},) for "
                    f"the mutated graph, got {edge_weights.shape}")
        entry = dataclasses.replace(entry, graph=new_graph,
                                    edge_weights=edge_weights)
        self._entries[graph_id] = entry
        self._drop_from_engines(graph_id)
        for engine in self._engines:
            engine.cache.set_quota(graph_id, entry.cache_quota)
        return entry

    def set_cache_quota(self, graph_id: str,
                        quota: Optional[int]) -> TenantEntry:
        """Adjust one tenant's index-cache entry quota live (the metrics
        control plane's write path, DESIGN.md §12).  Pushes to every
        bound engine immediately — a tenant over the new quota sheds its
        LRU entries now — and updates the registry entry so later-bound
        engines inherit it.  ``None`` removes the bound."""
        entry = dataclasses.replace(self._entries[graph_id],
                                    cache_quota=quota)
        self._entries[graph_id] = entry
        for engine in self._engines:
            engine.cache.set_quota(graph_id, quota)
        return entry

    def set_max_pending(self, graph_id: str,
                        max_pending: Optional[int]) -> TenantEntry:
        """Adjust one tenant's in-flight admission quota live
        (DESIGN.md §12).  The async front-end reads the entry at every
        admission, so the new bound applies to the next ``submit``;
        already-admitted requests are never shed retroactively.  ``None``
        falls back to the server-wide default."""
        entry = dataclasses.replace(self._entries[graph_id],
                                    max_pending=max_pending)
        self._entries[graph_id] = entry
        return entry

    def _drop_from_engines(self, graph_id: str) -> None:
        for engine in self._engines:
            engine.cache.drop_tenant(graph_id)
            # merged group indexes (DESIGN.md §13) key on the members'
            # tenant-qualified QueryKeys; stale groups are unreachable
            # already — this frees their memory on retire/mutate.
            engine.group_cache.drop_tenant(graph_id)

    # -- lookup -------------------------------------------------------------

    def get(self, graph_id: str) -> Graph:
        """The tenant's graph; raises KeyError for unknown ids (the
        servers translate that into a rejection response)."""
        return self._entries[graph_id].graph

    def entry(self, graph_id: str) -> TenantEntry:
        """The tenant's full entry (graph + quotas); KeyError if unknown."""
        return self._entries[graph_id]

    def graph_ids(self) -> Tuple[str, ...]:
        """All registered ids, registration order."""
        return tuple(self._entries)

    def __contains__(self, graph_id: str) -> bool:
        return graph_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    # -- engine binding -----------------------------------------------------

    def bind_engine(self, engine: BatchPathEnum) -> None:
        """Attach one engine: current tenants' cache quotas are applied to
        its ``IndexCache`` now, and future register/retire calls keep it
        in sync.  Idempotent per engine object; the reference is weak, so
        a short-lived server's engine unbinds itself by being collected."""
        if engine in self._engines:
            return
        self._engines.add(engine)
        for entry in self._entries.values():
            engine.cache.set_quota(entry.graph_id, entry.cache_quota)
