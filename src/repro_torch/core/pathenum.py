"""PathEnum facade, Figure 2's pipeline as one entry point (the port of
``repro.core.pathenum``):

    index build → preliminary estimate → (maybe) full DP + cut →
    IDX-DFS or IDX-JOIN

Unlike ``repro``'s, the port's ``PathEnum`` defaults to
``device="cuda"`` and ``backend="device"``: the frontier kernels and the
device DP run on the card unless the caller asks for the CPU or the
host step.  Results and plans are bit-identical across backends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from . import planner as planner_mod
from .enumerate import EnumResult, enumerate_paths_idx
from .graph import Graph
from .index import LightweightIndex, build_index, build_index_device
from .join import enumerate_paths_join
from .planner import DEFAULT_TAU, Plan


@dataclasses.dataclass
class QueryTiming:
    """Host-clock seconds of the three stages (each ends in a host read
    of its device results, so device work is included)."""
    index_seconds: float = 0.0
    optimize_seconds: float = 0.0
    enumerate_seconds: float = 0.0

    @property
    def total_seconds(self) -> float:
        """Sum of the three stages."""
        return (self.index_seconds + self.optimize_seconds
                + self.enumerate_seconds)


@dataclasses.dataclass
class QueryOutput:
    """What one query returns."""
    result: EnumResult
    plan: Plan
    index: LightweightIndex
    timing: QueryTiming


class PathEnum:
    """Engine facade.  mode: "auto" (the paper's optimizer), "dfs",
    "join".

    ``backend`` ("device" by default, "host" or "auto") steers the IDX-DFS
    frontier expansion and the join/auto plan's hop-count DP; the join's
    sort-merge enumeration stays on the host.  ``device`` is where the
    index's kernels run ("cuda" by default; "cpu" runs the plain
    versions).  ``use_device_index`` builds the index on the device
    (``build_index_device``) instead of on the host.
    """

    def __init__(self, tau: float = DEFAULT_TAU, chunk_size: int = 16384,
                 use_device_index: bool = False,
                 max_partials: Optional[int] = 20_000_000,
                 backend: str = "device",
                 device: torch.device | str = "cuda"):
        self.tau = tau
        self.chunk_size = chunk_size
        self.use_device_index = use_device_index
        self.max_partials = max_partials
        self.backend = backend
        self.device = device

    def build(self, graph: Graph, s: int, t: int, k: int,
              edge_mask=None) -> LightweightIndex:
        """The query's light-weight index (device build when asked and no
        edge mask is given, host build otherwise)."""
        if self.use_device_index and edge_mask is None:
            return build_index_device(graph, s, t, k, device=self.device)
        return build_index(graph, s, t, k, edge_mask=edge_mask,
                           device=self.device)

    def query(self, graph: Graph, s: int, t: int, k: int,
              mode: str = "auto", count_only: bool = False,
              first_n: Optional[int] = None, constraint=None,
              edge_mask=None, cut: Optional[int] = None,
              backend: Optional[str] = None,
              order: Optional[str] = None,
              weights: Optional[np.ndarray] = None,
              deadline: Optional[float] = None) -> QueryOutput:
        """Run q(s,t,k) and return paths, plan, index and timings.

        ``deadline`` is an absolute ``clock.now()`` timestamp; ``first_n``
        stops after exactly n results.  ``constraint`` is an Appendix-E
        object (``core.constraints``; the walk then runs on the host) and
        ``edge_mask`` filters edges before the index build.  ``order``
        requests ranked (any-k) enumeration (DESIGN.md §10): ``"hops"``
        ranks by hop count, ``"weight"`` by edge-weight sum (``weights``:
        one non-negative float per graph edge), ties broken on the vertex
        sequence, so every mode and backend returns the same ordered
        list; ``first_n`` is then the top n and a deadline truncation a
        rank-optimal prefix.
        """
        if k < 2:
            raise ValueError("paper assumes k >= 2")
        timing = QueryTiming()
        t0 = time.perf_counter()
        idx = self.build(graph, s, t, k, edge_mask=edge_mask)
        timing.index_seconds = time.perf_counter() - t0

        be = backend or self.backend
        if mode == "auto":
            plan = planner_mod.plan_query(idx, tau=self.tau, backend=be)
        elif mode == "dfs":
            plan = Plan(method="dfs", cut=None, preliminary=-1.0,
                        used_full_estimator=False)
        elif mode == "join":
            if cut is None:
                dp_plan = planner_mod.plan_query(idx, tau=-1.0, backend=be)
                cut = dp_plan.cut if dp_plan.cut else max(1, k // 2)
            plan = Plan(method="join", cut=cut, preliminary=-1.0,
                        used_full_estimator=True)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        timing.optimize_seconds = plan.optimize_seconds

        t0 = time.perf_counter()
        if plan.method == "dfs":
            res = enumerate_paths_idx(idx, chunk_size=self.chunk_size,
                                      count_only=count_only, first_n=first_n,
                                      constraint=constraint, backend=be,
                                      order=order, weights=weights,
                                      deadline=deadline, device=idx.device)
        else:
            res = enumerate_paths_join(idx, cut=plan.cut,
                                       count_only=count_only,
                                       first_n=first_n,
                                       max_partials=self.max_partials,
                                       constraint=constraint, order=order,
                                       weights=weights, deadline=deadline)
        timing.enumerate_seconds = time.perf_counter() - t0
        return QueryOutput(result=res, plan=plan, index=idx, timing=timing)

    def count(self, graph: Graph, s: int, t: int, k: int, **kw) -> int:
        """The number of paths of q(s,t,k)."""
        return self.query(graph, s, t, k, count_only=True, **kw).result.count
