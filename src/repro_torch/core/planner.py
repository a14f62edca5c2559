"""Cost-based query optimizer (Section 6 / Figure 2), ported from
``repro.core.planner``.

Two phases: the preliminary estimate (Eq. 5); if T̂ > τ, the full DP
(Alg. 5), the cut i*, and T_DFS against T_JOIN (§6.3).  τ defaults to
1e5 as calibrated in the paper; ``calibrate_tau`` reruns the paper's
calibration on this machine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from . import estimator as est
from .index import LightweightIndex
from .join import hop_count_dp

DEFAULT_TAU = 1e5


@dataclasses.dataclass
class Plan:
    """The optimizer's decision and the numbers it rests on."""
    method: str                 # "dfs" | "join"
    cut: Optional[int]          # i* when method == "join"
    preliminary: float          # T̂ from Eq. 5
    used_full_estimator: bool
    t_dfs: Optional[float] = None
    t_join: Optional[float] = None
    est_results: Optional[float] = None
    dp: Optional[est.WalkCountDP] = None
    optimize_seconds: float = 0.0


def plan_query(index: LightweightIndex, tau: float = DEFAULT_TAU,
               backend: Optional[str] = None) -> Plan:
    """Two-phase plan for one query.  ``backend`` (host|device|auto)
    picks where the full DP runs when the τ gate trips; the plan itself
    never depends on it."""
    t0 = time.perf_counter()
    t_hat = est.preliminary_estimate(index)
    if t_hat <= tau:
        return Plan(method="dfs", cut=None, preliminary=t_hat,
                    used_full_estimator=False,
                    optimize_seconds=time.perf_counter() - t0)

    dp = hop_count_dp(index, backend)
    cut = dp.cut
    # a cut at the boundary degenerates to the left-deep plan
    if cut <= 0 or cut >= index.k or dp.t_dfs <= dp.t_join:
        return Plan(method="dfs", cut=None, preliminary=t_hat,
                    used_full_estimator=True, t_dfs=dp.t_dfs,
                    t_join=dp.t_join, est_results=dp.q_total, dp=dp,
                    optimize_seconds=time.perf_counter() - t0)
    return Plan(method="join", cut=cut, preliminary=t_hat,
                used_full_estimator=True, t_dfs=dp.t_dfs, t_join=dp.t_join,
                est_results=dp.q_total, dp=dp,
                optimize_seconds=time.perf_counter() - t0)


def calibrate_tau(graph, queries, k: int = 6, start: float = 10.0,
                  limit: float = 1e7,
                  device: torch.device | str = "cuda") -> float:
    """The paper's τ calibration (§6.2): grow τ by 10× until the time to
    find τ results exceeds the full optimization time for most
    queries."""
    from .enumerate import EngineLimit, enumerate_paths_idx
    from .index import build_index

    tau = start
    while tau < limit:
        slower = 0
        for (s, t) in queries:
            idx = build_index(graph, s, t, k, device=device)
            t0 = time.perf_counter()
            est.walk_count_dp(idx, device=device)
            opt_time = time.perf_counter() - t0
            t0 = time.perf_counter()
            try:
                enumerate_paths_idx(idx, first_n=int(tau), device=device)
            except EngineLimit:
                pass
            enum_time = time.perf_counter() - t0
            if enum_time > opt_time:
                slower += 1
        if slower >= len(queries) * 0.5:
            return tau
        tau *= 10
    return tau
