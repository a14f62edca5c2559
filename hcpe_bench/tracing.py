"""The benchmark's own side of a ``--trace 1`` run.

The program records its spans and counters itself
(``repro_torch.core.trace``, read by ``program_trace``).  Here are the
two things it does not hold: the window's ``torch.profiler`` range,
and each engine batch's plain counters (its ``BatchTiming`` split,
cache delta and plans), which ``BatchCounters`` keeps by wrapping the
``run`` of the one engine instance.
"""
from __future__ import annotations

import collections
from typing import Dict, List

WINDOW_SPAN = "bench.window"


def batch_counters(out) -> dict:
    """One engine ``BatchOutput`` as plain numbers: its timing split,
    cache delta, distinct queries and the plans of its distinct
    queries."""
    plans: Dict[str, int] = collections.Counter(
        it.plan.method for it in out.items if not it.deduplicated)
    tm = out.timing
    return {"queries": len(out.items), "distinct": out.distinct_queries,
            "distance_s": tm.distance_seconds, "index_s": tm.index_seconds,
            "optimize_s": tm.optimize_seconds,
            "enumerate_s": tm.enumerate_seconds, "total_s": tm.total_seconds,
            "hits": out.cache_stats.hits, "misses": out.cache_stats.misses,
            "plans": dict(plans), "fused_queries": out.fused_queries,
            "fused_dispatches": out.fused_dispatches,
            "shared_queries": out.shared_queries}


class BatchCounters:
    """Wraps ``engine.run`` while installed; while ``recording``,
    ``batches`` gets each batch's ``batch_counters``."""

    def __init__(self, engine) -> None:
        self.batches: List[dict] = []
        self.recording = False
        self.engine = engine
        run = engine.run

        def engine_run(*args, **kw):
            out = run(*args, **kw)
            if self.recording:
                self.batches.append(batch_counters(out))
            return out
        engine.run = engine_run

    def remove(self) -> None:
        """Put the engine's own ``run`` back."""
        del self.engine.run
