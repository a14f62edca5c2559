"""What the metric readers in ``metrics/`` compute, from the run's
context (``harness.run_cell`` fills it): each function returns a number,
or None when the run gave it nothing to read."""
from __future__ import annotations

from typing import Optional

from . import program_trace, stats


def setup_s(ctx: dict) -> Optional[float]:
    """Seconds from the process's start to the first timed request."""
    return ctx.get("setup_s")


def queries_per_s(ctx: dict) -> Optional[float]:
    """Requests answered ok in the window over the window's seconds."""
    return stats.rate(ctx["records"], ctx["window_s"])


def response_ms(ctx: dict, q: float) -> Optional[float]:
    """The q-th percentile of due-to-answer milliseconds over every
    request due in the window, missing answers included."""
    return stats.latency_percentile(ctx["records"], q)


def queue_ms(ctx: dict, q: float) -> Optional[float]:
    """The q-th percentile of the server's queue milliseconds (its own
    admission-to-dispatch split) over the window's ok answers."""
    return stats.percentile([r.response.queue_ms for r in ctx["records"]
                             if r.ok], q)


def microbatch_queries(ctx: dict) -> Optional[float]:
    """Requests settled per engine batch of the async server in the
    window (its own counters)."""
    before, after = ctx.get("async_before"), ctx.get("async_after")
    if before is None or after is None:
        return None
    batches = after.micro_batches - before.micro_batches
    if batches <= 0:
        return None
    return (after.completed - before.completed) / batches


def _batches(ctx: dict):
    return ctx.get("batches") or []


def cache_hit_pct(ctx: dict) -> Optional[float]:
    """Index-cache hits over lookups in the window's engine batches."""
    hits = sum(b["hits"] for b in _batches(ctx))
    lookups = hits + sum(b["misses"] for b in _batches(ctx))
    return 100.0 * hits / lookups if lookups else None


def per_distinct_ms(ctx: dict, field: str) -> Optional[float]:
    """Milliseconds of one ``BatchTiming`` field a distinct query, over
    the window's engine batches."""
    distinct = sum(b["distinct"] for b in _batches(ctx))
    if distinct == 0:
        return None
    return 1e3 * sum(b[field] for b in _batches(ctx)) / distinct


def join_plan_pct(ctx: dict) -> Optional[float]:
    """Distinct queries planned IDX-JOIN over distinct queries."""
    plans = [b["plans"] for b in _batches(ctx)]
    total = sum(sum(p.values()) for p in plans)
    if total == 0:
        return None
    return 100.0 * sum(p.get("join", 0) for p in plans) / total


def kernel_seconds(ctx: dict, part: str) -> float:
    """Device seconds in the window of the operations whose name holds
    ``part``."""
    dev = ctx.get("program_device") or {}
    return sum(s for name, s in dev.get("kernel_s", {}).items()
               if part in name)


def k5_roofline_pct(ctx: dict) -> Optional[float]:
    """K5's hop's least time over its device time: the bytes it reads
    and writes, each once (``program_trace.k5_input_bytes``, from the
    program's counters, and ``k5_output_bytes``, its head and child
    rows as the device copied them back), at the card's HBM rate, over
    the summed time of the operations named ``frontier_fused`` (on the
    card the hop's count and write kernels)."""
    nin = program_trace.k5_input_bytes(ctx)
    nout = program_trace.k5_output_bytes(ctx)
    peaks = ctx.get("peaks")
    device_s = kernel_seconds(ctx, "frontier_fused")
    if not nin or not nout or not peaks or device_s <= 0:
        return None
    return 100.0 * (nin + nout) / peaks["hbm_bytes_per_s"] / device_s


def device_idle_pct(ctx: dict) -> Optional[float]:
    """The share of the traced window in which no device operation
    ran."""
    dev = ctx.get("program_device")
    if not dev or dev["window_s"] <= 0 or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])
