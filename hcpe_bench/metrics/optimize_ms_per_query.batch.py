"""Planner milliseconds a distinct query (BatchTiming.optimize_seconds)."""
from hcpe_bench import readers


def read(ctx):
    return readers.per_distinct_ms(ctx, "optimize_s")
