"""Idle device milliseconds under enumeration.fused's program spans, a K5 dispatch."""
from hcpe_bench import program_trace


def read(ctx):
    return program_trace.fused_idle_ms_per_dispatch(ctx)
