"""Milliseconds of the set-up's index.resolve spans, an index miss."""
from hcpe_bench import program_trace


def read(ctx):
    return program_trace.index_ms_per_miss(ctx)
