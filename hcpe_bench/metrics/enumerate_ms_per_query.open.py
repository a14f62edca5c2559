"""Enumeration milliseconds a distinct query in the async cell."""
from hcpe_bench import readers


def read(ctx):
    return readers.per_distinct_ms(ctx, "enumerate_s")
