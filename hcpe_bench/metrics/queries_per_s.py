"""Queries answered ok in the window over its seconds."""
from hcpe_bench import readers


def read(ctx):
    return readers.queries_per_s(ctx)
