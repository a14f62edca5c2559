"""Requests per engine batch of the async server."""
from hcpe_bench import readers


def read(ctx):
    return readers.microbatch_queries(ctx)
