"""Index-cache hits over lookups, in percent."""
from hcpe_bench import readers


def read(ctx):
    return readers.cache_hit_pct(ctx)
