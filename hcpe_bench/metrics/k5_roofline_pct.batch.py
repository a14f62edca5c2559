"""K5's share of its HBM roofline over the traced window."""
from hcpe_bench import readers


def read(ctx):
    return readers.k5_roofline_pct(ctx)
