"""Distinct queries planned IDX-JOIN, in percent."""
from hcpe_bench import readers


def read(ctx):
    return readers.join_plan_pct(ctx)
