"""Rows handed to K5, a dispatch (the program's k5.rows over k5.dispatches)."""
from hcpe_bench import program_trace


def read(ctx):
    return program_trace.fused_rows_per_dispatch(ctx)
