"""Device milliseconds of the operations launched inside k5.dispatch spans, a K5 dispatch."""
from hcpe_bench import program_trace


def read(ctx):
    return program_trace.k5_device_ms_per_dispatch(ctx)
