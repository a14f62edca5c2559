"""Self milliseconds of the program's serve spans, a request served."""
from hcpe_bench import program_trace


def read(ctx):
    return program_trace.serve_host_ms_per_query(ctx)
