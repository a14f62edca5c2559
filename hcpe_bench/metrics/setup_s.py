"""Set-up seconds: process start to the first timed request."""
from hcpe_bench import readers


def read(ctx):
    return readers.setup_s(ctx)
