"""95th percentile of due-to-answer milliseconds over every request due in the window."""
from hcpe_bench import readers


def read(ctx):
    return readers.response_ms(ctx, 95)
