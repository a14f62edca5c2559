"""95th percentile of the async server's queue milliseconds."""
from hcpe_bench import readers


def read(ctx):
    return readers.queue_ms(ctx, 95)
