"""Share of the traced window with no device operation running."""
from hcpe_bench import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
