"""K5's hop's share of its HBM roofline over the traced window: the
bytes it reads and writes, each once (its inputs from the program's
counters; its head and child rows as the device copied them back), over
the time of its count and write kernels."""
from hcpe_bench import readers


def read(ctx):
    return readers.k5_roofline_pct(ctx)
