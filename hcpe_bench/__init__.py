"""The benchmark of the PyTorch and CUDA port (``repro_torch``): served
hop-constrained s-t path queries on seeded graphs of published sizes.

``python -m hcpe_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (``run.py``; ``harness.py`` holds
the run).  Cells, configurations, traffic mixes and metric readers are
data found by name: ``BENCHMARK.json`` at the repository's root,
``configs/``, ``traffic/``, ``workloads/`` and ``metrics/``.  The plain
reference that decides ``correct`` is in ``reference/``; ``control.py``
and ``sweep.py`` are the one-off runs that set a limit's upper reading
and an open cell's rate.
"""
