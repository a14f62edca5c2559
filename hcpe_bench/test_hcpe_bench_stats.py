"""Rates and percentiles are taken over all requests and all of the
window; missing answers count; the no-JAX check compares whole
top-level names."""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from hcpe_bench import harness, loops, readers, stats
from repro_torch.core import trace

HERE = Path(__file__).resolve().parent


def rec(latency_ms, status="ok"):
    resp = None if status is None else SimpleNamespace(status=status,
                                                       queue_ms=1.0)
    return stats.Record(uid=0, pair=0, due=0.0, sent=0.0,
                        done=latency_ms / 1e3, response=resp)


def test_percentile_takes_every_request():
    records = [rec(float(i)) for i in range(1, 101)]
    assert stats.latency_percentile(records, 50) == pytest.approx(50.5)
    assert stats.latency_percentile(records, 95) == pytest.approx(95.05)


@pytest.mark.parametrize("status", [None, "rejected_queue_full"])
def test_missing_or_rejected_answers_sit_in_the_tail(status):
    records = [rec(10.0) for _ in range(90)] + \
        [rec(10.0, status) for _ in range(10)]
    assert stats.latency_percentile(records, 50) == pytest.approx(10.0)
    assert stats.latency_percentile(records, 95) == stats.MISSING_MS
    assert stats.count_failed(records) == 10


def test_rate_counts_ok_answers_over_the_whole_window():
    records = [rec(1.0) for _ in range(30)] + [rec(1.0, None)]
    assert stats.rate(records, 2.0) == 15.0
    assert stats.rate(records, 0.0) is None


def test_readers_over_a_window():
    ctx = {"records": [rec(float(i)) for i in range(1, 21)],
           "window_s": 4.0,
           "batches": [{"hits": 3, "misses": 1, "distinct": 2,
                        "optimize_s": 0.002, "enumerate_s": 0.01,
                        "plans": {"dfs": 1, "join": 1}}],
           "program": trace.Trace(
               [trace.Span("fused.readback", 0, 10, 1, 0, 0, None)],
               {"k5.dispatches": 1, "k5.prefix_bytes": 3_000_000}),
           "program_device": {"window_s": 2.0, "busy_s": 0.5,
                              "kernel_s": {"frontier_fused_kernel": 0.001},
                              "copy_bytes": {1: 350_000}},
           "peaks": {"hbm_bytes_per_s": 3.35e12}}
    assert readers.queries_per_s(ctx) == 5.0
    assert readers.cache_hit_pct(ctx) == 75.0
    assert readers.per_distinct_ms(ctx, "enumerate_s") == pytest.approx(5.0)
    assert readers.join_plan_pct(ctx) == 50.0
    assert readers.device_idle_pct(ctx) == 75.0
    assert readers.k5_roofline_pct(ctx) == pytest.approx(0.1)


def test_zipf_and_arrivals_are_seeded_and_inside_the_window():
    p = loops.zipf_probs(64, 1.0)
    assert p.sum() == pytest.approx(1.0) and p[0] == pytest.approx(
        64 * p[63])
    a = loops.arrivals(200.0, 3.0, 64, 1.0, np.random.default_rng(5))
    b = loops.arrivals(200.0, 3.0, 64, 1.0, np.random.default_rng(5))
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert a[0].min() >= 0 and a[0].max() < 3.0
    assert 450 < a[0].shape[0] < 750


@pytest.mark.parametrize("loaded,found", [
    (["repro_torch", "repro_torch.core.batch", "numpy"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.batch"], ["repro"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jax_cookbook", "reprolib", "flaxen"], []),
])
def test_forbidden_modules_compare_whole_top_level_names(loaded, found):
    assert harness.forbidden_modules(loaded) == found


def _env_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_harness_modules_load_no_jax_or_repro():
    code = ("import sys; import hcpe_bench.harness, hcpe_bench.control, "
            "hcpe_bench.sweep; from hcpe_bench import harness; "
            "harness.use_checkout_program(); harness.port_modules(); "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         env=_env_without_cuda(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_exits_nonzero_and_prints_nothing():
    out = subprocess.run(
        [sys.executable, "-m", "hcpe_bench.run", "--workload",
         "graph500-s18-k3.recurring-count", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"], cwd=HERE.parent,
        env=_env_without_cuda(), capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_run_without_the_program_exits_nonzero(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text(
        (HERE.parent / "BENCHMARK.json").read_text())
    shutil.copytree(HERE, tmp_path / "hcpe_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "hcpe_bench.run", "--workload",
         "graph500-s18-k3.recurring-count", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, env=_env_without_cuda(), capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
