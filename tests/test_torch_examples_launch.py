"""The port's serve_batch and train_lm examples on the CPU (the
launchers in this process): serve_batch with ``repro``'s arguments plus
``--device cpu``, train_lm for one step of lm100m.  kg_completion:
tests/test_torch_examples_lm.py.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.examples import serve_batch
from torch_example_parity import run_port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process keeps parallel test workers from
    oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_serve_batch_runs_repro_argv_on_cpu():
    text, values = run_port("serve_batch")
    assert serve_batch.ARGV[:2] == ["--arch", "llama3p2_1b"]
    assert values["requests"] == 6 and len(values["results"]) == 6
    assert all(len(toks) == 8 for toks in values["results"].values())
    assert values["tokens"] == 48
    assert text.startswith("served 6 requests, 48 tokens")


def test_train_lm_runs_one_step(tmp_path):
    out = tmp_path / "metrics.json"
    _, values = run_port("train_lm", ("--device", "cpu", "--steps", "1",
                                      "--metrics-out", str(out)))
    assert values["config"] == "lm100m" and values["steps"] == 1
    assert 100e6 < values["params"] < 110e6
    (rec,) = values["log"]
    assert rec["step"] == 0 and np.isfinite(rec["loss"])
    assert json.loads(out.read_text())["log"] == values["log"]
