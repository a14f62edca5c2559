"""Whole runs of small cells on the CPU (the look for a card skipped):
sound runs come out correct, and the control and each fault the cells
can have come out not correct.

The control is the reference run with one hop fewer, put in the
program's place; the faults are planted under the timed path, in
the engine's ``run``: half of each batch left out, and an answer
altered where it is produced; and in the server's ``serve``, half of
each batch answered with a rejection instead of a count.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from hcpe_bench import control, harness, loops
from repro_torch.core import batch as port_batch
from repro_torch.serving import hcpe as port_hcpe

# the tiny cells of conftest.py
CELLS = ["tiny-k3.recurring-count", "tiny-k3.recurring-first1000",
         "tiny-k4.recurring-count", "tiny-k3.open-first1000"]
CLOSED = [c for c in CELLS if "open" not in c]
SEED = 2**31 + 29


@pytest.fixture(autouse=True)
def short_drain(monkeypatch):
    """A lost answer is awaited 2 s past the window here, not a minute."""
    monkeypatch.setattr(loops, "DRAIN_S", 2.0)


def run(tiny, cell, trace=False):
    spec, base = tiny
    return harness.run_cell(cell, SEED, 0.5, trace, device="cpu",
                            spec=spec, base=base)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    result = run(tiny, cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert all(c["limit"] == 0 for c in result["checks"].values())
    assert "setup_s" in result["metrics"]


def test_traced_run_reads_its_layers(tiny):
    result = run(tiny, "tiny-k3.recurring-count", trace=True)
    assert result["correct"]
    assert {"cache_hit_pct.batch", "enumerate_ms_per_query.batch"} \
        <= set(result["metrics"])
    assert result["metrics"]["cache_hit_pct.batch"]["value"] == 100.0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def plant(monkeypatch, fault):
    """Wrap the engine's ``run`` with ``fault(self, graph, queries, kw,
    orig)`` from the window's start on (set-up runs sound)."""
    orig = port_batch.BatchPathEnum.run
    armed = []

    def run_(self, graph, queries, **kw):
        if not armed:
            return orig(self, graph, queries, **kw)
        return fault(self, graph, queries, kw, orig)
    monkeypatch.setattr(port_batch.BatchPathEnum, "run", run_)
    for name in ("closed_loop", "open_loop"):
        loop = getattr(loops, name)

        def arming(*args, _loop=loop, **kw):
            if args[-1] > 0:  # the window, not the warm-up batch
                armed.append(True)
            return _loop(*args, **kw)
        monkeypatch.setattr(loops, name, arming)


def half_batch(self, graph, queries, kw, orig):
    if len(queries) < 2:
        return orig(self, graph, queries, **kw)
    return orig(self, graph, queries[: len(queries) // 2], **kw)


def altered_answer(self, graph, queries, kw, orig):
    out = orig(self, graph, queries, **kw)
    item = out.items[0]
    res = item.result
    if kw.get("count_only", True):
        res = dataclasses.replace(res, count=res.count + 1)
    else:
        paths = np.array(res.paths, copy=True)
        paths[0, 1] = (paths[0, 1] + 1) % graph.n
        res = dataclasses.replace(res, paths=paths)
    out.items[0] = dataclasses.replace(item, result=res)
    return out


def fewer_hops_in_place(self, graph, queries, kw, orig):
    out = orig(self, graph, queries, **kw)
    src = torch.from_numpy(graph.esrc.astype(np.int64))
    dst = torch.from_numpy(graph.edst.astype(np.int64))
    for i, item in enumerate(out.items):
        got = control.fewer_hops(graph.n, src, dst, item.s, item.t, item.k,
                                 kw.get("first_n"))
        res = dataclasses.replace(item.result, count=got.count)
        if not kw.get("count_only", True):
            res = dataclasses.replace(res, paths=got.paths)
        out.items[i] = dataclasses.replace(item, result=res)
    return out


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [half_batch, altered_answer,
                                   fewer_hops_in_place],
                         ids=["half_batch", "altered_answer", "control"])
def test_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    plant(monkeypatch, fault)
    result = run(tiny, cell)
    assert not result["correct"], result["checks"]


def rejected_half(monkeypatch):
    """From the window's start on, ``HcPEServer.serve`` runs the first
    half of each batch and answers the rest with a rejection."""
    orig = port_hcpe.HcPEServer.serve
    armed = []

    def serve(self, requests):
        if not armed or len(requests) < 2:
            return orig(self, requests)
        half = len(requests) // 2
        responses, report = orig(self, requests[:half])
        return responses + [
            port_hcpe.rejection_response(
                r, port_hcpe.STATUS_REJECTED_QUEUE_FULL)
            for r in requests[half:]], report
    monkeypatch.setattr(port_hcpe.HcPEServer, "serve", serve)
    loop = loops.closed_loop

    def arming(*args, **kw):
        if args[-1] > 0:  # the window, not the warm-up batch
            armed.append(True)
        return loop(*args, **kw)
    monkeypatch.setattr(loops, "closed_loop", arming)


@pytest.mark.parametrize("cell", CLOSED)
def test_rejected_half_batch_is_not_correct(tiny, monkeypatch, cell):
    rejected_half(monkeypatch)
    result = run(tiny, cell)
    assert not result["correct"], result["checks"]
    assert result["checks"]["missing"]["value"] == result["failed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_comparison(tiny, cell):
    spec, base = tiny
    numbers = control.control_numbers(cell, 3, 300, torch.device("cpu"),
                                      spec, base)
    assert not harness.checks.verdict(numbers), numbers


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
def test_small_cells_on_the_card(tiny, cuda_device):
    spec, base = tiny
    for cell in CELLS:
        result = harness.run_cell(cell, SEED, 1.0, True, device=cuda_device,
                                  spec=spec, base=base)
        assert result["correct"], (cell, result["checks"])
        assert result["device"]["busy_s"] > 0
        # on the card every per-layer metric of the cell is read
        assert set(result["metrics"]) == {
            m["name"] for m in spec["per_layer"] if cell in m["workloads"]}
