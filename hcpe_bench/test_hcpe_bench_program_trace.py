"""The program's spans and counters as ``program_trace`` reads them:
self times, idle-gap labels and device operations tied to spans on
hand-made spans and events; the small CPU cells traced with the
program's recorder on; and the harness's own runs, which leave the
recorder off."""
from __future__ import annotations

import pytest
import torch

from hcpe_bench import harness, loops, program_trace as pt, tracing
from repro_torch.core import trace

SEED = 2**31 + 57
CLOSED = ["tiny-k3.recurring-count", "tiny-k3.recurring-first1000",
          "tiny-k4.recurring-count"]
# the keys of a result line as the harness writes it
LINE = ["correct", "attempted", "failed", "metrics", "device", "compile_s",
        "checks"]
NEW = {"k5_device_ms_per_dispatch.batch", "fused_rows_per_dispatch.batch",
       "fused_idle_ms_per_dispatch.batch", "serve_host_ms_per_query.batch",
       "index_ms_per_miss.setup"}


@pytest.fixture(autouse=True)
def short_drain(monkeypatch):
    """A lost answer is awaited 2 s past the window here, not a minute."""
    monkeypatch.setattr(loops, "DRAIN_S", 2.0)


def span(name, start, end, sid, parent=0, attrs=None):
    return trace.Span(name, start, end, sid, parent, 0, attrs)


class Event:
    """A profiler event as ``read_device`` reads it."""

    def __init__(self, name, start, end, on_device=False, corr=0):
        self._v = (name, start, end - start, corr)
        self.on_device = on_device

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self.on_device
                else torch.autograd.DeviceType.CPU)


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type(
            "K", (), {"events": lambda _self: events})()


SPANS = [span("serve", 0, 1000, 1, attrs={"uids": [1, 2, 3, 4]}),
         span("engine.run", 100, 900, 2, 1),
         span("enumeration.fused", 200, 800, 3, 2),
         span("fused.round", 200, 500, 4, 3),
         span("k5.dispatch", 250, 350, 5, 4),
         span("k5.launch", 300, 350, 6, 5),
         span("fused.round", 500, 700, 7, 3),
         span("index.resolve", 850, 880, 8, 2)]


def test_self_seconds():
    got = pt.self_seconds(SPANS)
    assert got == pytest.approx({
        "serve": 200e-9, "engine.run": 170e-9, "enumeration.fused": 100e-9,
        "fused.round": 200e-9 + 200e-9, "k5.dispatch": 50e-9,
        "k5.launch": 50e-9, "index.resolve": 30e-9})


def test_self_time_takes_the_union_of_overlapping_children():
    spans = [span("serve", 0, 100, 1), span("engine.run", 10, 50, 2, 1),
             span("engine.run", 30, 70, 3, 1)]
    assert pt.self_seconds(spans)["serve"] == pytest.approx(40e-9)


def test_innermost_and_subtrees():
    assert pt.innermost(SPANS, [50, 260, 320, 600, 860, 950, 2000, 250]) \
        == [1, 5, 6, 7, 8, 1, None, 5]
    assert pt.under(SPANS, "enumeration.fused") == {3, 4, 5, 6, 7}
    assert pt.under(SPANS, "k5.dispatch") == {5, 6}
    assert pt.under(SPANS, "no.such") == set()


def window_trace():
    """A window [0, 1000) with three device operations: one launched
    inside ``k5.launch``, one inside the second ``fused.round``, and
    one whose runtime call is outside every span; the benchmark's own
    span twin on the device is not an operation."""
    return Prof([
        Event(tracing.WINDOW_SPAN, 0, 1000),
        Event("cudaLaunchKernel", 310, 320, corr=11),
        Event("scatter_add", 330, 400, on_device=True, corr=11),
        Event("cudaMemcpyAsync", 600, 610, corr=12),
        Event("Memcpy DtoH", 605, 650, on_device=True, corr=12),
        Event("cudaLaunchKernel", 1100, 1110, corr=13),
        Event("late", 950, 1200, on_device=True, corr=13),
        Event("kernels.k5_dispatch", 300, 450, on_device=True),
        Event("aten::zeros", 305, 309, corr=99)])


def test_read_device_labels_gaps_and_ties_operations():
    dev = pt.read_device(window_trace(), SPANS)
    assert dev["window_s"] == pytest.approx(1000e-9)
    assert dev["busy_s"] == pytest.approx((70 + 45 + 50) * 1e-9)
    # gaps [0,330) mid 165 -> engine.run, [400,605) mid 502 -> round 7,
    # [650,950) mid 800 -> enumeration.fused (the round ended at 700)
    assert dev["idle_s"] == pytest.approx({2: 330e-9, 7: 205e-9,
                                           3: 300e-9})
    assert sum(dev["idle_s"].values()) == \
        pytest.approx(dev["window_s"] - dev["busy_s"])
    assert dev["device_s"] == pytest.approx({6: 70e-9, 7: 45e-9,
                                             None: 50e-9})
    assert pt.read_device(Prof([]), SPANS) is None


def test_metrics_from_hand_made_traces():
    window = trace.Trace(SPANS, {"k5.dispatches": 2, "k5.rows": 90,
                                 "k5.prefix_bytes": 720, "k5.members": 3,
                                 "k5.candidate_edges": 40})
    setup = trace.Trace([span("index.resolve", 0, 4_000_000, 1),
                         span("index.resolve", 5_000_000, 7_000_000, 2)],
                        {"index.misses": 3})
    ctx = {"program": window, "program_setup": setup,
           "program_device": pt.read_device(window_trace(), SPANS)}
    assert pt.k5_device_ms_per_dispatch(ctx) == pytest.approx(70e-6 / 2)
    assert pt.fused_rows_per_dispatch(ctx) == 45.0
    assert pt.fused_idle_ms_per_dispatch(ctx) == \
        pytest.approx((205e-6 + 300e-6) / 2)
    assert pt.serve_host_ms_per_query(ctx) == pytest.approx(200e-6 / 4)
    assert pt.index_ms_per_miss(ctx) == pytest.approx(2.0)
    assert pt.k5_program_bytes(ctx) == 720 + 8 * 90 + 8 * 40 + 24 * 3
    assert pt.device_tied_pct(ctx) == pytest.approx(100 * 115 / 165)
    gaps = pt.program_idle_gaps(ctx)
    assert [n for n, _s in gaps] == ["engine.run", "enumeration.fused",
                                     "fused.round"]
    assert [s for _n, s in gaps] == pytest.approx([330e-9, 300e-9, 205e-9])


@pytest.mark.parametrize("read", [r for _u, r in pt.METRICS.values()]
                         + [pt.program_idle_gaps, pt.device_tied_pct,
                            pt.k5_program_bytes],
                         ids=list(pt.METRICS) + ["program_idle_gaps",
                                                 "device_tied_pct",
                                                 "k5_program_bytes"])
def test_readers_are_silent_without_the_programs_spans(read):
    # a run of a program without the recorder, or a harness that does
    # not switch it on, leaves nothing to read
    assert read({"records": [], "window_s": 0.0}) is None
    empty = trace.Trace([], {})
    assert read({"program": empty, "program_setup": empty,
                 "program_device": None}) is None


@pytest.mark.parametrize("cell", CLOSED)
def test_traced_cell_reads_the_programs_metrics(tiny, cell):
    spec, base = tiny
    result = pt.run_cell(cell, SEED, 0.5, device="cpu", spec=spec,
                         base=base)
    assert not trace.enabled()
    assert result["correct"], result["checks"]
    got = set(result["metrics"]) & NEW
    # the CPU has no device operations to tie to K5 or to leave idle
    assert got == NEW - {"k5_device_ms_per_dispatch.batch",
                         "fused_idle_ms_per_dispatch.batch"}
    values = {m: result["metrics"][m]["value"] for m in got}
    assert values["fused_rows_per_dispatch.batch"] >= 1
    assert values["serve_host_ms_per_query.batch"] > 0
    assert values["index_ms_per_miss.setup"] > 0
    assert result["program"]["counters"]["k5.dispatches"] >= 1
    # the program's K5 counters count what K5Recorder counts, exactly
    assert result["program"]["k5_bytes"] == \
        result["program"]["recorder_k5_bytes"] > 0
    gaps = result["program_idle_gaps"]
    assert sum(s for _n, s in gaps) == pytest.approx(
        result["device"]["window_s"] - result["device"]["busy_s"])
    assert result["program"]["recorder"]["span_on_ns"] > 0


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_harness_runs_leave_the_recorder_off(tiny, traced):
    spec, base = tiny
    trace.drain()
    result = harness.run_cell("tiny-k3.recurring-count", SEED, 0.3, traced,
                              device="cpu", spec=spec, base=base)
    assert result["correct"]
    keys = LINE[:5] + (["breakdown"] if traced else []) + LINE[5:]
    assert list(result) == keys
    assert not set(result["metrics"]) & NEW
    assert not trace.enabled()
    assert trace.drain() == trace.Trace([], {})
