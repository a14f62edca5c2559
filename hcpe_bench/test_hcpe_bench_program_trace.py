"""The program's spans and counters as ``program_trace`` reads them:
self times, idle-gap labels, device operations and copies tied to spans
on hand-made spans and events; the small CPU cells traced through the
harness, which switches the program's recorder on for ``--trace 1``
runs only; and a reader added as a data file."""
from __future__ import annotations

import shutil

import pytest
import torch

from hcpe_bench import harness, loops, program_trace as pt, readers, tracing
from repro_torch.core import batch as port_batch
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
# the program_trace functions each reader of NEW calls
READS = {"k5_device_ms_per_dispatch.batch": pt.k5_device_ms_per_dispatch,
         "fused_rows_per_dispatch.batch": pt.fused_rows_per_dispatch,
         "fused_idle_ms_per_dispatch.batch": pt.fused_idle_ms_per_dispatch,
         "serve_host_ms_per_query.batch": pt.serve_host_ms_per_query,
         "index_ms_per_miss.setup": pt.index_ms_per_miss}


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
         span("index.resolve", 850, 880, 8, 2),
         span("fused.readback", 590, 660, 9, 7)]


def test_self_seconds():
    got = pt.self_seconds(SPANS)
    assert got == pytest.approx({
        "serve": 200e-9, "engine.run": 170e-9, "enumeration.fused": 100e-9,
        "fused.round": 200e-9 + 130e-9, "k5.dispatch": 50e-9,
        "k5.launch": 50e-9, "index.resolve": 30e-9,
        "fused.readback": 70e-9})


def test_self_time_takes_the_union_of_overlapping_children():
    spans = [span("serve", 0, 100, 1), span("engine.run", 10, 50, 2, 1),
             span("engine.run", 30, 70, 3, 1)]
    assert pt.self_seconds(spans)["serve"] == pytest.approx(40e-9)


def test_innermost_and_subtrees():
    assert pt.innermost(SPANS, [50, 260, 320, 600, 860, 950, 2000, 250]) \
        == [1, 5, 6, 9, 8, 1, None, 5]
    assert pt.under(SPANS, "enumeration.fused") == {3, 4, 5, 6, 7, 9}
    assert pt.under(SPANS, "k5.dispatch") == {5, 6}
    assert pt.under(SPANS, "no.such") == set()


def window_trace(hi=1000):
    """A window [0, hi) with three device operations: one launched
    inside ``k5.launch``, a copy back of 640 bytes launched inside
    ``fused.readback``, and one whose runtime call is outside every
    span; the window's own twin on the device is not an operation."""
    return Prof([
        Event(tracing.WINDOW_SPAN, 0, hi),
        Event("cudaLaunchKernel", 310, 320, corr=11),
        Event("scatter_add", 330, 400, on_device=True, corr=11),
        Event("cudaMemcpyAsync", 600, 610, corr=12),
        Event("Memcpy DtoH", 605, 650, on_device=True, corr=12),
        Event("cudaLaunchKernel", 1100, 1110, corr=13),
        Event("late", 950, 1200, on_device=True, corr=13),
        Event(tracing.WINDOW_SPAN, 0, hi, on_device=True),
        Event("aten::zeros", 305, 309, corr=99)])


def test_read_device_labels_gaps_and_ties_operations():
    dev = pt.read_device(window_trace(), SPANS, {12: 640, 77: 5})
    assert dev["window_s"] == pytest.approx(1000e-9)
    assert dev["busy_s"] == pytest.approx((70 + 45 + 50) * 1e-9)
    # gaps [0,330) mid 165 -> engine.run, [400,605) mid 502 -> round 7,
    # [650,950) mid 800 -> enumeration.fused (the round ended at 700)
    assert dev["idle_s"] == pytest.approx({2: 330e-9, 7: 205e-9,
                                           3: 300e-9})
    assert sum(dev["idle_s"].values()) == \
        pytest.approx(dev["window_s"] - dev["busy_s"])
    assert dev["device_s"] == pytest.approx({6: 70e-9, 9: 45e-9,
                                             None: 50e-9})
    assert dev["copy_bytes"] == {9: 640}
    assert dev["kernel_s"] == pytest.approx(
        {"scatter_add": 70e-9, "Memcpy DtoH": 45e-9, "late": 50e-9})
    assert [n for n, _s in dev["device_ops"]] == ["scatter_add", "late",
                                                 "Memcpy DtoH"]
    assert pt.read_device(Prof([]), SPANS) is None


def test_idle_gaps_sum_to_the_idle_time_and_name_program_spans():
    # no serve span, and a window that runs on past every span: the
    # last gap is outside the program's spans
    spans = SPANS[1:]
    ctx = {"program": trace.Trace(spans, {}),
           "program_device": pt.read_device(window_trace(2000), spans)}
    gaps = pt.program_idle_gaps(ctx)
    dev = ctx["program_device"]
    assert sum(s for _n, s in gaps) == pytest.approx(
        dev["window_s"] - dev["busy_s"], rel=1e-9)
    assert dict(gaps) == pytest.approx({
        pt.OUTSIDE: 800e-9, "engine.run": 330e-9,
        "enumeration.fused": 300e-9, "fused.round": 205e-9})
    assert {n for n, _s in gaps} <= {s.name for s in spans} | {pt.OUTSIDE}


def test_metrics_from_hand_made_traces():
    window = trace.Trace(SPANS, {"k5.dispatches": 2, "k5.rows": 90,
                                 "k5.prefix_bytes": 720, "k5.members": 3,
                                 "k5.candidate_edges": 40})
    setup = trace.Trace([span("index.resolve", 0, 4_000_000, 1),
                         span("index.resolve", 5_000_000, 7_000_000, 2)],
                        {"index.misses": 3})
    ctx = {"program": window, "program_setup": setup,
           "program_device": pt.read_device(window_trace(), SPANS,
                                             {12: 640}),
           "peaks": {"hbm_bytes_per_s": 1e12}}
    assert pt.k5_device_ms_per_dispatch(ctx) == pytest.approx(70e-6 / 2)
    assert pt.fused_rows_per_dispatch(ctx) == 45.0
    assert pt.fused_idle_ms_per_dispatch(ctx) == \
        pytest.approx((205e-6 + 300e-6) / 2)
    assert pt.serve_host_ms_per_query(ctx) == pytest.approx(200e-6 / 4)
    assert pt.index_ms_per_miss(ctx) == pytest.approx(2.0)
    assert pt.k5_input_bytes(ctx) == 720 + 12 * 90 + 4 * 40 + 52 * 3
    assert pt.k5_output_bytes(ctx) == 640
    assert pt.device_tied_pct(ctx) == pytest.approx(100 * 115 / 165)
    gaps = pt.program_idle_gaps(ctx)
    assert [n for n, _s in gaps] == ["engine.run", "enumeration.fused",
                                     "fused.round"]
    assert [s for _n, s in gaps] == pytest.approx([330e-9, 300e-9, 205e-9])
    # the device's idle share is 1 - the union of its operations over
    # the window, as before the program's spans were read
    assert readers.device_idle_pct(ctx) == pytest.approx(100 * (1 - 0.165))
    # no operation named frontier_fused: no K5 time to divide by
    assert readers.k5_roofline_pct(ctx) is None
    ctx["program_device"]["kernel_s"]["frontier_fused_hop"] = 1e-6
    assert readers.k5_roofline_pct(ctx) == pytest.approx(
        100 * (720 + 1080 + 160 + 156 + 640) / 1e12 / 1e-6)


@pytest.mark.parametrize("read", list(READS.values())
                         + [pt.program_idle_gaps, pt.device_tied_pct,
                            pt.k5_input_bytes, pt.k5_output_bytes],
                         ids=list(READS) + ["program_idle_gaps",
                                            "device_tied_pct",
                                            "k5_input_bytes",
                                            "k5_output_bytes"])
def test_readers_are_silent_without_the_programs_spans(read):
    # a run of a program without the recorder, or an untraced run,
    # leaves nothing to read
    assert read({"records": [], "window_s": 0.0}) is None
    empty = trace.Trace([], {})
    assert read({"program": empty, "program_setup": empty,
                 "program_device": None}) is None


@pytest.mark.parametrize("metric", sorted(NEW))
def test_reader_files_call_program_trace(metric):
    ctx = {"program": trace.Trace(SPANS, {"k5.dispatches": 2,
                                          "k5.rows": 90}),
           "program_setup": trace.Trace([span("index.resolve", 0, 10, 1)],
                                        {"index.misses": 1}),
           "program_device": pt.read_device(window_trace(), SPANS)}
    assert harness.metric_reader(metric)(ctx) == READS[metric](ctx)
    assert READS[metric](ctx) is not None


@pytest.mark.parametrize("cell", CLOSED)
def test_traced_cell_reads_the_programs_metrics(tiny, cell):
    spec, base = tiny
    result = harness.run_cell(cell, SEED, 0.5, True, device="cpu",
                              spec=spec, base=base)
    assert not trace.enabled()
    assert result["correct"], result["checks"]
    wanted = {m["name"]: m["source"] for m in spec["per_layer"]
              if cell in m["workloads"]}
    assert NEW <= set(wanted)
    # every per-layer metric is read; the CPU has no device operations,
    # so those read from the device trace find nothing there
    assert set(result["metrics"]) == {m for m, src in wanted.items()
                                      if src != "device_trace"}
    values = {m: v["value"] for m, v in result["metrics"].items()}
    assert values["cache_hit_pct.batch"] == 100.0
    assert values["fused_rows_per_dispatch.batch"] >= 1
    assert values["serve_host_ms_per_query.batch"] > 0
    assert values["index_ms_per_miss.setup"] > 0
    program = result["program"]
    assert program["counters"]["k5.dispatches"] >= 1
    assert program["k5_input_bytes"] > 0
    assert program["k5_output_bytes"] is None
    assert program["recorder"]["span_on_ns"] > 0
    assert program["recorder"]["cost_pct"] > 0
    gaps = result["breakdown"]["idle_gaps"]
    assert gaps and {n for n, _s in gaps} <= \
        set(program["self_s"]) | {pt.OUTSIDE}
    assert sum(s for _n, s in gaps) == pytest.approx(
        result["device"]["window_s"] - result["device"]["busy_s"])


def _window_probe(monkeypatch):
    """What ``trace.enabled()`` read at the start of each of the closed
    loop's calls: the warm-up batch's, then the window's."""
    seen = []
    loop = loops.closed_loop

    def probe(*args, **kw):
        seen.append(trace.enabled())
        return loop(*args, **kw)
    monkeypatch.setattr(loops, "closed_loop", probe)
    return seen


@pytest.mark.parametrize("traced,raises", [(False, False), (True, False),
                                           (True, True)],
                         ids=["trace0", "trace1", "trace1_raises"])
def test_harness_runs_leave_the_recorder_off(tiny, monkeypatch, traced,
                                             raises):
    # an untraced run never switches the recorder on; a traced run has
    # it on through set-up and window and off at its end, also when the
    # run raises (here in the comparison, after the window)
    spec, base = tiny
    trace.drain()
    seen = _window_probe(monkeypatch)
    enables = []
    enable = trace.enable
    monkeypatch.setattr(trace, "enable",
                        lambda: (enables.append(1), enable())[1])
    if raises:
        def compare(*args, **kw):
            raise RuntimeError("planted")
        monkeypatch.setattr(harness.checks, "compare", compare)
        with pytest.raises(RuntimeError, match="planted"):
            harness.run_cell("tiny-k3.recurring-count", SEED, 0.3, traced,
                             device="cpu", spec=spec, base=base)
    else:
        result = harness.run_cell("tiny-k3.recurring-count", SEED, 0.3,
                                  traced, device="cpu", spec=spec, base=base)
        assert result["correct"]
        keys = (LINE[:5] + (["breakdown", "program"] if traced else [])
                + LINE[5:])
        assert list(result) == keys
        assert bool(set(result["metrics"]) & NEW) == traced
    assert seen == [traced, traced]
    assert bool(enables) == traced
    assert not trace.enabled()
    assert trace.drain() == trace.Trace([], {})


def test_layer_readers_read_what_they_read_before(tiny, monkeypatch):
    # the engine's batch counters, collected as the benchmark collected
    # them before the program's recorder was read (a wrapper on the
    # engine's run, from the window's start), give the same readings as
    # the traced run's own context
    spec, base = tiny
    before = []
    armed = []
    orig = port_batch.BatchPathEnum.run

    def run_(self, *args, **kw):
        out = orig(self, *args, **kw)
        if armed:
            before.append(tracing.batch_counters(out))
        return out
    monkeypatch.setattr(port_batch.BatchPathEnum, "run", run_)
    loop = loops.closed_loop

    def arming(*args, **kw):
        if args[-1] > 0:  # the window, not the warm-up batch
            armed.append(True)
        return loop(*args, **kw)
    monkeypatch.setattr(loops, "closed_loop", arming)
    ctx: dict = {}
    result = harness.run_cell("tiny-k3.recurring-count", SEED, 0.5, True,
                              device="cpu", spec=spec, base=base, keep=ctx)
    assert ctx["batches"] == before and before
    old = {"batches": before}
    for metric, read in [
            ("cache_hit_pct.batch", readers.cache_hit_pct),
            ("join_plan_pct.batch", readers.join_plan_pct),
            ("optimize_ms_per_query.batch",
             lambda c: readers.per_distinct_ms(c, "optimize_s")),
            ("enumerate_ms_per_query.batch",
             lambda c: readers.per_distinct_ms(c, "enumerate_s"))]:
        assert result["metrics"][metric]["value"] == read(old)
        assert read(ctx) == read(old)


def test_a_reader_added_as_a_file_needs_no_harness_edit(tiny, tmp_path):
    # a later metric over a program span: one file under metrics/ and
    # one entry in the benchmark's spec
    spec, base = tiny
    mine = tmp_path / "cells"
    shutil.copytree(base, mine)
    (mine / "metrics" / "fused_pack_self_ms.batch.py").write_text(
        '"""Self milliseconds of fused.pack spans in the window."""\n'
        "from hcpe_bench import program_trace\n\n\n"
        "def read(ctx):\n"
        "    got = ctx.get(\"program\")\n"
        "    if got is None:\n"
        "        return None\n"
        "    return 1e3 * program_trace.self_seconds(got.spans).get(\n"
        "        \"fused.pack\")\n")
    cell = "tiny-k3.recurring-count"
    spec = dict(spec, per_layer=spec["per_layer"] + [
        {"name": "fused_pack_self_ms.batch", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "enumeration",
         "moves": "queries_per_s", "workloads": [cell]}])
    result = harness.run_cell(cell, SEED, 0.3, True, device="cpu",
                              spec=spec, base=mine)
    assert result["correct"]
    assert result["metrics"]["fused_pack_self_ms.batch"]["value"] > 0
    assert result["metrics"]["fused_pack_self_ms.batch"]["value"] < \
        1e3 * result["device"]["window_s"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CLOSED)
def test_k5_output_bytes_are_the_hops_heads_and_children(tiny, cuda_device,
                                                         monkeypatch, cell):
    # what the device copied back in fused.readback is each dispatch's
    # head and the child rows K5's hop wrote, summed here from the heads
    spec, base = tiny
    from repro_torch.kernels import ops as kops
    want = []
    orig = kops.frontier_expand_fused

    def spy(paths, *args, **kw):
        out = orig(paths, *args, **kw)
        if trace.enabled():
            m = out[2].shape[0]
            rows = int(out[2].sum()) + int(out[3].sum())
            want.append(24 * m + 4 * paths.shape[1] * rows)
        return out
    monkeypatch.setattr(kops, "frontier_expand_fused", spy)
    ctx: dict = {}
    result = harness.run_cell(cell, SEED, 1.0, True, device=cuda_device,
                              spec=spec, base=base, keep=ctx)
    assert result["correct"], result["checks"]
    # the spy's own reads of the head run before each dispatch's
    # readback, outside fused.readback
    assert pt.k5_output_bytes(ctx) == sum(want[-ctx["program"].counters[
        "k5.dispatches"]:])
