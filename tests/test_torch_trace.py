"""The port's recorder (``repro_torch.core.trace``) and the spans and
counters the program records with it, on the CPU.

* Off by default: nothing is kept and ``span`` hands back the one shared
  no-op.
* Parent and root ids nest, per thread.
* A fused ``BatchPathEnum.run`` records the spans of each layer, and its
  K5 counters equal what the dispatches saw (``fused_dispatches``, the
  rows handed to ``frontier_expand_fused``).
* Results are identical with the recorder on and off.
* A span lies inside the ``torch.profiler`` range it was opened in: the
  two share one clock.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import fused as tfused
from repro_torch.core import trace
from repro_torch.kernels import ops
from repro_torch.serving import hcpe

CHUNK = 7
QUERIES = [(0, 39, 4), (1, 38, 4), (2, 37, 3), (3, 36, 4), (0, 38, 4),
           (0, 37, 3), (0, 39, 4), (5, 39, 5), (1, 38, 4)]
# every span the engine and the sync server record
PROGRAM_SPANS = {"serve", "engine.run", "index.resolve", "index.distances",
                 "index.build", "planner.plan", "enumeration.shared",
                 "enumeration.fused", "enumeration.dfs", "enumeration.join",
                 "fused.round", "fused.pop", "fused.pack", "fused.readback",
                 "fused.tail", "k5.dispatch", "k5.stage", "k5.launch"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def recorder():
    """The recorder switched on, empty, and off and empty again after."""
    trace.drain()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.drain()


def _graph():
    return tc.erdos_renyi(40, 5.0, seed=17)


def _engine(**kw):
    return tc.BatchPathEnum(device="cpu", chunk_size=CHUNK, **kw)


def test_off_by_default_records_nothing():
    assert not trace.enabled()
    assert trace.span("serve") is trace.OFF
    assert trace.span("k5.dispatch", {"x": 1}) is trace.OFF
    with trace.span("serve") as got:
        assert got is None
        trace.count("k5.rows", 5)
    out = _engine().run(_graph(), QUERIES, count_only=True)
    assert out.fused_dispatches >= 1
    assert trace.drain() == trace.Trace([], {})


def test_nesting_parents_and_roots(recorder):
    with trace.span("outside"):
        pass
    with trace.span("serve", {"uids": [7, 8]}):
        with trace.span("engine.run"):
            with trace.span("fused.round"):
                trace.count("k5.rows", 3)
                trace.count("k5.rows")
    with trace.span("engine.run"):
        with trace.span("planner.plan"):
            pass
    got = trace.drain()
    by = {}
    for s in got.spans:
        by.setdefault(s.name, []).append(s)
    (outside,), (serve,), (plan,) = (by["outside"], by["serve"],
                                     by["planner.plan"])
    run_in_serve, run_alone = sorted(by["engine.run"], key=lambda s: s.id)
    (rnd,) = by["fused.round"]
    assert (outside.parent, outside.root) == (0, 0)
    assert (serve.parent, serve.root, serve.attrs) == \
        (0, serve.id, {"uids": [7, 8]})
    assert (run_in_serve.parent, run_in_serve.root) == (serve.id, serve.id)
    assert (rnd.parent, rnd.root) == (run_in_serve.id, serve.id)
    assert (run_alone.parent, run_alone.root) == (0, run_alone.id)
    assert (plan.parent, plan.root) == (run_alone.id, run_alone.id)
    assert serve.start_ns <= run_in_serve.start_ns <= rnd.start_ns \
        <= rnd.end_ns <= run_in_serve.end_ns <= serve.end_ns
    assert len({s.id for s in got.spans}) == len(got.spans)
    assert got.counters == {"k5.rows": 4}
    assert trace.drain() == trace.Trace([], {})


def test_threads_keep_their_own_stacks(recorder):
    both_open = threading.Barrier(2, timeout=10)

    def worker(name):
        with trace.span("engine.run", {"who": name}):
            both_open.wait()
            with trace.span("planner.plan", {"who": name}):
                pass

    threads = [threading.Thread(target=worker, args=(n,)) for n in "ab"]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    assert not any(th.is_alive() for th in threads)
    spans = trace.drain().spans
    runs = {s.attrs["who"]: s for s in spans if s.name == "engine.run"}
    plans = {s.attrs["who"]: s for s in spans if s.name == "planner.plan"}
    assert set(runs) == set(plans) == {"a", "b"}
    for who in "ab":
        assert runs[who].parent == 0 and runs[who].root == runs[who].id
        assert plans[who].parent == runs[who].id
        assert plans[who].root == runs[who].id


def _served(engine, **kw):
    server = hcpe.HcPEServer(_graph(), engine=engine)
    reqs = [hcpe.PathQueryRequest(uid=i, s=s, t=t, k=k, **kw)
            for i, (s, t, k) in enumerate(QUERIES)]
    return server.serve(reqs)


def test_fused_run_spans_and_k5_counters(recorder, monkeypatch):
    rows = []
    orig = ops.frontier_expand_fused

    def seen(paths, *args, **kw):
        rows.append(np.asarray(paths).shape[0])
        return orig(paths, *args, **kw)
    monkeypatch.setattr(ops, "frontier_expand_fused", seen)
    engine = _engine(sharing="off", tau=1e5)
    out = engine.run(_graph(), QUERIES, count_only=False)
    got = trace.drain()
    assert out.fused_dispatches >= 1
    assert got.counters["k5.dispatches"] == out.fused_dispatches == len(rows)
    assert got.counters["k5.rows"] == sum(rows)
    assert got.counters["index.misses"] == out.cache_stats.misses
    names = {s.name for s in got.spans}
    assert {"engine.run", "index.resolve", "index.distances", "index.build",
            "planner.plan", "enumeration.fused", "fused.round", "fused.pop",
            "fused.pack", "fused.readback", "fused.tail", "k5.dispatch",
            "k5.stage", "k5.launch"} <= names
    by_id = {s.id: s for s in got.spans}
    (run,) = [s for s in got.spans if s.name == "engine.run"]
    assert run.attrs == {"queries": len(QUERIES),
                         "distinct": len(set(QUERIES))}
    parent_of = {"index.resolve": "engine.run",
                 "index.distances": "index.resolve",
                 "index.build": "index.resolve",
                 "enumeration.fused": "engine.run",
                 "fused.round": "enumeration.fused",
                 "fused.pop": "fused.round", "fused.pack": "fused.round",
                 "fused.readback": "fused.round", "fused.tail": "fused.round",
                 "k5.dispatch": "fused.round", "k5.stage": "k5.dispatch",
                 "k5.launch": "k5.dispatch"}
    for s in got.spans:
        if s.name in parent_of:
            assert by_id[s.parent].name == parent_of[s.name], s
        assert s.root == run.id
    assert sum(s.name == "k5.dispatch" for s in got.spans) \
        == out.fused_dispatches


@pytest.mark.parametrize("budget", [None, 16], ids=["rounds", "segments"])
def test_k5_byte_counters_count_each_dispatchs_inputs(recorder, monkeypatch,
                                                      budget):
    """``k5.prefix_bytes`` and ``k5.candidate_edges`` equal, summed over
    the dispatches, each row's prefix to its depth (int32) and each
    row's fan-out read off its member's index, also where a small slot
    budget splits a member's chunk over several dispatches."""
    if budget is not None:
        monkeypatch.setattr(tfused, "DEVICE_SLOT_BUDGET", budget)
    want = {"prefix": 0, "edges": 0, "members": 0, "split": 0}
    orig = ops.frontier_expand_fused

    def seen(paths, rank, tvec, depthv, begins, ends, dsts, wantc, **kw):
        rows = np.arange(len(rank))
        depth = np.asarray(depthv)[rank].astype(np.int64)
        want["prefix"] += 4 * int((depth + 1).sum())
        want["members"] += len(begins)
        want["split"] += len(set(rank.tolist())) < len(begins)
        last = paths[rows, depth]
        for j, (b, e) in enumerate(zip(begins, ends)):
            v = torch.from_numpy(last[rank == j].astype(np.int64))
            col = e.shape[1] - 2 - int(depthv[j])
            want["edges"] += int((e[v, col].long() - b[v].long()).sum())
        return orig(paths, rank, tvec, depthv, begins, ends, dsts, wantc,
                    **kw)
    monkeypatch.setattr(ops, "frontier_expand_fused", seen)
    out = _engine(sharing="off", tau=1e5).run(_graph(), QUERIES,
                                              count_only=False)
    got = trace.drain().counters
    assert out.fused_dispatches >= 1
    assert got["k5.prefix_bytes"] == want["prefix"] > 0
    assert got["k5.candidate_edges"] == want["edges"] > 0
    assert got["k5.members"] == want["members"]
    if budget is not None:
        assert want["split"] > 0


def test_every_span_is_recorded(recorder):
    """A served batch records its spans under one ``serve`` span that
    names its requests; with the solo join and DFS runs besides, every
    span of the program is seen."""
    _served(_engine(tau=1e5), count_only=False)
    got = trace.drain()
    (serve,) = [s for s in got.spans if s.name == "serve"]
    assert serve.attrs == {"uids": list(range(len(QUERIES)))}
    assert all(s.root == serve.id for s in got.spans)
    names = {s.name for s in got.spans}
    assert {"enumeration.shared", "enumeration.fused"} <= names
    for mode in ("join", "dfs"):
        _engine(fused="off", tau=1e5).run(_graph(), QUERIES,
                                          count_only=False, mode=mode)
    names |= {s.name for s in trace.drain().spans}
    assert names == PROGRAM_SPANS


@pytest.mark.parametrize("kw", [{"count_only": False},
                                {"count_only": False, "first_n": 3},
                                {"count_only": True}],
                         ids=["paths", "first_n", "count"])
def test_results_identical_with_the_recorder_on(kw):
    off = _engine().run(_graph(), QUERIES, **kw)
    trace.enable()
    try:
        on = _engine().run(_graph(), QUERIES, **kw)
    finally:
        trace.disable()
        trace.drain()
    assert (on.distinct_queries, on.fused_queries, on.fused_dispatches,
            on.shared_queries) == (off.distinct_queries, off.fused_queries,
                                   off.fused_dispatches, off.shared_queries)
    for a, b in zip(off.items, on.items):
        assert (b.s, b.t, b.k, b.fused, b.shared) == \
            (a.s, a.t, a.k, a.fused, a.shared)
        assert b.result.count == a.result.count
        assert b.result.exhausted == a.result.exhausted
        assert dataclasses.asdict(b.result.stats) == \
            dataclasses.asdict(a.result.stats)
        if kw["count_only"]:
            assert a.result.paths is None or a.result.paths.size == 0
        assert np.asarray(b.result.paths).tobytes() == \
            np.asarray(a.result.paths).tobytes()


def test_spans_share_the_profilers_clock(recorder):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("outer"):
            with trace.span("inner"):
                torch.ones(64).sum()
    (inner,) = trace.drain().spans
    (outer,) = [ev for ev in prof.profiler.kineto_results.events()
                if ev.name() == "outer"]
    start = outer.start_ns()
    assert start <= inner.start_ns <= inner.end_ns \
        <= start + outer.duration_ns()
