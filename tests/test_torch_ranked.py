"""Ranked (any-k) enumeration of the port against ``repro``'s, mirroring
tests/test_ranked.py case for case (DESIGN.md §10).

Each case runs ``repro`` (its host backend) and the port (``device=
"cpu"``, under ``backend="host"`` and ``"device"``) on the same seeded
graph and weights.  Results must be equal in rows, emission order,
``count``, ``exhausted`` and ``EnumStats`` (``chunks`` included), and
costs and bounds bit for bit.  The port's ``order="hops"`` device leg is
the rank-bucketed driver on K1's hop entry (its plain version here); its
reference is ``repro``'s bucketed driver on ``repro``'s host step, which
``repro`` pins bit-identical to its Pallas step, so no JAX interpret
mode runs.  ``order="weight"`` resolves to the host heap on both
backends, as in ``repro``.  Serving cases live in
tests/test_torch_async_server.py.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import enumerate as jen
from repro_torch.core import clock as tclock
from repro_torch.core import enumerate as ten
from repro_torch.core.constraints import AccumulativeValue
from repro_torch.serving import GraphRegistry

ORDERS = ("hops", "weight")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed):
    """One random digraph + query with tie-heavy integer weights, built
    in both packages from the same edges."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 26))
    m = max(1, int(n * float(rng.choice([1.0, 2.0, 3.5]))))
    edges = rng.integers(0, n, size=(m, 2))
    jg, tg = rc.from_edges(n, edges), tc.from_edges(n, edges)
    s, t = map(int, rng.choice(n, 2, replace=False))
    k = int(rng.integers(3, 7))
    w = rng.integers(0, 4, size=jg.m).astype(np.float64)
    return jg, tg, s, t, k, w


def _indexes(jg, tg, s, t, k):
    return rc.build_index(jg, s, t, k), tc.build_index(tg, s, t, k,
                                                       device="cpu")


def _assert_result(want, got, tag=""):
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag
    assert got.as_tuples() == want.as_tuples(), tag
    np.testing.assert_array_equal(got.paths, want.paths, err_msg=tag)
    np.testing.assert_array_equal(got.lengths, want.lengths, err_msg=tag)
    assert got.paths.dtype == want.paths.dtype == np.int32, tag


def _repro_device(jidx, order, weights, chunk_size=16384, **kw):
    """``repro``'s device leg without JAX: ``order="hops"`` through its
    bucketed driver on its host step, ``order="weight"`` on the heap
    (where ``repro``'s resolve_backend sends it)."""
    if order != "hops":
        return rc.enumerate_paths_idx(jidx, order=order, weights=weights,
                                      chunk_size=chunk_size, **kw)
    return jen._drive_ranked_buckets(
        jidx, jen._host_step(jidx, None), chunk_size=chunk_size,
        count_only=kw.get("count_only", False), first_n=kw.get("first_n"),
        max_results=kw.get("max_results"), deadline=kw.get("deadline"))


def _runners(jidx, idx, k):
    """Every ranked backend as (label, repro fn, port fn), each taking
    ``order``, ``weights`` and the anytime keywords."""
    cut = max(1, k // 2)
    return [
        ("dfs", lambda **kw: rc.enumerate_paths_idx(jidx, **kw),
         lambda **kw: tc.enumerate_paths_idx(idx, backend="host",
                                             device="cpu", **kw)),
        ("device", lambda **kw: _repro_device(jidx, **kw),
         lambda **kw: tc.enumerate_paths_idx(idx, backend="device",
                                             device="cpu", **kw)),
        ("join", lambda **kw: rc.enumerate_paths_join(jidx, cut=cut, **kw),
         lambda **kw: tc.enumerate_paths_join(idx, cut=cut, **kw)),
    ]


# ---------------------------------------------------------------------------
# input validation
# ---------------------------------------------------------------------------

def test_make_rank_spec_validation():
    assert tc.make_rank_spec(None, None) is None
    assert tc.make_rank_spec("hops", None).order == "hops"
    spec = tc.make_rank_spec("weight", np.ones(3, dtype=np.float32))
    assert spec.is_weight and spec.weights.dtype == np.float64
    assert spec == tc.RankSpec(order="weight", weights=spec.weights)
    bad = [("cheapest", None), ("weight", None),
           ("weight", np.array([1.0, -0.5])),
           ("weight", np.array([1.0, np.nan])),
           ("weight", np.ones((2, 2)))]
    for order, w in bad:
        with pytest.raises(ValueError) as want:
            rc.make_rank_spec(order, w)
        with pytest.raises(ValueError) as got:
            tc.make_rank_spec(order, w)
        assert str(got.value) == str(want.value)
    assert tc.rank.weight_slack(-3.0) == rc.rank.weight_slack(-3.0)
    assert tc.rank.WEIGHT_TIE_SLACK == rc.rank.WEIGHT_TIE_SLACK


def test_order_and_constraint_are_mutually_exclusive():
    jg, tg, s, t, k, w = _case(0)
    idx = tc.build_index(tg, s, t, k, device="cpu")
    cons = AccumulativeValue(weights=w, op=np.add, init=0.0,
                             accept=lambda b: True)
    for backend in ("host", "device"):
        with pytest.raises(ValueError, match="constraint"):
            tc.enumerate_paths_idx(idx, order="hops", constraint=cons,
                                   backend=backend, device="cpu")
    with pytest.raises(ValueError, match="constraint"):
        tc.enumerate_paths_join(idx, cut=1, order="weight", weights=w,
                                constraint=cons)
    with pytest.raises(ValueError, match="constraint"):
        tc.PathEnum(device="cpu").query(tg, s, t, k, mode="dfs",
                                        order="hops", constraint=cons)


def test_registry_edge_weights_shape_validation():
    g = tc.erdos_renyi(12, 2.0, seed=1)
    reg = GraphRegistry()
    with pytest.raises(ValueError, match="edge_weights"):
        reg.register("g", g, edge_weights=np.ones(g.m + 1))
    entry = reg.register("g", g, edge_weights=np.ones(g.m, dtype=np.float32))
    assert entry.edge_weights.dtype == np.float64    # canonical accumulation


def test_resolve_backend_routes_like_repro(monkeypatch):
    monkeypatch.delenv("REPRO_DEVICE_ENUM", raising=False)
    jg, tg, s, t, k, w = _case(3)
    jidx, idx = _indexes(jg, tg, s, t, k)
    cons = AccumulativeValue(weights=w)
    for backend in (None, "host", "device"):
        for c, order in ((None, None), (cons, None), (None, "hops"),
                         (None, "weight")):
            assert tc.resolve_backend(idx, backend, c, order=order) == \
                rc.resolve_backend(jidx, backend, c, order=order), \
                (backend, c, order)
    monkeypatch.setenv("REPRO_DEVICE_ENUM", "off")
    assert tc.resolve_backend(idx, "device", None, order="hops") == "host"


# ---------------------------------------------------------------------------
# costs and bounds: bit for bit, float64 or int64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_costs_and_bounds_equal_repro_bit_for_bit(seed):
    jg, tg, s, t, k, w = _case(200 + seed)
    jidx, idx = _indexes(jg, tg, s, t, k)
    full = tc.enumerate_paths_idx(idx, backend="host", device="cpu")
    for order in ORDERS:
        weights = w if order == "weight" else None
        jspec = rc.make_rank_spec(order, weights)
        tspec = tc.make_rank_spec(order, weights)
        want_dt = np.float64 if order == "weight" else np.int64
        got = tc.rank.path_costs(idx, full.paths, full.lengths, tspec)
        want = rc.rank.path_costs(jidx, full.paths, full.lengths, jspec)
        assert got.dtype == want.dtype == want_dt
        assert got.tobytes() == want.tobytes(), order
        got_lb = tc.rank.remaining_lower_bound(idx, tspec)
        want_lb = rc.rank.remaining_lower_bound(jidx, jspec)
        assert got_lb.dtype == want_lb.dtype == want_dt
        assert got_lb.tobytes() == want_lb.tobytes(), order
        pos = np.arange(idx.num_index_edges, dtype=np.int64)
        got_step = tc.rank.edge_step_costs(idx, tspec, pos)
        assert got_step.dtype == want_dt
        assert got_step.tobytes() == rc.rank.edge_step_costs(
            jidx, jspec, pos).tobytes()
        for a, b in zip(tc.rank.index_edge_table(idx, w),
                        rc.rank.index_edge_table(jidx, w)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert tc.rank.path_costs(idx, full.paths, full.lengths,
                              None).dtype == np.int64


def test_cost_dtypes_never_narrow():
    """The port's rank costs and bounds stay float64 (hops: int64) even
    when the weights come in as float32 or integers (the rule ``repro``
    lints in analysis/passes/rank_dtype.py)."""
    jg, tg, s, t, k, w = _case(5)
    idx = tc.build_index(tg, s, t, k, device="cpu")
    for wd in (np.float32, np.int64, np.float64):
        spec = tc.make_rank_spec("weight", w.astype(wd))
        assert spec.weights.dtype == np.float64
        assert tc.rank.remaining_lower_bound(idx, spec).dtype == np.float64
        pos = np.arange(idx.num_index_edges, dtype=np.int64)
        assert tc.rank.edge_step_costs(idx, spec, pos).dtype == np.float64
        res = tc.enumerate_paths_idx(idx, order="weight", weights=w.astype(wd),
                                     device="cpu")
        costs = tc.rank.path_costs(idx, res.paths, res.lengths, spec)
        assert costs.dtype == np.float64
        assert np.all(np.diff(costs) >= 0)
    hops = tc.make_rank_spec("hops", None)
    assert tc.rank.remaining_lower_bound(idx, hops).dtype == np.int64
    assert tc.join._half_costs(
        idx, np.full((2, 3), t, np.int32), hops).dtype == np.int64
    assert tc.join._half_costs(
        idx, np.full((2, 3), t, np.int32),
        tc.make_rank_spec("weight", w.astype(np.float32))).dtype == np.float64


# ---------------------------------------------------------------------------
# anytime prefix-optimality: first_n is the top-n, on every backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("order", ORDERS)
def test_first_n_is_rank_optimal_prefix(seed, order):
    jg, tg, s, t, k, w = _case(100 + seed)
    weights = w if order == "weight" else None
    jidx, idx = _indexes(jg, tg, s, t, k)
    for label, ref, run in _runners(jidx, idx, k):
        full = run(order=order, weights=weights)
        _assert_result(ref(order=order, weights=weights), full, label)
        assert full.exhausted
        total = full.count
        seq = full.as_tuples()
        for n in {0, 1, 2, max(0, total - 1), total, total + 5}:
            got = run(order=order, weights=weights, first_n=n)
            _assert_result(ref(order=order, weights=weights, first_n=n),
                           got, f"{label} n={n} seed={seed}")
            assert got.as_tuples() == seq[:n], (label, n, seed)
            assert got.exhausted == (max(n, 1) > total), (label, n, seed)


@pytest.mark.parametrize("order", ORDERS)
def test_batch_first_n_is_rank_optimal_prefix(order):
    jg, tg, s, t, k, w = _case(7)
    weights = w if order == "weight" else None
    for backend in ("host", "device"):
        full = tc.BatchPathEnum(backend=backend, device="cpu").run(
            tg, [(s, t, k)], count_only=False, order=order,
            weights=weights).items[0].result
        want = rc.BatchPathEnum().run(jg, [(s, t, k)], count_only=False,
                                      order=order,
                                      weights=weights).items[0].result
        assert full.as_tuples() == want.as_tuples()
        for mode in ("dfs", "join"):
            got = tc.BatchPathEnum(backend=backend, device="cpu").run(
                tg, [(s, t, k)], count_only=False, mode=mode, first_n=2,
                order=order, weights=weights).items[0].result
            assert got.as_tuples() == full.as_tuples()[:2], (backend, mode)


# ---------------------------------------------------------------------------
# anytime prefix-optimality: every deadline cut is a ranked prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("order", ORDERS)
def test_expired_deadline_returns_empty_unexhausted(order):
    jg, tg, s, t, k, w = _case(11)
    weights = w if order == "weight" else None
    jidx, idx = _indexes(jg, tg, s, t, k)
    for label, ref, run in _runners(jidx, idx, k):
        got = run(order=order, weights=weights,
                  deadline=tclock.now() - 1.0)
        want = ref(order=order, weights=weights,
                   deadline=time.perf_counter() - 1.0)
        _assert_result(want, got, label)
        assert got.count == 0 and not got.exhausted, label


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("order", ORDERS)
def test_mid_run_deadline_is_rank_optimal_prefix(seed, order):
    """Whatever instant the budget expires at, the emitted paths are
    exactly the best-ranked prefix of repro's full ranked sequence."""
    rng = np.random.default_rng(300 + seed)
    jg = rc.erdos_renyi(40, 4.0, seed=300 + seed)
    tg = tc.erdos_renyi(40, 4.0, seed=300 + seed)
    s, t = map(int, rng.choice(jg.n, 2, replace=False))
    k = 7
    w = rng.integers(0, 4, size=jg.m).astype(np.float64)
    weights = w if order == "weight" else None
    jidx, idx = _indexes(jg, tg, s, t, k)
    full = rc.enumerate_paths_idx(jidx, order=order,
                                  weights=weights).as_tuples()
    for label, _ref, run in _runners(jidx, idx, k):
        assert run(order=order, weights=weights).as_tuples() == full, label
        for budget in (0.0005, 0.002, 0.01):
            got = run(order=order, weights=weights,
                      deadline=tclock.now() + budget)
            seq = got.as_tuples()
            assert seq == full[:len(seq)], (label, budget)
            if got.exhausted:
                assert len(seq) == len(full), (label, budget)


# ---------------------------------------------------------------------------
# unranked canonicalization: order=None exhausted output is plan-invariant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(10))
def test_unranked_exhausted_order_is_canonical_across_backends(seed):
    jg, tg, s, t, k, w = _case(400 + seed)
    idx = tc.build_index(tg, s, t, k, device="cpu")
    want = sorted(rc.oracle.enumerate_paths(jg, s, t, k),
                  key=lambda p: (len(p), p))
    for backend in ("host", "device"):
        assert tc.enumerate_paths_idx(idx, backend=backend,
                                      device="cpu").as_tuples() == want
    for cut in {1, max(1, k // 2), k - 1}:
        assert tc.enumerate_paths_join(idx, cut=cut).as_tuples() == want
    for mode in ("auto", "dfs", "join"):
        out = tc.BatchPathEnum(device="cpu").run(tg, [(s, t, k)],
                                                  count_only=False, mode=mode)
        assert out.items[0].result.as_tuples() == want


# ---------------------------------------------------------------------------
# PathEnum front door
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ("dfs", "join"))
@pytest.mark.parametrize("order", ORDERS)
def test_pathenum_query_order_threading(mode, order):
    jg, tg, s, t, k, w = _case(21)
    weights = w if order == "weight" else None
    want = rc.oracle.enumerate_paths(jg, s, t, k, order=order,
                                     weights=weights)
    assert tc.oracle.enumerate_paths(tg, s, t, k, order=order,
                                     weights=weights) == want
    for backend in ("host", "device"):
        pe = tc.PathEnum(backend=backend, device="cpu")
        for first_n in (None, 3):
            got = pe.query(tg, s, t, k, mode=mode, first_n=first_n,
                           order=order, weights=weights)
            ref = rc.PathEnum().query(jg, s, t, k, mode=mode,
                                      first_n=first_n, order=order,
                                      weights=weights)
            if backend == "host" or order == "weight" or mode == "join":
                _assert_result(ref.result, got.result, (backend, first_n))
            assert got.result.as_tuples() == want[:first_n], (backend,
                                                               first_n)


# ---------------------------------------------------------------------------
# the rank-order oracle fuzz (tests/test_oracle_fuzz.py's ranked smoke)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(12))
def test_ranked_engines_match_oracle_and_repro(seed):
    jg, tg, s, t, k, w = _case(900 + seed)
    jidx, idx = _indexes(jg, tg, s, t, k)
    for order in ORDERS:
        weights = w if order == "weight" else None
        want = tc.oracle.enumerate_paths(tg, s, t, k, order=order,
                                         weights=weights)
        for label, ref, run in _runners(jidx, idx, k):
            got = run(order=order, weights=weights)
            _assert_result(ref(order=order, weights=weights), got,
                           f"{label} {order} seed={seed}")
            assert got.as_tuples() == want, (label, order, seed)
        for cut in {1, k - 1}:
            got = tc.enumerate_paths_join(idx, cut=cut, order=order,
                                          weights=weights)
            _assert_result(rc.enumerate_paths_join(
                jidx, cut=cut, order=order, weights=weights), got,
                f"join cut={cut}")
        for mode in ("auto", "dfs", "join"):
            out = tc.BatchPathEnum(device="cpu").run(
                tg, [(s, t, k)], count_only=False, mode=mode, order=order,
                weights=weights)
            assert out.items[0].result.as_tuples() == want, (mode, order)


def test_bucketed_driver_with_small_chunks_equals_repro():
    """Small ``chunk_size``: each (bucket, depth) splits into several
    chunks, and the port's device leg still equals repro's bucketed
    driver, ``chunks`` included."""
    jg = rc.erdos_renyi(30, 6.0, seed=5)
    tg = tc.erdos_renyi(30, 6.0, seed=5)
    jidx, idx = _indexes(jg, tg, 0, 29, 5)
    for first_n in (None, 40):
        want = _repro_device(jidx, "hops", None, chunk_size=5,
                             first_n=first_n)
        got = tc.enumerate_paths_idx(idx, backend="device", device="cpu",
                                     order="hops", chunk_size=5,
                                     first_n=first_n)
        _assert_result(want, got, f"first_n={first_n}")
        assert got.stats.chunks > 8


def test_device_hops_takes_the_bucketed_driver(monkeypatch):
    """``order="hops"`` on the device backend runs `_drive_ranked_buckets`
    over K1's hop entry (``ops.frontier_expand_readback``), never the
    resident deque or the host heap; ``order="weight"`` runs the heap."""
    from repro_torch.kernels import ops as tops
    tg = tc.erdos_renyi(30, 6.0, seed=5)
    w = np.random.default_rng(5).integers(0, 4, size=tg.m).astype(np.float64)
    idx = tc.build_index(tg, 0, 29, 5, device="cpu")
    calls = {"hop": 0, "heap": 0}
    real_hop = tops.frontier_expand_readback
    real_heap = ten._drive_ranked_heap
    monkeypatch.setattr(tops, "frontier_expand_readback",
                        lambda *a, **kw: calls.__setitem__(
                            "hop", calls["hop"] + 1) or real_hop(*a, **kw))
    monkeypatch.setattr(ten, "_drive_ranked_heap",
                        lambda *a, **kw: calls.__setitem__(
                            "heap", calls["heap"] + 1) or real_heap(*a, **kw))
    monkeypatch.setattr(tops, "frontier_deque_round",
                        lambda *a, **kw: pytest.fail("resident deque ran"))
    res = tc.enumerate_paths_idx(idx, backend="device", device="cpu",
                                 order="hops")
    assert res.count and calls == {"hop": calls["hop"], "heap": 0}
    assert calls["hop"] > 0
    tc.enumerate_paths_idx(idx, backend="device", device="cpu",
                           order="weight", weights=w)
    assert calls["heap"] == 1
