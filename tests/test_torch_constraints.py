"""Appendix-E constrained variants of the port against ``repro``'s and
the post-filtered oracle, mirroring tests/test_constraints.py case for
case.

Each case runs ``repro`` (host backend) and the port (``device="cpu"``,
under ``backend="host"`` and ``"device"``; a constrained query resolves
to the host walk on both) on the same seeded graph and edge values.  The
results must be equal in rows, emission order, ``count``, ``exhausted``
and ``EnumStats`` (the constraint's pruned and rejected partials count
as invalid), and equal to the oracle's paths post-filtered in Python.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import constraints as jcons
from repro_torch.core import constraints as tcons

BACKENDS = ("host", "device")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def edge_weight_map(g, weights):
    return {(int(a), int(b)): w
            for a, b, w in zip(g.esrc, g.edst, weights)}


def _graphs(n, deg, seed):
    return rc.erdos_renyi(n, deg, seed=seed), tc.erdos_renyi(n, deg,
                                                             seed=seed)


def _assert_result(want, got, tag=""):
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag
    assert got.as_tuples() == want.as_tuples(), tag
    np.testing.assert_array_equal(got.paths, want.paths, err_msg=tag)
    np.testing.assert_array_equal(got.lengths, want.lengths, err_msg=tag)


def _both(jg, tg, s, t, k, make, mode="dfs", cut=None, **kw):
    """``make(module)`` builds the constraint in ``repro`` and in the
    port; returns the port's results (one per backend), each checked
    equal to repro's."""
    want = rc.PathEnum().query(jg, s, t, k, mode=mode, cut=cut,
                               constraint=make(jcons), **kw).result
    got = []
    for backend in BACKENDS:
        res = tc.PathEnum(backend=backend, device="cpu").query(
            tg, s, t, k, mode=mode, cut=cut, constraint=make(tcons),
            **kw).result
        _assert_result(want, res, f"{mode} {backend}")
        got.append(res)
    return got


@pytest.mark.parametrize("seed", [0, 1])
def test_accumulative_constraint_matches_postfilter(seed):
    rng = np.random.default_rng(seed)
    jg, tg = _graphs(40, 4.0, seed + 20)
    weights = rng.uniform(0.0, 10.0, size=tg.m)
    wmap = edge_weight_map(tg, weights)
    s, t, k = 0, tg.n - 1, 5
    thresh = 18.0
    want = [p for p in tc.oracle.enumerate_paths(tg, s, t, k)
            if sum(wmap[(a, b)] for a, b in zip(p, p[1:])) >= thresh]

    def make(m):
        return m.AccumulativeValue(weights=weights, op=np.add, init=0.0,
                                   accept=lambda b: b >= thresh)
    for res in _both(jg, tg, s, t, k, make, mode="dfs"):
        assert sorted(res.as_tuples()) == sorted(want)
    # join mode applies the same constraint at join time
    for res in _both(jg, tg, s, t, k, make, mode="join", cut=2):
        assert sorted(res.as_tuples()) == sorted(want)


def test_accumulative_monotone_pruning_is_safe():
    rng = np.random.default_rng(3)
    jg, tg = _graphs(40, 4.0, 30)
    weights = rng.uniform(0.0, 5.0, size=tg.m)
    wmap = edge_weight_map(tg, weights)
    s, t, k = 0, tg.n - 1, 5
    upper = 10.0
    want = [p for p in tc.oracle.enumerate_paths(tg, s, t, k)
            if sum(wmap[(a, b)] for a, b in zip(p, p[1:])) <= upper]

    def make(m):
        return m.AccumulativeValue(weights=weights, op=np.add, init=0.0,
                                   accept=lambda b: b <= upper,
                                   monotone_upper=upper)
    unpruned = tc.PathEnum(device="cpu").query(
        tg, s, t, k, mode="dfs",
        constraint=tcons.AccumulativeValue(
            weights=weights, accept=lambda b: b <= upper)).result
    for res in _both(jg, tg, s, t, k, make):
        assert sorted(res.as_tuples()) == sorted(want)
        # pruning in flight cuts edge accesses, never results
        assert res.as_tuples() == unpruned.as_tuples()
        assert res.stats.edges_accessed < unpruned.stats.edges_accessed


@pytest.mark.parametrize("seed", [0, 1])
def test_action_sequence_dfa(seed):
    rng = np.random.default_rng(seed)
    jg, tg = _graphs(36, 4.0, seed + 50)
    labels = rng.integers(0, 2, size=tg.m)  # two actions: 0, 1
    lmap = edge_weight_map(tg, labels)
    s, t, k = 0, tg.n - 1, 4
    # DFA accepting label sequences 0*1*: states 0 "in zeros", 1 "in ones"
    A = np.array([[0, 1], [-1, 1]])
    accepting = np.array([True, True])

    def seq_ok(p):
        st = 0
        for a, b in zip(p, p[1:]):
            st = A[st][int(lmap[(a, b)])]
            if st < 0:
                return False
        return accepting[st]

    want = [p for p in tc.oracle.enumerate_paths(tg, s, t, k) if seq_ok(p)]

    def make(m):
        return m.ActionSequence(A=A, labels=labels, start=0,
                                accepting=accepting)
    for res in _both(jg, tg, s, t, k, make, mode="dfs"):
        assert sorted(res.as_tuples()) == sorted(want)
    for res in _both(jg, tg, s, t, k, make, mode="join", cut=2):
        assert sorted(res.as_tuples()) == sorted(want)


@pytest.mark.parametrize("mode,cut", [("dfs", None), ("join", 2)])
def test_accumulative_zero_weight_edges(mode, cut):
    rng = np.random.default_rng(9)
    jg, tg = _graphs(36, 4.0, 90)
    weights = np.where(rng.random(tg.m) < 0.7, 0.0,
                       rng.uniform(1.0, 3.0, size=tg.m))
    wmap = edge_weight_map(tg, weights)
    s, t, k = 0, tg.n - 1, 5
    want = [p for p in tc.oracle.enumerate_paths(tg, s, t, k)
            if sum(wmap[(a, b)] for a, b in zip(p, p[1:])) >= 2.0]

    def make(m):
        return m.AccumulativeValue(weights=weights, op=np.add, init=0.0,
                                   accept=lambda b: b >= 2.0)
    for res in _both(jg, tg, s, t, k, make, mode=mode, cut=cut):
        assert sorted(res.as_tuples()) == sorted(want)


@pytest.mark.parametrize("mode,cut", [("dfs", None), ("join", 2)])
def test_accumulative_float_tie_at_threshold(mode, cut):
    rng = np.random.default_rng(10)
    jg, tg = _graphs(36, 4.0, 91)
    weights = rng.integers(0, 3, size=tg.m).astype(np.float64)
    wmap = edge_weight_map(tg, weights)
    s, t, k = 0, tg.n - 1, 5
    thresh = 4.0
    all_paths = tc.oracle.enumerate_paths(tg, s, t, k)
    sums = {p: sum(wmap[(a, b)] for a, b in zip(p, p[1:]))
            for p in all_paths}
    assert any(v == thresh for v in sums.values())   # ties actually occur
    want = [p for p in all_paths if sums[p] >= thresh]

    def make(m):
        return m.AccumulativeValue(weights=weights, op=np.add, init=0.0,
                                   accept=lambda b: b >= thresh)
    for res in _both(jg, tg, s, t, k, make, mode=mode, cut=cut):
        assert sorted(res.as_tuples()) == sorted(want)


def test_accumulative_init_and_op_overrides():
    rng = np.random.default_rng(11)
    jg, tg = _graphs(32, 4.0, 92)
    s, t, k = 0, tg.n - 1, 5
    all_paths = tc.oracle.enumerate_paths(tg, s, t, k)

    widths = rng.uniform(0.5, 4.0, size=tg.m)
    wmap = edge_weight_map(tg, widths)
    want_max = [p for p in all_paths
                if max(wmap[(a, b)] for a, b in zip(p, p[1:])) >= 3.0]
    for res in _both(jg, tg, s, t, k, lambda m: m.AccumulativeValue(
            weights=widths, op=np.maximum, init=-np.inf,
            accept=lambda b: b >= 3.0)):
        assert sorted(res.as_tuples()) == sorted(want_max)

    probs = rng.uniform(0.5, 1.0, size=tg.m)
    pmap = edge_weight_map(tg, probs)
    want_mul = []
    for p in all_paths:
        prod = 1.0
        for a, b in zip(p, p[1:]):
            prod = prod * pmap[(a, b)]
        if prod >= 0.25:
            want_mul.append(p)
    for res in _both(jg, tg, s, t, k, lambda m: m.AccumulativeValue(
            weights=probs, op=np.multiply, init=1.0,
            accept=lambda b: b >= 0.25)):
        assert sorted(res.as_tuples()) == sorted(want_mul)


def test_edge_predicate_matches_subgraph_oracle():
    jg, tg = _graphs(40, 4.0, 77)
    mask = tcons.edge_predicate_mask(tg, lambda u, v: (u + v) % 3 != 0)
    np.testing.assert_array_equal(
        mask, jcons.edge_predicate_mask(jg, lambda u, v: (u + v) % 3 != 0))
    assert mask.dtype == bool and not mask.all()
    s, t, k = 0, tg.n - 1, 5
    want = tc.oracle.enumerate_paths(tg, s, t, k,
                                     edge_pred=lambda a, b: (a + b) % 3 != 0)
    ref = rc.PathEnum().query(jg, s, t, k, mode="dfs", edge_mask=mask).result
    for backend in BACKENDS:
        got = tc.PathEnum(backend=backend, device="cpu").query(
            tg, s, t, k, mode="dfs", edge_mask=mask).result
        assert sorted(got.as_tuples()) == sorted(want)
        assert got.as_tuples() == ref.as_tuples()
        assert got.count == ref.count


@pytest.mark.parametrize("chunk_size", [3, 16384])
def test_constraint_state_follows_chunk_splits_and_first_n(chunk_size):
    """A small ``chunk_size`` splits every hop's continuing rows; each
    piece's constraint state must go with it (``slice``), and
    ``first_n`` truncates the constrained walk like repro's."""
    rng = np.random.default_rng(12)
    jg, tg = _graphs(40, 5.0, 93)
    weights = rng.uniform(0.0, 4.0, size=tg.m)
    labels = rng.integers(0, 2, size=tg.m)
    s, t, k = 0, tg.n - 1, 5
    jidx = rc.build_index(jg, s, t, k)
    idx = tc.build_index(tg, s, t, k, device="cpu")
    makers = [
        lambda m: m.AccumulativeValue(weights=weights,
                                      accept=lambda b: b <= 8.0,
                                      monotone_upper=8.0),
        lambda m: m.ActionSequence(A=np.array([[0, 1], [-1, 1]]),
                                   labels=labels, start=0,
                                   accepting=np.array([True, True])),
    ]
    for make in makers:
        for first_n in (None, 5):
            want = rc.enumerate_paths_idx(jidx, chunk_size=chunk_size,
                                          first_n=first_n,
                                          constraint=make(jcons))
            for backend in BACKENDS:
                got = tc.enumerate_paths_idx(
                    idx, chunk_size=chunk_size, first_n=first_n,
                    constraint=make(tcons), backend=backend, device="cpu")
                _assert_result(want, got, f"{backend} n={first_n}")
            assert want.count > 0
