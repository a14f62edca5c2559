"""Seeded fuzz of the port against ``repro`` and the oracle.

Over the generator suite and random digraphs (sparse to dense, n from 4
to 26), each case's query runs through the port's solo ``PathEnum``
(host and device backends, every mode, on the CPU) and its
``BatchPathEnum`` (sharing and fused on and off, in a batch with
neighbouring queries), and must agree with ``repro``'s host
``PathEnum`` (paths and order, count, stats, ``exhausted``) and with the
port's recursive oracle ``core.oracle.enumerate_paths`` (the path set).
Inputs come from numpy seeds, so both packages see byte-equal graphs.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SEEDS = range(12)


def _case(seed):
    """(repro graph, port graph, queries) for one seed; the first query
    is the one checked solo, the rest keep it company in the batch."""
    rng = np.random.default_rng(1000 + seed)
    if seed < 5:
        name = sorted(tc.random_graph_suite(0))[seed]
        jg = rc.graph.random_graph_suite(seed)[name]
        tg = tc.random_graph_suite(seed)[name]
    else:
        n = int(rng.integers(4, 27))
        density = float(rng.choice([0.5, 1.0, 2.0, 3.5]))
        edges = rng.integers(0, n, size=(max(1, int(n * density)), 2))
        jg, tg = rc.from_edges(n, edges), tc.from_edges(n, edges)
    queries = []
    for j in range(4):
        s, t = (int(x) for x in rng.choice(jg.n, 2, replace=False))
        if j == 2:
            s = queries[0][0]            # a shared source for sharing
        if s == t:
            continue
        queries.append((s, t, int(rng.integers(2, 6))))
    return jg, tg, queries


def _assert_result(want, got, tag=""):
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag
    assert got.as_tuples() == want.as_tuples(), tag


@pytest.mark.parametrize("seed", SEEDS)
def test_port_engines_agree_with_repro_and_oracle(seed, monkeypatch):
    for var in ("REPRO_SHARING", "REPRO_DEVICE_ENUM", "REPRO_DEVICE_DEQUE"):
        monkeypatch.delenv(var, raising=False)
    jg, tg, queries = _case(seed)
    s, t, k = queries[0]
    want_set = tc.oracle.enumerate_paths(tg, s, t, k)
    for mode in ("auto", "dfs", "join"):
        want = rc.PathEnum(backend="host").query(jg, s, t, k, mode=mode)
        for backend in ("host", "device"):
            got = tc.PathEnum(backend=backend, device="cpu").query(
                tg, s, t, k, mode=mode)
            tag = f"seed={seed} q={queries[0]} {mode}/{backend}"
            _assert_result(want.result, got.result, tag)
            assert sorted(got.result.as_tuples()) == want_set, tag
    for sharing in ("auto", "off"):
        for fused in ("auto", "off"):
            want = rc.BatchPathEnum(backend="host", sharing=sharing).run(
                jg, queries, count_only=False)
            got = tc.BatchPathEnum(device="cpu", sharing=sharing,
                                   fused=fused).run(tg, queries,
                                                    count_only=False)
            for a, b in zip(want.items, got.items):
                tag = f"seed={seed} ({a.s},{a.t},{a.k}) {sharing}/{fused}"
                _assert_result(a.result, b.result, tag)
            assert sorted(got.items[0].result.as_tuples()) == want_set
