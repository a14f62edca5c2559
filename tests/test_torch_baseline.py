"""The port's baselines against ``repro``'s: Algorithm 2's relations with
the full reducer (the Appendix-B pruning equivalence of
tests/test_index.py) and Algorithm 1's ``generic_dfs`` (the Fig.-6
comparison of tests/test_engine.py).

Each case runs both packages on the same seeded graph: relations array
for array, ``generic_dfs`` field for field (paths, count, every Fig.-6
counter, ``exhausted``), and the port's index walk against both.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import relations as jrel
from repro.core.baseline import generic_dfs as repro_generic_dfs
from repro_torch.core import relations as trel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def queries_for(g, count=3, seed=0, k_reach=None):
    """Random (s, t) pairs; with k_reach set, only pairs with distance
    ≤ 3 (the paper's query-generation rule, §7.1) so results exist."""
    rng = np.random.default_rng(seed)
    out = []
    tries = 0
    while len(out) < count and tries < 500:
        tries += 1
        s, t = rng.integers(0, g.n, size=2)
        if s == t:
            continue
        if k_reach is not None:
            d = tc.oracle.bfs_dist_np(g, int(s), 3, excluded=int(t))
            if d[int(t)] > 3:
                continue
        out.append((int(s), int(t)))
    return out


def _assert_baseline(want, got, tag=""):
    assert got.paths == want.paths, tag
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag


@pytest.mark.parametrize("seed", [0, 1])
def test_appendix_b_pruning_equivalence(seed):
    """After the full reducer, R_i(u_{i-1}:v, u_i) == I_t(v, k-i), and
    the port's relations equal repro's array for array."""
    k = 4
    jg = rc.erdos_renyi(40, 3.0, seed=seed + 7)
    tg = tc.erdos_renyi(40, 3.0, seed=seed + 7)
    s, t = 0, tg.n - 1
    idx = tc.build_index(tg, s, t, k, device="cpu")
    rels = trel.build_relations(tg, s, t, k)
    want_rels = jrel.build_relations(jg, s, t, k)
    assert trel.relation_sizes(rels) == jrel.relation_sizes(want_rels)
    for a, b in zip(rels, want_rels):
        np.testing.assert_array_equal(a, b)
    for i in range(1, k + 1):
        ri = rels[i - 1]
        for v in set(int(x) for x in ri[:, 0]):
            if v == t:
                continue
            want = trel.relation_neighbors(rels, i, v)
            want.discard(-1)
            assert want == jrel.relation_neighbors(want_rels, i, v)
            got = set(int(x) for x in idx.it(v, k - i))
            assert want == got, (i, v)


def test_baseline_agrees_and_index_saves_edge_accesses():
    jg = rc.power_law(96, 4.0, seed=2)
    tg = tc.power_law(96, 4.0, seed=2)
    checked = 0
    for backend in ("host", "device"):
        eng = tc.PathEnum(backend=backend, device="cpu")
        for (s, t) in queries_for(tg, 5, seed=2, k_reach=5):
            want = tc.oracle.enumerate_paths(tg, s, t, 5)
            base = tc.generic_dfs(tg, s, t, 5)
            _assert_baseline(repro_generic_dfs(jg, s, t, 5), base, (s, t))
            out = eng.query(tg, s, t, 5, mode="dfs")
            assert base.paths == want
            assert sorted(out.result.as_tuples()) == want
            assert base.count == out.result.count
            if len(want) > 0:
                # Fig. 6: the index accesses fewer edges than Alg. 1
                assert out.result.stats.edges_accessed <= \
                    base.stats.edges_accessed
                checked += 1
    assert checked > 0


@pytest.mark.parametrize("kw", [dict(count_only=True), dict(first_n=3),
                                dict(max_steps=40)])
def test_generic_dfs_anytime_options_equal_repro(kw):
    jg = rc.erdos_renyi(40, 6.0, seed=1)
    tg = tc.erdos_renyi(40, 6.0, seed=1)
    for (s, t) in queries_for(tg, 4, seed=3, k_reach=4):
        want = repro_generic_dfs(jg, s, t, 4, **kw)
        got = tc.generic_dfs(tg, s, t, 4, **kw)
        _assert_baseline(want, got, (s, t, kw))
        assert isinstance(got, tc.BaselineResult)
