"""Streaming graph mutation in the port against ``repro``.

Mirrors tests/test_streaming.py (DESIGN.md §12).  Two layers:
``Graph.with_edges`` must give arrays byte-equal to ``repro``'s and the
same ``version`` for every kind of mutation (add, remove, both,
re-insert, self-loop, absent removal, out-of-range endpoints), and the
copy must start without the parent's device arrays; and the serving
stack above it (cache keys, registry ``mutate`` / ``register``, both
front-ends) must never answer a post-mutation query with a pre-mutation
index.  Serving scenarios run on ``repro``'s front-ends (host backend)
and on the port's on the CPU under both port backends, held equal field
by field, times masked (tests/torch_serving_parity.py).
"""
import asyncio

import numpy as np
import pytest
import torch

from torch_serving_parity import (BACKENDS, assert_report, assert_responses,
                                  sides)

import repro.core as rc
import repro_torch.core as tc
from repro_torch.serving import (STATUS_OK, STATUS_REJECTED_TENANT_QUOTA,
                                 GraphRegistry)

ARRAYS = ("indptr", "indices", "rindptr", "rindices", "esrc", "edst")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(backend, scenario):
    want_side, got_side = sides(backend)
    return scenario(want_side), scenario(got_side)


def _edge_set(g):
    return {(int(u), int(v)) for u, v in g.edge_list()}


def _assert_same_graph(want, got, tag=""):
    assert (got.n, got.m, got.version) == (want.n, want.m, want.version), tag
    for name in ARRAYS:
        a, b = getattr(want, name), getattr(got, name)
        assert b.dtype == a.dtype, f"{tag} {name}"
        np.testing.assert_array_equal(b, a, err_msg=f"{tag} {name}")


# ---------------------------------------------------------------------------
# Graph.with_edges: byte-equal to repro's, a versioned copy
# ---------------------------------------------------------------------------

MUTATIONS = {
    "add": dict(add=[[0, 39], [39, 0], [7, 11]]),
    "remove": dict(remove="first5"),
    "both": dict(add=[[0, 39], [7, 11]], remove="first5"),
    "reinsert": dict(add="first5", remove="first5"),
    "self_loop_and_duplicate": dict(add=[[3, 3], [0, 39], [0, 39]]),
    "noop": dict(),
}


def _resolve(g, spec):
    if spec is None:
        return None
    if isinstance(spec, str):
        return g.edge_list()[:5]
    return np.asarray(spec, np.int64)


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_with_edges_byte_equal_to_repro(case):
    spec = MUTATIONS[case]
    g_r = rc.erdos_renyi(40, 3.0, seed=5)
    g_t = tc.erdos_renyi(40, 3.0, seed=5)
    _assert_same_graph(g_r, g_t, "base")
    kw = {k: _resolve(g_r, v) for k, v in spec.items()}
    want = g_r.with_edges(**kw)
    got = g_t.with_edges(**kw)
    _assert_same_graph(want, got, case)
    assert got.version == 1 and g_t.version == 0
    np.testing.assert_array_equal(got.edge_list(), want.edge_list())
    # the accessors repro's Graph has, on both versions
    for v in (0, 7, 39):
        assert got.out_degree(v) == want.out_degree(v)
        np.testing.assert_array_equal(got.in_neighbors(v),
                                      want.in_neighbors(v))
    _assert_same_graph(want.reverse(), got.reverse(), f"{case} reverse")
    np.testing.assert_array_equal(got.rindices_src(), want.rindices_src())
    np.testing.assert_array_equal(got.redst(), want.redst())


def test_with_edges_add_remove_matches_fresh_build():
    g = tc.erdos_renyi(40, 3.0, seed=5)
    rng = np.random.default_rng(1)
    drop = g.edge_list()[rng.choice(g.m, 5, replace=False)]
    new = np.array([[0, 39], [39, 0], [7, 11]])
    g2 = g.with_edges(add=new, remove=drop)
    want = _edge_set(g) - {(int(u), int(v)) for u, v in drop}
    want |= {(int(u), int(v)) for u, v in new}
    assert _edge_set(g2) == want
    fresh = tc.from_edges(g.n, np.array(sorted(want)))
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(g2, name), getattr(fresh, name))
    assert g.version == 0 and _edge_set(g) != want


def test_with_edges_version_is_monotone_per_mutation():
    edges = np.array([[0, 1], [1, 2]])
    chains = []
    for pkg in (rc, tc):
        g = pkg.from_edges(4, edges)
        g1 = g.add_edges(np.array([[2, 3]]))
        g2 = g1.remove_edges(np.array([[2, 3]]))
        g3 = g2.with_edges()
        chains.append([g, g1, g2, g3])
        assert [x.version for x in chains[-1]] == [0, 1, 2, 3]
        assert _edge_set(g2) == _edge_set(g)
    for want, got in zip(*chains):
        _assert_same_graph(want, got)


@pytest.mark.parametrize("pkg", [rc, tc], ids=["repro", "port"])
def test_with_edges_rejects_missing_removal_and_bad_endpoints(pkg):
    g = pkg.from_edges(4, np.array([[0, 1], [1, 2]]))
    with pytest.raises(ValueError, match=r"cannot remove edge \(2, 3\)"):
        g.remove_edges(np.array([[2, 3]]))
    with pytest.raises(ValueError, match=r"add edges must have endpoints "
                                         r"in \[0, 4\)"):
        g.add_edges(np.array([[0, 4]]))
    with pytest.raises(ValueError, match=r"remove edges must have "
                                         r"endpoints in \[0, 4\)"):
        g.remove_edges(np.array([[-1, 0]]))


def test_mutated_copy_starts_without_device_arrays():
    """A mutated copy is a new object: it must not inherit the parent's
    ``_device_graphs``, or it would serve the old edge set's arrays."""
    g = tc.erdos_renyi(40, 3.0, seed=5)
    dg = g.to("cpu")
    assert g.to("cpu") is dg                          # held per graph
    g2 = g.add_edges(np.array([[0, 39]]))
    assert "_device_graphs" not in g2.__dict__
    dg2 = g2.to("cpu")
    assert dg2 is not dg and int(dg2.esrc.shape[0]) == g2.m == g.m + 1
    np.testing.assert_array_equal(dg2.indices.numpy(), g2.indices)
    assert g.to("cpu") is dg                          # the parent's stays


# ---------------------------------------------------------------------------
# stale-index regression: a mutated graph never serves a pre-mutation index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_mutated_graph_never_serves_stale_index(backend):
    def run(S):
        g = S.core.erdos_renyi(60, 3.0, seed=8)
        rng = np.random.default_rng(3)
        queries = []
        while len(queries) < 8:
            s, t = map(int, rng.choice(g.n, 2, replace=False))
            queries.append((s, t, int(rng.integers(2, 6))))
        eng = S.engine()
        eng.run(g, queries)
        g2 = g.with_edges(add=np.array([[0, 1], [1, 0]]),
                          remove=g.edge_list()[:3])
        before = eng.cache.stats.snapshot()
        warm = eng.run(g2, queries, count_only=False)
        delta = eng.cache.stats.delta(before)
        cold = S.engine().run(g2, queries, count_only=False)
        before = eng.cache.stats.snapshot()
        again = eng.run(g, queries)
        return (delta, warm, cold, eng.cache.stats.delta(before).hits,
                again.counts.tolist())

    want, got = _both(backend, run)
    delta, warm, cold, hits, again = got
    assert (delta.hits, delta.misses) == (0, 8)
    assert vars(delta) == vars(want[0])
    for w, a, b in zip(want[1].items, warm.items, cold.items):
        assert a.result.count == b.result.count == w.result.count
        np.testing.assert_array_equal(a.result.paths, w.result.paths)
        np.testing.assert_array_equal(b.result.paths, w.result.paths)
    assert hits == want[3] == 8
    assert again == want[4]


@pytest.mark.parametrize("backend", BACKENDS)
def test_registry_mutate_purges_engine_entries_and_keeps_quota(backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=2)
        reg = S.serving.GraphRegistry()
        reg.register("fraud", g, cache_quota=4)
        srv = S.server(reg)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=i, s=i, t=i + 10, k=3, graph_id="fraud",
                  count_only=False) for i in range(6)]
        srv.serve(reqs)
        held = srv.engine.cache.tenant_len("fraud")
        entry = reg.mutate("fraud", add=np.array([[0, 39]]))
        after = (entry.graph.version, srv.engine.cache.tenant_len("fraud"),
                 srv.engine.cache.quota_for("fraud"),
                 sum(k[0] == "fraud" for k in srv.engine.group_cache._entries))
        resps, report = srv.serve(reqs)
        return held, after, resps, report

    (w_held, w_after, want, w_rep), (held, after, got, rep) = \
        _both(backend, run)
    assert held == w_held == 4
    assert after == w_after and after == (1, 0, 4, 0)
    assert_responses(want, got)
    assert_report(w_rep, rep)
    assert rep.cache.hits == 0 and all(r.status == STATUS_OK for r in got)


@pytest.mark.parametrize("backend", BACKENDS)
def test_register_hot_swap_is_equivalent_to_mutate(backend):
    def run(S):
        g1 = S.core.erdos_renyi(40, 3.0, seed=6)
        reg = S.serving.GraphRegistry()
        reg.register("social", g1)
        srv = S.server(reg)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=i, s=i, t=i + 5, k=3, graph_id="social")
                for i in range(5)]
        srv.serve(reqs)
        held = srv.engine.cache.tenant_len("social")
        g2 = g1.with_edges(remove=g1.edge_list()[:4])
        reg.register("social", g2)
        dropped = srv.engine.cache.tenant_len("social")
        resps, report = srv.serve(reqs)
        cold = S.engine().run(g2, [(q.s, q.t, q.k) for q in reqs])
        return held, dropped, resps, report, cold.counts.tolist()

    want, got = _both(backend, run)
    held, dropped, resps, report, cold = got
    assert held == want[0] > 0 and dropped == 0
    assert_responses(want[2], resps)
    assert_report(want[3], report)
    assert [r.count for r in resps] == cold == want[4]


def test_mutate_weighted_tenant_requires_new_weights():
    g = tc.from_edges(4, np.array([[0, 1], [1, 2], [2, 3]]))
    reg = GraphRegistry()
    reg.register("w", g, edge_weights=np.ones(g.m))
    with pytest.raises(ValueError, match="edge_weights"):
        reg.mutate("w", add=np.array([[0, 2]]))
    entry = reg.mutate("w", add=np.array([[0, 2]]),
                       edge_weights=np.full(4, 2.0))
    assert entry.graph.m == 4 and entry.edge_weights.shape == (4,)
    assert entry.edge_weights.dtype == np.float64
    with pytest.raises(ValueError, match="shape"):
        reg.mutate("w", remove=np.array([[0, 2]]),
                   edge_weights=np.ones(4))


@pytest.mark.parametrize("backend", BACKENDS)
def test_async_server_crosses_mutation_epoch(backend):
    def run(S):
        g = S.core.erdos_renyi(50, 3.0, seed=9)
        reg = S.serving.GraphRegistry()
        reg.register("live", g)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=i, s=i, t=i + 7, k=3, graph_id="live",
                  count_only=False) for i in range(6)]

        async def drive():
            async with S.async_server(reg, batch_window_ms=1.0) as srv:
                first = await srv.serve(reqs)
                entry = reg.mutate("live", add=np.array([[0, 49], [49, 0]]))
                second = await srv.serve(reqs)
                return first, second, entry.graph
        first, second, g2 = asyncio.run(drive())
        cold = S.engine().run(g2, [(q.s, q.t, q.k) for q in reqs])
        return first, second, cold.counts.tolist()

    (w_first, w_second, w_cold), (first, second, cold) = _both(backend, run)
    assert_responses(w_first, first)
    assert_responses(w_second, second)
    assert all(r.status == STATUS_OK for r in first + second)
    assert [r.count for r in second] == cold == w_cold
    assert not any(r.index_cached for r in second)


# ---------------------------------------------------------------------------
# live quota adjustment (the control plane's write path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_set_cache_quota_live_sheds_to_new_bound(backend):
    def run(S):
        g = S.core.erdos_renyi(40, 3.0, seed=4)
        reg = S.serving.GraphRegistry()
        reg.register("t", g)
        srv = S.server(reg)
        Q = S.serving.PathQueryRequest
        reqs = [Q(uid=i, s=i, t=i + 9, k=3, graph_id="t") for i in range(6)]
        srv.serve(reqs)
        lens = [srv.engine.cache.tenant_len("t")]
        entry = reg.set_cache_quota("t", 2)
        lens.append(srv.engine.cache.tenant_len("t"))
        reg.set_cache_quota("t", None)
        resps, report = srv.serve(reqs)
        lens.append(srv.engine.cache.tenant_len("t"))
        return entry.cache_quota, lens, resps, report

    want, got = _both(backend, run)
    assert got[:2] == want[:2] == (2, [6, 2, 6])
    assert_responses(want[2], got[2])
    assert_report(want[3], got[3])


@pytest.mark.parametrize("backend", BACKENDS)
def test_set_max_pending_applies_at_next_admission(backend):
    def run(S):
        g = S.core.erdos_renyi(30, 3.0, seed=7)
        reg = S.serving.GraphRegistry()
        reg.register("t", g)
        Q = S.serving.PathQueryRequest

        async def drive():
            async with S.async_server(reg, batch_window_ms=1.0) as srv:
                reg.set_max_pending("t", 0)
                r1 = await srv.submit(Q(uid=1, s=0, t=5, k=3, graph_id="t"))
                reg.set_max_pending("t", None)
                r2 = await srv.submit(Q(uid=2, s=0, t=5, k=3, graph_id="t"))
                return [r1, r2]
        return asyncio.run(drive())

    want, got = _both(backend, run)
    assert_responses(want, got)
    assert got[0].status == STATUS_REJECTED_TENANT_QUOTA
    assert got[1].status == STATUS_OK
