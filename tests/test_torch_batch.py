"""``BatchPathEnum`` of the port against ``repro``'s, item by item.

The port runs on the CPU (``device="cpu"``, its default
``backend="device"``, so the fused leg runs K5's plain version);
``repro``'s engine runs on its host backend, which ``repro`` pins
byte-identical to its device backend.  Every item must agree: count,
paths and order, lengths, every stats field (``chunks`` included),
``exhausted``, the plan, the cache/dedup/shared flags, and each batch's
cache-stats delta.  Legs: the ``sharing × fused`` matrix under every
mode, duplicates and repeated batches (dedup, cache hits), two tenants
with quotas, an ``edge_mask`` batch, ``first_n``, an expired deadline,
injected distances, and the stacked BFS against ``repro``'s numpy one.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import batch as jbatch
from repro_torch.core import batch as tbatch
from repro_torch.core import clock as tclock


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CHUNK = 7
QUERIES = [(0, 39, 4), (1, 38, 4), (2, 37, 3), (3, 36, 4), (0, 38, 4),
           (0, 37, 3), (0, 39, 4), (5, 39, 5), (1, 38, 4)]


def _graphs(seed=17, n=40, deg=5.0):
    return (rc.erdos_renyi(n, deg, seed=seed),
            tc.erdos_renyi(n, deg, seed=seed))


def _engines(**kw):
    return (rc.BatchPathEnum(backend="host", chunk_size=CHUNK, **kw),
            tc.BatchPathEnum(device="cpu", chunk_size=CHUNK, **kw))


def _assert_result(want, got, tag=""):
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag
    assert got.as_tuples() == want.as_tuples(), tag
    np.testing.assert_array_equal(got.paths, want.paths, err_msg=tag)
    np.testing.assert_array_equal(got.lengths, want.lengths, err_msg=tag)


def _assert_batch(want, got, tag=""):
    assert len(got.items) == len(want.items)
    for a, b in zip(want.items, got.items):
        label = f"{tag} ({a.s},{a.t},{a.k})"
        assert (b.s, b.t, b.k) == (a.s, a.t, a.k)
        _assert_result(a.result, b.result, label)
        for f in ("method", "cut", "preliminary", "used_full_estimator",
                  "t_dfs", "t_join", "est_results"):
            assert getattr(b.plan, f) == getattr(a.plan, f), f"{label} {f}"
        assert (b.index_cached, b.deduplicated, b.shared) == \
            (a.index_cached, a.deduplicated, a.shared), label
    assert dataclasses.asdict(got.cache_stats) == \
        dataclasses.asdict(want.cache_stats), tag
    assert (got.distinct_queries, got.graph_id, got.sharing_groups,
            got.shared_queries) == (want.distinct_queries, want.graph_id,
                                    want.sharing_groups, want.shared_queries)


@pytest.mark.parametrize("mode", ["auto", "dfs", "join"])
@pytest.mark.parametrize("fused", ["auto", "off"])
@pytest.mark.parametrize("sharing", ["auto", "off"])
def test_batch_equals_repro(sharing, fused, mode, monkeypatch):
    monkeypatch.delenv("REPRO_SHARING", raising=False)
    jg, tg = _graphs()
    jb, tb = _engines(sharing=sharing, fused=fused, tau=1e5)
    for kw in ({"count_only": False}, {"count_only": False, "first_n": 3},
               {"count_only": True}):
        for rep in range(2):                 # the repeat hits the cache
            want = jb.run(jg, QUERIES, mode=mode, **kw)
            got = tb.run(tg, QUERIES, mode=mode, **kw)
            _assert_batch(want, got, f"{sharing}/{fused}/{mode}/{kw}/{rep}")
            if rep:
                assert got.cache_stats.misses == 0
    fused_items = [i for i in got.items if i.fused]
    if fused == "off" or mode == "join":
        assert got.fused_queries == 0 and not fused_items
    else:
        assert got.fused_queries >= 2 and got.fused_dispatches >= 1
        # one dispatch a round serves every member
        assert got.fused_dispatches < sum(i.result.stats.chunks
                                          for i in fused_items)
    if sharing == "auto" and mode != "join":
        assert got.sharing_groups >= 1


def test_dedup_and_cache_hits():
    jg, tg = _graphs()
    jb, tb = _engines()
    qs = [(0, 39, 4)] * 3 + [(1, 38, 4)]
    a1, b1 = jb.run(jg, qs), tb.run(tg, qs)
    _assert_batch(a1, b1, "first")
    assert b1.items[1].deduplicated and b1.items[1].result is \
        b1.items[0].result
    assert (b1.cache_stats.hits, b1.cache_stats.misses) == (2, 2)
    a2, b2 = jb.run(jg, qs), tb.run(tg, qs)
    _assert_batch(a2, b2, "second")
    assert (b2.cache_stats.hits, b2.cache_stats.misses) == (4, 0)
    assert all(i.index_cached for i in b2.items)
    assert b2.enum_stats == tc.EnumStats(**dataclasses.asdict(
        a2.enum_stats))
    assert b2.total_results == a2.total_results


def test_cache_peek_leaves_lru_and_stats():
    """``IndexCache.peek`` returns the engine's own index and changes
    neither the counters nor which entry is evicted next."""
    _, tg = _graphs()
    tb = tc.BatchPathEnum(device="cpu", chunk_size=CHUNK, cache_capacity=2)
    qs = [(0, 39, 4), (1, 38, 4)]
    tb.run(tg, qs)
    keys = [(tc.DEFAULT_GRAPH_ID, s, t, k, tbatch.edge_mask_hash(None),
             int(tg.version)) for s, t, k in qs]
    before = dataclasses.asdict(tb.cache.stats)
    idx = tb.cache.peek(keys[0])
    assert (idx.s, idx.t, idx.k) == qs[0]
    assert tb.cache.peek((tc.DEFAULT_GRAPH_ID, 2, 37, 3, 0, 0)) is None
    assert dataclasses.asdict(tb.cache.stats) == before
    tb.run(tg, [(2, 37, 3)])            # evicts the LRU entry: keys[0]
    assert tb.cache.peek(keys[0]) is None
    assert tb.cache.peek(keys[1]) is not None


def test_tenants_with_quotas():
    jg1, tg1 = _graphs(17)
    jg2, tg2 = _graphs(18)
    quotas = {"a": 2, "b": 8}
    jb, tb = _engines(tenant_quotas=quotas, cache_capacity=16)
    qs = [(0, 39, 4), (1, 38, 4), (2, 37, 3)]
    for gid, jg, tg in (("a", jg1, tg1), ("b", jg2, tg2), ("a", jg1, tg1)):
        want = jb.run(jg, qs, graph_id=gid, count_only=False)
        got = tb.run(tg, qs, graph_id=gid, count_only=False)
        _assert_batch(want, got, gid)
    assert (tb.cache.tenant_len("a"), tb.cache.tenant_len("b")) == \
        (jb.cache.tenant_len("a"), jb.cache.tenant_len("b")) == (2, 3)
    for gid in ("a", "b"):
        assert dataclasses.asdict(tb.cache.stats_for(gid)) == \
            dataclasses.asdict(jb.cache.stats_for(gid))
    assert tb.cache.tenant_ids() == jb.cache.tenant_ids()
    assert tb.cache.drop_tenant("a") == jb.cache.drop_tenant("a") == 2


@pytest.mark.parametrize("sharing", ["auto", "off"])
def test_edge_mask_batch(sharing):
    jg, tg = _graphs()
    mask = np.random.default_rng(4).random(jg.m) < 0.8
    jb, tb = _engines(sharing=sharing)
    for _ in range(2):
        want = jb.run(jg, QUERIES, edge_mask=mask, count_only=False)
        got = tb.run(tg, QUERIES, edge_mask=mask, count_only=False)
        _assert_batch(want, got, f"mask/{sharing}")
    # the masked entries never serve the unmasked graph
    unmasked = tb.run(tg, QUERIES[:2], count_only=True)
    assert unmasked.cache_stats.hits == 0


def test_expired_deadline():
    jg, tg = _graphs()
    jb, tb = _engines()
    want = jb.run(jg, QUERIES, count_only=False, deadline=-1.0)
    got = tb.run(tg, QUERIES, count_only=False,
                 deadline=tclock.now() - 1.0)
    _assert_batch(want, got, "deadline")
    assert not any(i.result.exhausted for i in got.items)


def test_precomputed_distances():
    jg, tg = _graphs()
    jb, tb = _engines()
    qs = [(0, 39, 4), (1, 38, 4)]
    keys = [("default", s, t, k, 0, 0) for s, t, k in qs]
    dists = dict(zip(keys, jbatch.batched_index_distances(jg, qs)))
    want = jb.run(jg, qs, count_only=False, _precomputed_distances=dists)
    got = tb.run(tg, qs, count_only=False, _precomputed_distances=dists)
    _assert_batch(want, got, "precomputed")
    assert got.timing.distance_seconds == 0.0


@pytest.mark.parametrize("name,block", [("er_small", 128), ("pl_hub", 3),
                                        ("dag", 128), ("grid", 2)])
def test_batched_index_distances_equal_repro(name, block):
    jg = rc.graph.random_graph_suite(0)[name]
    tg = tc.random_graph_suite(0)[name]
    rng = np.random.default_rng(len(name))
    qs = []
    while len(qs) < 7:
        s, t = (int(x) for x in rng.choice(jg.n, 2, replace=False))
        qs.append((s, t, int(rng.integers(2, 7))))
    want = jbatch.batched_index_distances(jg, qs, block=block)
    got = tbatch.batched_index_distances(tg, qs, block=block, device="cpu")
    for (ws, wt), (gs, gt) in zip(want, got):
        assert gs.dtype == gt.dtype == np.int32
        np.testing.assert_array_equal(ws, gs)
        np.testing.assert_array_equal(wt, gt)


@pytest.mark.parametrize("order", ["hops", "weight"])
def test_ranked_batches_are_a_later_slice(order):
    """Ranked batches equal repro's item by item (the slice that ports
    them has landed) and keep construction sharing only: no shared walk,
    no fused launch, whatever the knobs say.  A bad ``order`` or
    ``fused`` still raises."""
    jg, tg = _graphs()
    w = np.random.default_rng(0).integers(0, 4, size=tg.m).astype(float)
    weights = w if order == "weight" else None
    for first_n in (None, 3):
        want = rc.BatchPathEnum(backend="host", chunk_size=CHUNK).run(
            jg, QUERIES, count_only=False, first_n=first_n, order=order,
            weights=weights)
        host = tc.BatchPathEnum(device="cpu", backend="host",
                                chunk_size=CHUNK).run(
            tg, QUERIES, count_only=False, first_n=first_n, order=order,
            weights=weights)
        dev = tc.BatchPathEnum(device="cpu", chunk_size=CHUNK,
                               sharing="auto", fused="auto").run(
            tg, QUERIES, count_only=False, first_n=first_n, order=order,
            weights=weights)
        for out in (host, dev):
            assert (out.shared_queries, out.sharing_groups,
                    out.fused_queries, out.fused_dispatches) == (0, 0, 0, 0)
            assert out.distinct_queries == want.distinct_queries
            assert dataclasses.asdict(out.cache_stats) == \
                dataclasses.asdict(want.cache_stats)
        for a, b, q in zip(want.items, host.items, QUERIES):
            _assert_result(a.result, b.result, f"host {q} n={first_n}")
        solo = tc.PathEnum(device="cpu", chunk_size=CHUNK)
        for a, b, (s, t, k) in zip(want.items, dev.items, QUERIES):
            # the device leg equals a solo device query (whose hop
            # buckets test_torch_ranked.py holds against repro's)
            _assert_result(solo.query(tg, s, t, k, first_n=first_n,
                                      order=order,
                                      weights=weights).result, b.result,
                           f"device {(s, t, k)} n={first_n}")
            assert b.result.as_tuples() == a.result.as_tuples()
            assert b.deduplicated == a.deduplicated
    tb = tc.BatchPathEnum(device="cpu")
    with pytest.raises(ValueError):
        tb.run(tg, QUERIES[:2], order="cost")
    with pytest.raises(ValueError):
        tc.BatchPathEnum(device="cpu", fused="sometimes")
