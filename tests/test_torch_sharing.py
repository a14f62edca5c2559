"""Cross-query sharing of the port (``core.sharing``) against ``repro``.

* ``build_member_indexes`` and ``MergedGroupIndex.member_view(j)`` give
  every member an index byte-equal to its solo ``build_index`` and to
  ``repro``'s, and the merged arena equals ``repro``'s.
* Shared walks (shared-s DFS groups and join groups) give results
  byte-equal to the solo host run of the same index and to ``repro``'s
  shared batch.
* A walk past ``SHARING_MAX_NODES`` falls back to the solo path
  (``SharingFallback``), and ``REPRO_SHARING=off`` turns sharing off;
  results stay byte-equal either way.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro.core import batch as jbatch
from repro.core import sharing as jsharing
from repro_torch.core import sharing as tsharing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


INDEX_FIELDS = ("dist_s", "dist_t", "fwd_dst", "fwd_eid", "fwd_begin",
                "fwd_end", "rev_src", "rev_begin", "rev_end", "level_count",
                "gamma")

SHAPES = {
    "shared_s": [(1, t, 4) for t in (2, 3, 5, 7, 9, 11)],
    "shared_t": [(s, 2, 4) for s in (1, 3, 5, 7, 9)],
    "mixed_k": [(1, 5, 3), (1, 5, 5), (1, 6, 4), (1, 7, 6), (2, 5, 4)],
}


def _graphs(seed, n=18, mean_deg=4.0):
    rng = np.random.default_rng(seed)
    edges = rng.integers(0, n, size=(max(n, int(n * mean_deg)), 2))
    return rc.from_edges(n, edges), tc.from_edges(n, edges)


def _assert_index(want, got, tag=""):
    assert (got.n, got.k, got.s, got.t) == (want.n, want.k, want.s, want.t)
    for f in INDEX_FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype, f"{tag} {f}"
        np.testing.assert_array_equal(a, b, err_msg=f"{tag} {f}")


def _assert_result(want, got, tag=""):
    assert got.count == want.count, tag
    assert got.exhausted == want.exhausted, tag
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats), \
        tag
    np.testing.assert_array_equal(got.paths, want.paths, err_msg=tag)
    np.testing.assert_array_equal(got.lengths, want.lengths, err_msg=tag)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_member_views_equal_solo_indexes(shape):
    jg, tg = _graphs(0)
    qs = SHAPES[shape]
    dists = jbatch.batched_index_distances(jg, qs)
    built = tsharing.build_member_indexes(tg, qs, dists, device="cpu")
    jbuilt = jsharing.build_member_indexes(jg, qs, dists)
    for (s, t, k), idx, jidx in zip(qs, built, jbuilt):
        solo = tc.build_index(tg, s, t, k, device="cpu")
        _assert_index(solo, idx, f"member ({s},{t},{k})")
        _assert_index(jidx, idx, f"member ({s},{t},{k}) vs repro")
        assert idx.device.type == "cpu"
    kind = shape[-1] if shape != "mixed_k" else "s"
    anchor = qs[0][1] if kind == "t" else qs[0][0]
    merged = tsharing.MergedGroupIndex.from_members(built, kind, anchor)
    jmerged = jsharing.MergedGroupIndex.from_members(jbuilt, kind, anchor)
    for f in ("a_src", "a_dst", "a_orig", "a_begin", "a_end",
              "member_mask"):
        np.testing.assert_array_equal(getattr(merged, f),
                                      getattr(jmerged, f), err_msg=f)
    for j, idx in enumerate(built):
        _assert_index(idx, merged.member_view(j), f"view {j}")


@pytest.mark.parametrize("mode", ["dfs", "join", "auto"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_shared_walk_equals_solo(shape, mode, monkeypatch):
    monkeypatch.delenv("REPRO_SHARING", raising=False)
    for seed in (0, 1):
        jg, tg = _graphs(seed)
        qs = SHAPES[shape]
        got = tc.BatchPathEnum(device="cpu", sharing="auto").run(
            tg, qs, count_only=False, mode=mode)
        want = rc.BatchPathEnum(backend="host", sharing="auto").run(
            jg, qs, count_only=False, mode=mode)
        assert (got.sharing_groups, got.shared_queries) == \
            (want.sharing_groups, want.shared_queries)
        if shape != "shared_t":
            assert got.shared_queries >= 2, (seed, mode)
        for item, jitem in zip(got.items, want.items):
            tag = f"{shape}/{mode}/{seed} ({item.s},{item.t},{item.k})"
            _assert_result(jitem.result, item.result, tag)
            idx = tc.build_index(tg, item.s, item.t, item.k, device="cpu")
            if item.plan.method == "dfs":
                solo = tc.enumerate_paths_idx(idx, backend="host",
                                              device="cpu")
            else:
                solo = tc.enumerate_paths_join(
                    idx, cut=item.plan.cut, max_partials=20_000_000)
            _assert_result(solo, item.result, f"{tag} vs solo")


@pytest.mark.parametrize("first_n", [None, 2])
def test_sharing_fallback_past_node_budget(first_n, monkeypatch):
    monkeypatch.delenv("REPRO_SHARING", raising=False)
    jg, tg = _graphs(4, mean_deg=6.0)
    qs = SHAPES["shared_s"]
    monkeypatch.setattr(tsharing, "SHARING_MAX_NODES", 2)
    got = tc.BatchPathEnum(device="cpu").run(tg, qs, count_only=False,
                                             first_n=first_n, mode="dfs")
    assert got.sharing_groups == 0 and got.shared_queries == 0
    want = rc.BatchPathEnum(backend="host", sharing="off").run(
        jg, qs, count_only=False, first_n=first_n, mode="dfs")
    for a, b in zip(want.items, got.items):
        _assert_result(a.result, b.result, f"({a.s},{a.t},{a.k})")


def test_repro_sharing_env_off(monkeypatch):
    jg, tg = _graphs(2)
    qs = SHAPES["shared_s"]
    monkeypatch.setenv("REPRO_SHARING", "off")
    assert tsharing.resolve_sharing("auto") == "off"
    got = tc.BatchPathEnum(device="cpu", sharing="auto").run(
        tg, qs, count_only=False)
    assert got.sharing_groups == 0 and got.shared_queries == 0
    monkeypatch.delenv("REPRO_SHARING")
    assert tsharing.resolve_sharing(None) == "auto"
    on = tc.BatchPathEnum(device="cpu").run(tg, qs, count_only=False)
    assert on.shared_queries >= 2
    want = rc.BatchPathEnum(backend="host").run(jg, qs, count_only=False)
    for a, b, c in zip(want.items, got.items, on.items):
        _assert_result(a.result, b.result)
        _assert_result(a.result, c.result)
    with pytest.raises(ValueError):
        tsharing.resolve_sharing("sometimes")


def test_detect_groups_equals_repro():
    keys = [("g", s, t, k, 0, 0) for s, t, k in
            SHAPES["shared_s"] + SHAPES["shared_t"] + SHAPES["mixed_k"]]
    for kinds in (("s", "t"), ("s",), ("t",)):
        for max_size in (2, 3, 32):
            a = jsharing.detect_groups(keys, kinds=kinds, max_size=max_size)
            b = tsharing.detect_groups(keys, kinds=kinds, max_size=max_size)
            assert [dataclasses.asdict(x) for x in a] == \
                [dataclasses.asdict(x) for x in b]


@pytest.mark.parametrize("order", ["hops", "weight"])
def test_ranked_batches_skip_shared_walk(order):
    """Rank-order emission is per query and a shared walk cannot
    reproduce it, so ranked batches enumerate solo (construction sharing
    only), byte-equal with sharing on or off, and equal to repro's."""
    jg, tg = _graphs(10, mean_deg=5.0)
    w = np.random.default_rng(0).integers(0, 4, size=tg.m).astype(np.float64)
    weights = w if order == "weight" else None
    qs = SHAPES["shared_s"]
    want = rc.BatchPathEnum(backend="host", sharing="auto").run(
        jg, qs, count_only=False, order=order, weights=weights)
    for backend in ("host", "device"):
        on = tc.BatchPathEnum(backend=backend, sharing="auto",
                              device="cpu").run(
            tg, qs, count_only=False, order=order, weights=weights)
        off = tc.BatchPathEnum(backend=backend, sharing="off",
                               device="cpu").run(
            tg, qs, count_only=False, order=order, weights=weights)
        assert on.shared_queries == off.shared_queries == 0
        for q, a, b, c in zip(qs, want.items, on.items, off.items):
            _assert_result(c.result, b.result, f"{backend} {order} {q}")
            assert b.result.as_tuples() == a.result.as_tuples(), q
            if backend == "host" or order == "weight":
                _assert_result(a.result, b.result, f"{order} {q} repro")
