"""The port's index builds against ``repro``'s (mirrors tests/test_index.py).

Both port builds, the host build and the device build run on the CPU,
must equal ``repro.core.build_index`` in every field, dtype included,
for k in 2..6 over the small suite; the integer fields must also equal
``build_index_jax``.  ``gamma`` is float64 in both port builds and
bit-equal to the host build (the JAX build's gamma is float32).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as rc
import repro_torch.core as tc
from repro_torch.core.bfs import index_distances, index_distances_np

INT_FIELDS = ("dist_s", "dist_t", "fwd_dst", "fwd_eid", "fwd_begin",
              "fwd_end", "rev_src", "rev_begin", "rev_end", "level_count")
FIELDS = INT_FIELDS + ("gamma",)

QUERIES = [("er_small", 0, 63), ("er_dense", 1, 40), ("pl_hub", 5, 17),
           ("dag", 32, 33), ("grid", 0, 35)]


def _assert_fields(want, got, fields, tag):
    for f in fields:
        x, y = getattr(want, f), getattr(got, f)
        assert x.dtype == y.dtype, f"{tag}: {f} dtype"
        np.testing.assert_array_equal(x, y, err_msg=f"{tag}: {f}")


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_builds_equal_repro(k):
    jsuite = rc.graph.random_graph_suite(0)
    tsuite = tc.random_graph_suite(0)
    for name, s, t in QUERIES:
        ref = rc.build_index(jsuite[name], s, t, k)
        host = tc.build_index(tsuite[name], s, t, k, device="cpu")
        dev = tc.build_index_device(tsuite[name], s, t, k, device="cpu")
        tag = f"{name} k={k}"
        _assert_fields(ref, host, FIELDS, tag + " host")
        _assert_fields(ref, dev, FIELDS, tag + " device")
        assert (host.n, host.k, host.s, host.t) == (ref.n, k, s, t)


@pytest.mark.parametrize("seed", range(4))
def test_device_build_equals_jax_build(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(10, 80))
    k = int(rng.integers(2, 7))
    jg = rc.erdos_renyi(n, 3.5, seed=seed + 40)
    tg = tc.erdos_renyi(n, 3.5, seed=seed + 40)
    jax_idx = rc.build_index_jax(jg, 0, n - 1, k)
    dev = tc.build_index_device(tg, 0, n - 1, k, device="cpu")
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(jax_idx, f), getattr(dev, f),
                                      err_msg=f)
    host = tc.build_index(tg, 0, n - 1, k, device="cpu")
    assert dev.gamma.dtype == np.float64
    np.testing.assert_array_equal(dev.gamma, host.gamma)


def test_relaxation_equals_queue_bfs_and_edge_mask():
    g = tc.power_law(120, 4.0, seed=3)
    for s, t, k in ((1, 2, 5), (7, 30, 3)):
        a = index_distances(g, s, t, k, device="cpu")
        b = index_distances_np(g, s, t, k)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    mask = np.random.default_rng(0).random(g.m) < 0.7
    ref = rc.build_index(rc.power_law(120, 4.0, seed=3), 1, 2, 5,
                         edge_mask=mask)
    got = tc.build_index(g, 1, 2, 5, edge_mask=mask, device="cpu")
    _assert_fields(ref, got, FIELDS, "edge_mask")


def test_from_numpy_and_device_arrays():
    ref = rc.build_index(rc.erdos_renyi(50, 4.0, seed=1), 0, 49, 4)
    idx = tc.LightweightIndex.from_numpy(dataclasses.asdict(ref),
                                         device="cpu")
    _assert_fields(ref, idx, FIELDS, "from_numpy")
    dev = idx.device_arrays()
    want = ref.device_arrays()
    for f in ("begin", "end", "dst"):
        x = getattr(dev, f)
        assert x.dtype == torch.int32 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(want, f)))
    built = tc.build_index_device(tc.erdos_renyi(50, 4.0, seed=1), 0, 49, 4,
                                  device="cpu").device_arrays()
    for f in ("begin", "end", "dst"):
        assert torch.equal(getattr(built, f), getattr(dev, f))
    for v in range(ref.n):
        for b in range(ref.k + 1):
            np.testing.assert_array_equal(idx.it(v, b), ref.it(v, b))
            np.testing.assert_array_equal(idx.is_(v, b), ref.is_(v, b))
