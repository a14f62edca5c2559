"""The port's graph container and generators against ``repro``'s.

Both packages draw from numpy's ``default_rng`` in the same order, so
one seed must give byte-equal arrays (values and dtypes) in both.
"""
import numpy as np
import pytest
import torch

import repro.core.graph as jg
import repro_torch.core.graph as tg

FIELDS = ("indptr", "indices", "rindptr", "rindices", "esrc", "edst")


def _assert_same_graph(a, b):
    assert a.n == b.n and a.m == b.m and a.version == b.version
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_suite_byte_equal(seed):
    want = jg.random_graph_suite(seed)
    got = tg.random_graph_suite(seed)
    assert want.keys() == got.keys()
    for name in want:
        _assert_same_graph(want[name], got[name])


@pytest.mark.parametrize("n,deg,seed", [(10, 1.0, 0), (200, 5.0, 3),
                                        (1000, 16.0, 9)])
def test_generators_byte_equal(n, deg, seed):
    _assert_same_graph(jg.erdos_renyi(n, deg, seed),
                       tg.erdos_renyi(n, deg, seed))
    _assert_same_graph(jg.power_law(n, deg, seed=seed),
                       tg.power_law(n, deg, seed=seed))
    _assert_same_graph(jg.power_law(n, deg, alpha=0.8, seed=seed),
                       tg.power_law(n, deg, alpha=0.8, seed=seed))


@pytest.mark.parametrize("dedup", [True, False])
def test_from_edges_csr_equal(dedup):
    rng = np.random.default_rng(5)
    edges = rng.integers(0, 30, size=(400, 2))     # dups and self-loops
    _assert_same_graph(jg.from_edges(30, edges, dedup=dedup),
                       tg.from_edges(30, edges, dedup=dedup))
    empty = np.zeros((0, 2), np.int64)
    _assert_same_graph(jg.from_edges(4, empty), tg.from_edges(4, empty))
    _assert_same_graph(jg.complete(6), tg.complete(6))


def test_from_numpy_and_device_copy():
    ref = jg.power_law(300, 4.0, seed=1)
    g = tg.Graph.from_numpy(ref.n, ref.indptr, ref.indices, ref.rindptr,
                            ref.rindices, ref.esrc, ref.edst, ref.version)
    _assert_same_graph(ref, g)
    dg = g.to("cpu")
    assert g.to("cpu") is dg                       # made once per device
    for f in FIELDS:
        t = getattr(dg, f)
        assert t.device == torch.device("cpu")
        np.testing.assert_array_equal(t.numpy(), getattr(g, f))
    assert dg.esrc.dtype == torch.int32 and dg.indptr.dtype == torch.int64
    assert dg.memory_bytes() == sum(getattr(g, f).nbytes for f in FIELDS)
