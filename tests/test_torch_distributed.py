"""The port's mesh engine against ``repro``'s, on the CPU over gloo.

One module-wide run starts, all at once: ``repro``'s scenarios on a
2 x 2 host mesh (a subprocess with four forced XLA CPU devices), the
port's on a 2 x 2 gloo mesh (four ranks), on a 1 x 1 gloo mesh (one
rank, the shape of the card's main leg) and on a 3 x 1 gloo mesh (three
data rows: ``enumerate_batch`` gives query (s, t) to row s mod 3, so
some calls leave a row with no query); tests/torch_mesh_parity.py holds
the scenarios.  Each port rank runs one torch thread.  Every port mesh
is held to ``repro``'s one 2 x 2 run.

Tolerances: distances are integers and must be equal; the walk-count
tables are float32 integers below 2^24, so every sum is exact in any
order and they must be equal too; enumeration items (counts, paths in
order, lengths, ``EnumStats``, plans, cache/dedup/shared/fused flags)
and every ``BatchOutput`` counter must be equal; the compressed sums
are integers times a shared scale and must be bit-identical, and the
16-bit lanes must decode to the int64 sums exactly.  The
compressed gradient is held to the exact one within ``repro``'s own
bounds (tests/test_distributed.py): loss within 1e-4, every gradient
within 5% of its largest entry (the int8 grid's step is 1/127 of it),
for a two-layer MLP and for ``repro``'s own case, the LM loss of
``training.step.make_loss_fn`` on a one-layer dense config.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.distributed import compression as jcomp
from repro.distributed import engine as jengine
import repro_torch.core as tc
from repro_torch.compat import free_port
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import engine as tengine

import torch_mesh_parity as mp

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESHES = {"2x2": (2, 2), "1x1": (1, 1), "3x1": (3, 1)}
TIMEOUT = 240


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every side's pickled results: ``repro``, and per port mesh the
    list of its ranks' results (rank order)."""
    tmp = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(HERE)]),
               OMP_NUM_THREADS="1")
    script = str(HERE / "torch_mesh_parity.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "repro", str(tmp / "repro.pkl")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    outs = {}
    for name, (rows, cols) in MESHES.items():
        init = f"tcp://127.0.0.1:{free_port()}"
        outs[name] = str(tmp / f"{name}_%d.pkl")
        procs += [subprocess.Popen(
            [sys.executable, script, "port", str(rows), str(cols), str(r),
             init, outs[name]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
            for r in range(rows * cols)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]

    def load(path):
        with open(path, "rb") as fh:
            return pickle.load(fh)
    return {"repro": load(tmp / "repro.pkl"),
            **{name: [load(outs[name] % r) for r in range(rows * cols)]
               for name, (rows, cols) in MESHES.items()}}


@pytest.fixture(params=list(MESHES))
def mesh(request):
    return request.param


def test_stats_equal_repro(runs, mesh):
    want = runs["repro"]["stats"]
    for got in runs[mesh]:
        for key in ("ds", "dt", "qp", "qs", "tot"):
            assert got["stats"][key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got["stats"][key], want[key],
                                          err_msg=key)


def test_stats_equal_plain_recurrence(runs, mesh):
    """The mesh's tables against the recurrence written out in float64
    numpy over every edge (``mp.plain_mesh_dp``)."""
    got = runs[mesh][0]["stats"]
    g = tc.erdos_renyi(60, 4.0, seed=5)
    qp, qs, tot = mp.plain_mesh_dp(g, mp.K, got["ds"], got["dt"])
    np.testing.assert_array_equal(got["qp"], qp)
    np.testing.assert_array_equal(got["qs"], qs)
    np.testing.assert_array_equal(got["tot"], tot)


def test_mesh_dp_counts_more_walks_than_the_index_dp():
    """``repro``'s mesh DP relaxes every edge; Alg. 5 on the index drops
    the edges into s and out of t (``core/index.py``), so the mesh counts
    the walks that revisit s or pass through t as well.  On
    ``erdos_renyi(400, 6.0, seed=11)`` at k = 5 the two differ (query
    (340, 254): q_prefix[3] 80 against 78, totals 83 against 81); the
    port keeps ``repro``'s recurrence, and every entry stays at or above
    the index DP's."""
    g = tc.erdos_renyi(400, 6.0, seed=11)
    qs = mp.stats_queries(g.n)
    idxs = [tc.build_index(g, s, t, 5, device="cpu") for s, t in qs]
    qp, qsx, tot = mp.plain_mesh_dp(g, 5, np.stack([x.dist_s for x in idxs]),
                                    np.stack([x.dist_t for x in idxs]))
    differ = 0
    for i, idx in enumerate(idxs):
        dp = tc.walk_count_dp(idx, device="cpu")
        assert (qp[i] >= dp.q_prefix).all() and (qsx[i] >= dp.q_suffix).all()
        assert tot[i] >= dp.q_total
        differ += tot[i] != dp.q_total
    i = qs.index((340, 254))
    assert list(qp[i]) == [1, 10, 48, 80, 83, 83] and tot[i] == 83
    assert differ == 2


def test_stats_equal_port_host_dp(runs, mesh):
    """The mesh's tables against the port's own host walk-count DP and
    bounded BFS on each query's index, as ``repro`` tests its own (the
    two agree on this graph)."""
    got = runs[mesh][0]["stats"]
    g = tc.erdos_renyi(60, 4.0, seed=5)
    for i, (s, t) in enumerate(mp.stats_queries(g.n)):
        idx = tc.build_index(g, s, t, mp.K, device="cpu")
        dp = tc.walk_count_dp(idx, device="cpu")
        np.testing.assert_array_equal(got["qp"][i], dp.q_prefix)
        np.testing.assert_array_equal(got["qs"][i], dp.q_suffix)
        assert got["tot"][i] == dp.q_total
        np.testing.assert_array_equal(got["ds"][i], idx.dist_s)
        np.testing.assert_array_equal(got["dt"][i], idx.dist_t)


def test_enumerate_batch_equals_repro(runs, mesh):
    want = runs["repro"]["enum"]
    for got in runs[mesh]:
        assert len(got["enum"]) == len(want) == len(mp.enum_calls(
            mp.stats_queries(60)))
        for call, (a, b) in enumerate(zip(want, got["enum"])):
            assert b == a, call
    first = runs["repro"]["enum"]
    assert first[1]["cache_stats"]["hits"] == 7        # the cache served
    assert first[3]["counters"]["distinct_queries"] == 4


def test_default_engine_items_equal_repro(runs, mesh):
    """The port's default engine (``backend="device"``: K5's plain version
    on the CPU) against ``repro``'s host engine: the same items, flags
    and counters apart from the fused ones, which only a device backend
    makes."""
    want = runs["repro"]["enum_default"]
    for got in runs[mesh]:
        b = got["enum_default"]
        assert [{**i, "flags": i["flags"][:3]} for i in b["items"]] == \
            [{**i, "flags": i["flags"][:3]} for i in want["items"]]
        assert b["cache_stats"] == want["cache_stats"]
        drop = ("fused_queries", "fused_dispatches")
        assert {k: v for k, v in b["counters"].items() if k not in drop} == \
            {k: v for k, v in want["counters"].items() if k not in drop}
        assert b["counters"]["fused_queries"] > 0


def test_router_equals_repro(runs, mesh):
    want = runs["repro"]["router"]
    for got in runs[mesh]:
        assert got["router"]["runs"] == want["runs"]
        assert got["router"]["entries"] == want["entries"]
        assert got["router"]["unknown"] == want["unknown"] is not None
    assert want["runs"][0]["tenants"] == ["a", "b"]
    assert all(n > 0 for n in want["entries"])


def test_compressed_all_reduce_equals_repro(runs, mesh):
    want = runs["repro"]["compressed"][mesh]
    for got in runs[mesh]:
        d, c = got["coords"]
        for name in ("data", "world"):
            a, b = want[name][(d, c)], got["compressed"][name]
            assert b["w"].tobytes() == a["w"].tobytes(), name
            assert b["b"][0].tobytes() == a["b"][0].tobytes(), name


def test_compressed_grad_fn_within_repro_bound(runs, mesh):
    for got in runs[mesh]:
        assert got["grad"]["loss_diff"] < 1e-4
        assert got["grad"]["max_rel"] < 0.05


def test_compressed_lm_grad_fn_within_repro_bound(runs, mesh):
    """``make_compressed_grad_fn`` over the port's ``make_loss_fn`` on
    ``repro``'s own test config (tests/test_distributed.py: dense, one
    layer, d 32, vocab 64), each rank holding its share of 8 sequences:
    loss within 1e-4 of the whole batch's, every gradient within 5% of
    its largest entry."""
    for got in runs[mesh]:
        assert got["lm_grad"]["leaves"] == 11
        assert got["lm_grad"]["loss_diff"] < 1e-4
        assert got["lm_grad"]["max_rel"] < 0.05


def test_collectives_once_per_level(runs, mesh):
    """One MIN all-reduce per BFS level (two BFS), one SUM per DP level
    (both directions), each over the rank's (Q_local, n) rows; five
    all-gathers over ``data``; each rank holds its share of the padded
    edge list."""
    rows, cols = MESHES[mesh]
    n, q_local = 60, -(-8 // rows)      # the batch padded to the rows
    g = tc.erdos_renyi(60, 4.0, seed=5)
    for got in runs[mesh]:
        comm = got["comm"]
        assert comm["all_reduce_calls"] == 4 * mp.K
        assert comm["all_reduce_bytes"] == 4 * mp.K * q_local * n * 4
        assert comm["all_gather_calls"] == 5
        assert got["edge_rows"] == -(-g.m // cols)
        assert got["indivisible_raises"] in ((None,) if rows == 1
                                             else (True,))


def test_ranks_return_the_same_output(runs):
    for name, (rows, cols) in MESHES.items():
        first = runs[name][0]
        assert len(runs[name]) == rows * cols
        for other in runs[name][1:]:
            for key in ("enum", "enum_default", "router"):
                assert other[key] == first[key], (name, key)


def test_each_row_runs_only_its_own_queries(runs, mesh):
    """Every ``engine.run`` call of a rank gets the queries of the batch
    whose source its data row owns (s mod rows), in input order with
    duplicates, and distances for exactly their distinct pairs; the 1 x
    1 mesh's calls are the whole batches.  On 3 x 1 some non-empty call
    leaves a row with nothing."""
    rows, _cols = MESHES[mesh]
    whole = runs["1x1"][0]["engine_runs"]
    assert len(whole) == len(mp.enum_calls(mp.stats_queries(60))) + 4
    idle = 0
    for got in runs[mesh]:
        d, _c = got["coords"]
        assert len(got["engine_runs"]) == len(whole)
        for mine, full in zip(got["engine_runs"], whole):
            want = [q for q in full["queries"] if q[0] % rows == d]
            assert mine["queries"] == want
            assert mine["distance_pairs"] == sorted({(s, t)
                                                     for s, t, _k in want})
            idle += bool(full["queries"]) and not want
    assert (idle > 0) == (mesh == "3x1")


def test_enumerate_batch_gathers_no_distances(runs, mesh):
    """A counting ``enumerate_batch`` of the same 8 queries on graphs of
    60 and 6000 vertices: two all-gathers (the rows' payload lengths,
    then their bytes), of the same size on both graphs within a few
    pickled digits, far below one (n,) int32 row; all-reduces only for
    the row's own keys' BFS, one MIN a level each way over (keys, n)
    int32, and none for a walk-count DP."""
    small_n, large_n = mp.ENUM_COMM_SIZES
    for got in runs[mesh]:
        small, large = (got["enum_comm"][n] for n in mp.ENUM_COMM_SIZES)
        for n, c in ((small_n, small), (large_n, large)):
            assert c["all_gather_calls"] == 2
            levels = 2 * mp.K if c["owned_keys"] else 0
            assert c["all_reduce_calls"] == levels
            assert c["all_reduce_bytes"] == levels * c["owned_keys"] * n * 4
        assert large["all_gather_bytes"] < 4 * large_n
        assert abs(large["all_gather_bytes"] - small["all_gather_bytes"]) \
            <= 64


@pytest.mark.parametrize("shards", [1, 2, 3, 4, 7])
def test_pad_edges_equals_repro(shards):
    g = tc.erdos_renyi(30, 3.0, seed=2)
    for a, b in zip(tengine._pad_edges(g.esrc, g.edst, shards),
                    jengine._pad_edges(g.esrc, g.edst, shards)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_quantize_bit_identical(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(257 + 100 * seed)
         * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
    r = (rng.standard_normal(x.shape) * 0.01).astype(np.float32)
    jq, js = jcomp.quantize(jnp.asarray(x))
    tq, ts = tcomp.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    assert tcomp.dequantize(tq, ts).numpy().tobytes() == \
        np.asarray(jcomp.dequantize(jq, js)).tobytes()
    want = jcomp.quantize_with_feedback(jnp.asarray(x), jnp.asarray(r))
    got = tcomp.quantize_with_feedback(torch.from_numpy(x),
                                       torch.from_numpy(r))
    for a, b in zip(want, got):
        assert b.numpy().tobytes() == np.asarray(a).tobytes()


def test_compressed_wire_bytes(runs, mesh):
    """One ``compressed_all_reduce`` of ``mp.rank_tree`` (leaves of 35 and
    3 elements): per leaf a 4-byte MAX for the scale and 4 ceil(numel /
    2) bytes of 16-bit lanes, nothing gathered."""
    numels = (35, 3)
    for got in runs[mesh]:
        for name in ("data", "world"):
            c = got["wire_counts"][name]
            assert c["all_reduce_calls"] == 2 * len(numels)
            assert c["all_reduce_bytes"] == sum(4 * -(-n // 2) + 4
                                                for n in numels) == 88
            assert c["all_gather_calls"] == c["all_gather_bytes"] == 0


def _lane_rows(case):
    """``(R, q)``: R ranks' int values in [-127, 127] for one leaf."""
    rng = np.random.default_rng(3)
    if case.startswith("corner"):
        lo, hi = ((-127, -127), (-127, 127), (127, -127),
                  (127, 127))[int(case[-1])]
        return 257, np.tile(np.array([lo, hi, lo], np.int64), (257, 1))
    if case == "random_odd":
        return 257, rng.integers(-127, 128, (257, 1001))
    if case == "one_element":
        return 257, rng.choice([-127, 127], (257, 1))
    return 3, rng.integers(-127, 128, (3, 20))


@pytest.mark.parametrize("case", ["corner0", "corner1", "corner2", "corner3",
                                  "random_odd", "one_element", "three_ranks"])
def test_lanes_decode_to_int64_sums(case):
    """``pack_lanes`` on each rank, the words summed in an order that
    keeps every partial sum inside int32 (checked in int64, forwards and
    backwards), ``unpack_lanes`` equal to the int64 sums of the values;
    at R = 257 the corners are the extremes of both lanes."""
    R, q = _lane_rows(case)
    words = np.stack([tcomp.pack_lanes(torch.from_numpy(row)).numpy()
                      for row in q]).astype(np.int64)
    assert words.shape == (R, -(-q.shape[1] // 2))
    assert words.min() >= -8_323_072 and words.max() <= 8_323_326
    for order in (words, words[::-1]):
        partial = np.cumsum(order, axis=0)
        assert np.abs(partial).max() < 2 ** 31
    total = torch.from_numpy(words.sum(0).astype(np.int32))
    got = tcomp.unpack_lanes(total, q.shape[1], R)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), q.sum(0))


class _SameTreeOnEveryRank:
    """A ``Wire`` stand-in for ``size`` ranks that hold the same tree:
    MAX returns the value, SUM multiplies it by the ranks in int64 and
    checks that the sum fits int32 before handing it back as int32."""

    def __init__(self, size):
        self.size = size

    def all_reduce(self, x, op):
        if op == tengine.ReduceOp.MAX:
            return x.clone()
        total = x.to(torch.int64) * self.size
        assert int(total.abs().max()) < 2 ** 31
        return total.to(x.dtype)


def test_compressed_all_reduce_at_257_ranks_and_not_258():
    """257 ranks of one tree whose values reach both ends of the grid (an
    odd leaf and a one-element leaf) sum to the definition's result bit
    for bit; 258 ranks raise before any collective."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal(11).astype(np.float32)
    w[:4] = [3.0, -3.0, 3.0, -3.0]
    tree = {"w": w, "b": [np.array([-2.5], np.float32)]}
    got = tcomp.compressed_all_reduce(
        {"w": torch.from_numpy(w), "b": [torch.from_numpy(tree["b"][0])]},
        None, wire=_SameTreeOnEveryRank(257))
    want = mp.exact_compressed_sum(torch, [tree] * 257)
    assert got["w"].numpy().tobytes() == want["w"].tobytes()
    assert got["b"][0].numpy().tobytes() == want["b"][0].tobytes()
    with pytest.raises(ValueError, match="257"):
        tcomp.compressed_all_reduce({"w": torch.ones(3)}, None,
                                    wire=_SameTreeOnEveryRank(258))
