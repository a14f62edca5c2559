"""The plain reference agrees with the port (``repro_torch`` on the
CPU) on small graphs, finds bad rows, and the graph generator is a
function of its seeds."""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from hcpe_bench import graphgen
from hcpe_bench.reference import paths as ref
from repro_torch.core import batch as port_batch
from repro_torch.core import graph as port_graph

HERE = Path(__file__).resolve().parent
CPU = torch.device("cpu")


def small_graph(scale, seed, undirected, edgefactor=2):
    return graphgen.base_graph({"SCALE": scale, "edgefactor": edgefactor,
                                "A": 0.57, "B": 0.19, "C": 0.19,
                                "undirected": undirected,
                                "graph_seed": seed}, CPU)


def port_items(n, src, dst, queries):
    g = port_graph.from_edges(n, torch.stack([src, dst], 1).numpy())
    eng = port_batch.BatchPathEnum(device="cpu", backend="host")
    return eng.run(g, queries, count_only=False).items, eng


@pytest.mark.parametrize("seed,undirected,k", [(1, True, 4), (2, False, 5),
                                               (3, True, 3), (4, False, 6)])
def test_counts_and_distances_agree_with_the_port(seed, undirected, k):
    n = 256
    src, dst = small_graph(8, seed, undirected)
    pool = graphgen.query_pool(n, src, dst, {"top_degree_share": 0.1,
                                             "max_dist": 3, "pool_size": 6,
                                             "pool_seed": seed})
    items, eng = port_items(n, src, dst, [(s, t, k) for s, t in pool])
    for (s, t), item in zip(pool, items):
        d = ref.query_dists(n, src, dst, s, t, k)
        assert ref.count_paths(n, src, dst, s, t, k, dists=d,
                               budget=64) == item.result.count
        idx = eng.cache.peek((port_batch.DEFAULT_GRAPH_ID, s, t, k,
                              port_batch.edge_mask_hash(None), 0))
        assert np.array_equal(idx.dist_s, d[0].numpy())
        assert np.array_equal(idx.dist_t, d[1].numpy())
        keys = ref.edge_keys(n, src, dst)
        rows = torch.from_numpy(item.result.paths)
        one = torch.ones(rows.shape[0], dtype=torch.int64)
        assert ref.path_faults(n, keys, rows, one * s, one * t, one,
                               k) == (0, 0)


def test_prefix_rows_are_paths_and_stop_at_the_limit():
    n, k = 256, 5
    src, dst = small_graph(8, 5, True)
    s, t = graphgen.query_pool(n, src, dst, {"top_degree_share": 0.1,
                                             "max_dist": 3, "pool_size": 1,
                                             "pool_seed": 5})[0]
    full = ref.count_paths(n, src, dst, s, t, k)
    rows = []
    got = ref.count_paths(n, src, dst, s, t, k, limit=3, rows_out=rows)
    assert 3 <= got <= full
    rows = torch.cat(rows)
    one = torch.ones(rows.shape[0], dtype=torch.int64)
    assert ref.path_faults(n, ref.edge_keys(n, src, dst), rows, one * s,
                           one * t, one, k) == (0, 0)


@pytest.mark.parametrize("src,dst,s,t,k,paths", [
    # 0 -> 1 -> 2 -> 3 and the cycle 1 -> 2 -> 1: no walk around it
    ([0, 1, 2, 2], [1, 2, 3, 1], 0, 3, 5, [0, 0, 0, 1, 1, 1]),
    # one undirected edge: s is not re-entered, t not left
    ([0, 1], [1, 0], 0, 1, 3, [0, 1, 1, 1]),
    # s -> t, and s -> 2 -> 3 -> t beside it
    ([0, 0, 2, 3], [1, 2, 3, 1], 0, 1, 3, [0, 1, 1, 2]),
])
def test_paths_by_hop_limit(src, dst, s, t, k, paths):
    src, dst = torch.tensor(src), torch.tensor(dst)
    n = int(max(src.max(), dst.max())) + 1
    assert [ref.count_paths(n, src, dst, s, t, h)
            for h in range(k + 1)] == paths


@pytest.mark.parametrize("bad,why", [
    ([0, 2, 3, -1, -1], "an edge the graph lacks"),
    ([0, 1, 2, 1, 2], "a vertex twice"),
    ([0, 1, 2, -1, -1], "ends before t"),
    ([0, -1, 2, 3, -1], "PAD inside"),
    ([1, 2, 3, -1, -1], "starts after s"),
])
def test_path_faults_finds_each_kind_of_bad_row(bad, why):
    src = torch.tensor([0, 1, 2, 2])
    dst = torch.tensor([1, 2, 3, 1])
    keys = ref.edge_keys(4, src, dst)
    rows = torch.tensor([[0, 1, 2, 3, -1], bad])
    one = torch.ones(2, dtype=torch.int64)
    assert ref.path_faults(4, keys, rows, one * 0, one * 3, one, 4) \
        == (1, 0), why


def test_path_faults_finds_a_repeated_row_within_one_answer_only():
    src = torch.tensor([0, 1, 2])
    dst = torch.tensor([1, 2, 3])
    keys = ref.edge_keys(4, src, dst)
    rows = torch.tensor([[0, 1, 2, 3]] * 3)
    zero = torch.zeros(3, dtype=torch.int64)
    assert ref.path_faults(4, keys, rows, zero, zero + 3,
                           torch.tensor([0, 0, 1]), 3) == (0, 1)


def test_graph_is_a_function_of_its_seeds():
    cfg = {"graph": {"SCALE": 11, "edgefactor": 4, "A": 0.57, "B": 0.19,
                     "C": 0.19, "undirected": True, "graph_seed": 9},
           "query": {"top_degree_share": 0.1, "max_dist": 3,
                     "pool_size": 5, "pool_seed": 4}}
    a, pool_a = graphgen.build(cfg, 2**31 + 7, CPU)
    b, pool_b = graphgen.build(cfg, 2**31 + 7, CPU)
    c, pool_c = graphgen.build(cfg, 11, CPU)
    assert pool_a == pool_b and torch.equal(a.indices, b.indices)
    assert torch.equal(a.rindices, b.rindices)
    assert a.n == 2048 and not bool((a.esrc == a.edst).any())
    assert torch.unique(a.esrc * a.n + a.edst).numel() == a.m
    # undirected: each edge both ways, so both CSRs hold the same rows
    assert torch.equal(a.indptr, a.rindptr)
    assert torch.equal(a.indices, a.rindices)
    # 4 tuples a vertex, both ways, less self-loops and repeats
    assert 0.5 * 2 * 4 * 2048 < a.m < 2 * 4 * 2048
    # another seed relabels: other arrays, the same degree sequence
    assert not torch.equal(a.indices, c.indices)
    deg = [torch.sort(torch.diff(x.indptr)).values for x in (a, c)]
    assert torch.equal(deg[0], deg[1])
    # and the same work: every pair keeps its count
    for (s1, t1), (s2, t2) in zip(pool_a, pool_c):
        assert ref.count_paths(a.n, a.esrc, a.edst, s1, t1, 4) == \
            ref.count_paths(c.n, c.esrc, c.edst, s2, t2, 4)


def test_csr_matches_the_ports_layout():
    src, dst = small_graph(9, 8, False)
    arr = graphgen.csr_from_keys(512, src, dst)
    g = port_graph.from_edges(512, torch.stack([src, dst], 1).numpy())
    for ours, theirs in ((arr.indptr, g.indptr), (arr.indices, g.indices),
                         (arr.rindptr, g.rindptr),
                         (arr.rindices, g.rindices), (arr.esrc, g.esrc)):
        assert np.array_equal(ours.numpy(), theirs)


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert names <= {"__future__", "typing", "torch"}, (path, names)
