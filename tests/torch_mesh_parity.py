"""Scenarios of the mesh engine, run once on ``repro`` and once on the
port, for tests/test_torch_distributed.py.

Each side runs in processes of its own, so the test process keeps one
JAX device and no process group:

* ``python tests/torch_mesh_parity.py repro OUT`` runs ``repro``'s
  ``DistributedPathEnum``, ``DistributedTenantRouter`` and
  ``compressed_psum_tree`` on a 2 x 2 host mesh (four forced CPU
  devices) and, for the compressed sums, on 1 x 1 and 3 x 1 meshes;
* ``python tests/torch_mesh_parity.py port ROWS COLS RANK INIT OUT`` is
  one rank of the port's ``ROWS x COLS`` gloo mesh on the CPU (one
  torch thread), the process group initialised at ``INIT``;
* ``python tests/torch_mesh_parity.py cuda ROWS COLS RANK INIT BACKEND
  OUT`` is one rank of the port's mesh on the card (tests/test_torch_cuda.py).

Every side pickles plain summaries (``summarize_output``) to ``OUT``
(``%d`` in it takes the rank), so the test compares values, not objects
of two packages.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np

K = 4
CHUNK = 7
PLAN_FIELDS = ("method", "cut", "preliminary", "used_full_estimator",
               "t_dfs", "t_join", "est_results")


def stats_queries(n):
    """``repro``'s own test queries: 8 pairs s != t from default_rng(0)."""
    rng = np.random.default_rng(0)
    qs = []
    while len(qs) < 8:
        s, t = rng.integers(0, n, 2)
        if s != t:
            qs.append((int(s), int(t)))
    return qs


def enum_calls(qs):
    """The ``enumerate_batch`` calls made on one engine, in order: all
    queries counting; the first 7 (padded to the data dim) with paths and
    ``first_n``; paths with sharing off; pairs of two sources and two
    targets with a duplicate, sharing on; an empty batch."""
    (s0, t0), (s1, t1) = qs[0], qs[1]
    shared = [(s, t) for s in (s0, s1) for t in (t0, t1) if s != t]
    return [(qs, dict(count_only=True)),
            (qs[:7], dict(count_only=False, first_n=5)),
            (qs, dict(count_only=False, sharing="off")),
            (shared + shared[:1], dict(count_only=False, sharing="auto")),
            ([], dict(count_only=True))]


def tagged_queries():
    """``repro``'s router test: 10 (graph_id, s, t) from default_rng(1)."""
    rng = np.random.default_rng(1)
    tagged = []
    while len(tagged) < 10:
        s, t = rng.integers(0, 50, 2)
        if s != t:
            tagged.append((("a", "b")[len(tagged) % 2], int(s), int(t)))
    return tagged


def rank_tree(d, m):
    """The compressed all-reduce's input of the rank at mesh coordinates
    (d, m): float32 arrays from a seed, of different magnitudes."""
    rng = np.random.default_rng(100 + 10 * d + m)
    return {"w": (rng.standard_normal((5, 7)) * (1 + d + 2 * m)).astype(
                np.float32),
            "b": [rng.standard_normal(3).astype(np.float32) * 1e-3]}


def plain_mesh_dp(g, k, ds, dt):
    """``repro``'s mesh walk-count recurrence in float64 numpy, written
    out plainly over every edge of ``g`` (``np.add.at``): the tables the
    mesh engine must give, ``(q_prefix, q_suffix, totals)`` per query.
    Unlike Alg. 5 on the index (``walk_count_dp``), it keeps the edges
    into s and out of t, as ``repro.distributed.engine`` does."""
    u, v = g.esrc.astype(np.int64), g.edst.astype(np.int64)
    Q = ds.shape[0]
    qp = np.zeros((Q, k + 1))
    qs = np.zeros((Q, k + 1))
    tot = np.zeros(Q)
    for q in range(Q):
        a, b = ds[q].astype(np.int64), dt[q].astype(np.int64)
        is_t = (b == 0).astype(np.float64)
        lvl = [(a <= i) & (b <= k - i) for i in range(k + 1)]
        c = lvl[k].astype(np.float64)
        qs[q, k] = c.sum()
        for i in range(k - 1, -1, -1):
            contrib = np.zeros(g.n)
            m = b[v] <= k - i - 1
            np.add.at(contrib, u[m], c[v[m]])
            c = np.where(lvl[i], contrib + is_t * c, 0.0)
            qs[q, i] = c.sum()
        c = lvl[0].astype(np.float64)
        qp[q, 0] = c.sum()
        for i in range(1, k + 1):
            contrib = np.zeros(g.n)
            m = a[u] <= i - 1
            np.add.at(contrib, v[m], c[u[m]])
            c = np.where(lvl[i], contrib + is_t * c, 0.0)
            qp[q, i] = c.sum()
        tot[q] = (c * is_t).sum()
    return qp, qs, tot


def summarize_result(r):
    return dict(count=int(r.count), exhausted=bool(r.exhausted),
                stats=dataclasses.asdict(r.stats), paths=r.as_tuples(),
                lengths=np.asarray(r.lengths).tolist())


def summarize_item(i):
    return dict(key=(i.s, i.t, i.k), result=summarize_result(i.result),
                plan=tuple(getattr(i.plan, f) for f in PLAN_FIELDS),
                flags=(i.index_cached, i.deduplicated, i.shared, i.fused))


def summarize_output(o):
    return dict(items=[summarize_item(i) for i in o.items],
                cache_stats=dataclasses.asdict(o.cache_stats),
                counters=dict(distinct_queries=o.distinct_queries,
                              graph_id=o.graph_id,
                              sharing_groups=o.sharing_groups,
                              shared_queries=o.shared_queries,
                              fused_queries=o.fused_queries,
                              fused_dispatches=o.fused_dispatches))


def padded(qs, rows):
    """``qs`` padded with its first query to a multiple of ``rows``, the
    split ``query_batch_stats`` asks for."""
    return qs + qs[:1] * ((-len(qs)) % rows)


def run_scenarios(core, Router, make_dpe, make_engine, default_run,
                  rows=1, entries=None):
    """The engine and router scenarios on one package: ``make_dpe(g)``
    builds its ``DistributedPathEnum``, ``make_engine()`` a host-backend
    ``BatchPathEnum``, ``default_run(dpe, qs)`` the enumeration on the
    package's default engine.  The stats batch is padded to a multiple
    of the ``rows`` data rows and cut back; ``entries(engine, gid)``
    counts a tenant's LRU entries (by default the engine's own)."""
    entries = entries or (lambda engine, gid: engine.cache.tenant_len(gid))
    out = {}
    g = core.erdos_renyi(60, 4.0, seed=5)
    dpe = make_dpe(g)
    qs = stats_queries(g.n)
    stats = dpe.query_batch_stats(np.array(padded(qs, rows)))
    qp, qsx, tot, ds, dt = (x[:len(qs)] for x in (*stats[:3], *stats[3]))
    out["stats"] = dict(qp=qp, qs=qsx, tot=tot, ds=ds, dt=dt)
    engine = make_engine()
    out["enum"] = [summarize_output(dpe.enumerate_batch(
        np.array(q, np.int64).reshape(-1, 2), engine=engine, **kw))
        for q, kw in enum_calls(qs)]
    out["enum_default"] = summarize_output(default_run(dpe, qs))

    g_a = core.erdos_renyi(50, 4.0, seed=5)
    g_b = core.power_law(60, 5.0, seed=9)
    shared_engine = make_engine()
    router = Router({"a": make_dpe(g_a), "b": make_dpe(g_b)},
                    engine=shared_engine)
    tagged = tagged_queries()
    runs = []
    for kw in (dict(), dict(count_only=False, first_n=4)):
        items, outputs = router.enumerate(tagged, **kw)
        runs.append(dict(items=[summarize_item(i) for i in items],
                         tenants=sorted(outputs),
                         outputs={gid: summarize_output(o)
                                  for gid, o in outputs.items()}))
    out["router"] = dict(
        runs=runs, entries=[entries(shared_engine, "a"),
                            entries(shared_engine, "b")])
    try:
        router.enumerate([("ghost", 0, 1)])
        out["router"]["unknown"] = None
    except KeyError as e:
        out["router"]["unknown"] = str(e)
    return out


def repro_side(path):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    import repro.core as rc
    from repro.compat import make_mesh, shard_map
    from repro.distributed.compression import compressed_psum_tree
    from repro.distributed.engine import (DistributedPathEnum,
                                          DistributedTenantRouter)

    mesh = make_mesh((2, 2), ("data", "model"))
    res = run_scenarios(
        rc, DistributedTenantRouter,
        lambda g: DistributedPathEnum(mesh, g, K),
        lambda: rc.BatchPathEnum(backend="host", chunk_size=CHUNK),
        lambda dpe, qs: dpe.enumerate_batch(
            np.array(qs), count_only=False,
            engine=rc.BatchPathEnum(backend="host")))

    # compressed sums per mesh shape: over "data", and over the whole mesh
    res["compressed"] = {}
    for rows, cols in ((2, 2), (1, 1), (3, 1)):
        m = Mesh(np.array(jax.devices()[:rows * cols]).reshape(rows, cols),
                 ("data", "model"))
        trees = [[rank_tree(d, c) for c in range(cols)] for d in range(rows)]
        stacked = {"w": jnp.asarray(np.stack([[t["w"] for t in row]
                                              for row in trees])),
                   "b": [jnp.asarray(np.stack([[t["b"][0] for t in row]
                                               for row in trees]))]}
        spec = P("data", "model")
        got = {}
        for name, axes in (("data", "data"), ("world", ("data", "model"))):
            f = jax.jit(shard_map(
                lambda tree, axes=axes: compressed_psum_tree(tree, axes),
                mesh=m, in_specs=(spec,), out_specs=spec))
            r = f(stacked)
            got[name] = {(d, c): {"w": np.asarray(r["w"][d, c]),
                                  "b": [np.asarray(r["b"][0][d, c])]}
                         for d in range(rows) for c in range(cols)}
        res["compressed"][f"{rows}x{cols}"] = got
    with open(path, "wb") as fh:
        pickle.dump(res, fh)


def mlp_loss(torch):
    """A two-layer tanh regression's loss ``(loss, aux)``, for the
    compressed gradient."""
    def loss_fn(params, batch):
        h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
        err = h @ params["w2"] - batch["y"]
        return (err * err).mean(), None
    return loss_fn


def lm_grad_case(torch, dist, make_compressed_grad_fn):
    """``repro``'s own case (tests/test_distributed.py): the compressed
    gradient of ``make_loss_fn`` on a 1-layer dense LM (d 32, vocab 64)
    over 8 sequences of 16 tokens split across the ranks, against the
    exact gradient of the whole batch (9 sequences over three ranks, so
    that each holds as many)."""
    from repro_torch import tree as tree_mod
    from repro_torch.configs.base import ArchConfig
    from repro_torch.models import transformer
    from repro_torch.training.step import make_loss_fn

    cfg = ArchConfig(name="t", family="dense", num_layers=1, d_model=32,
                     num_heads=2, kv_heads=1, d_ff=64, vocab=64,
                     head_dim=16, attn_chunk=8, tie_embeddings=True)
    params = transformer.init_params(cfg, 0, device="cpu")
    loss_fn = make_loss_fn(cfg)
    world, r = dist.get_world_size(), dist.get_rank()
    rows = -(-8 // world)          # 8 sequences, 9 over three ranks
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 64, (rows * world, 16), dtype=np.int32))
    local = toks[rows * r:rows * (r + 1)]
    loss, grads = make_compressed_grad_fn(loss_fn, dist.group.WORLD)(
        params, {"tokens": local, "labels": local})
    leaves = [p.detach().clone().requires_grad_(True)
              for p in tree_mod.leaves(params)]
    exact_loss, _ = loss_fn(tree_mod.unflatten(params, leaves),
                            {"tokens": toks, "labels": toks})
    exact = torch.autograd.grad(exact_loss, leaves)
    rel = [float((g - e).abs().max() / (e.abs().max() + 1e-9))
           for g, e in zip(tree_mod.leaves(grads), exact)]
    return dict(loss_diff=abs(float(loss) - float(exact_loss)),
                max_rel=max(rel), leaves=len(rel))


def port_side(rows, cols, rank, init_method, path):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    import repro_torch.core as tc
    from repro_torch import compat
    from repro_torch.distributed import (DistributedPathEnum,
                                         DistributedTenantRouter, Wire,
                                         compressed_all_reduce,
                                         make_compressed_grad_fn)

    mesh = compat.make_mesh((rows, cols), ("data", "model"), device="cpu",
                            init_method=init_method, rank=rank)
    data_group = mesh.get_group("data")
    dpes = []

    def make_dpe(g):
        dpes.append(DistributedPathEnum(mesh, g, K, device="cpu"))
        return dpes[-1]

    # every engine.run call of the host engines: the queries, and the
    # (s, t) pairs whose distances came with them
    engine_runs = []

    def make_engine():
        engine = tc.BatchPathEnum(device="cpu", backend="host",
                                  chunk_size=CHUNK)
        run = engine.run

        def recorded(graph, queries, **kw):
            pre = kw.get("_precomputed_distances") or {}
            engine_runs.append(dict(
                queries=[tuple(q) for q in queries],
                distance_pairs=sorted((key[1], key[2]) for key in pre)))
            return run(graph, queries, **kw)
        engine.run = recorded
        return engine

    def entries(engine, gid):
        """A tenant's LRU entries summed over the data rows."""
        n = torch.tensor([engine.cache.tenant_len(gid)], dtype=torch.int64)
        dist.all_reduce(n, group=data_group)
        return int(n[0])

    res = run_scenarios(
        tc, DistributedTenantRouter, make_dpe, make_engine,
        lambda dpe, qs: dpe.enumerate_batch(np.array(qs), count_only=False),
        rows=rows, entries=entries)
    res["engine_runs"] = engine_runs

    # collectives of one query_batch_stats call, and a Q the data dim
    # cannot split
    dpe = dpes[0]
    before = dpe.comm_counts()
    dpe.query_batch_stats(np.array(padded(stats_queries(dpe.graph.n), rows)))
    after = dpe.comm_counts()
    res["comm"] = {key: after[key] - before[key] for key in after}

    # collectives of one counting enumerate_batch call on graphs of two
    # sizes over the same queries
    res["enum_comm"] = {}
    for n in ENUM_COMM_SIZES:
        dpe_n = DistributedPathEnum(mesh, tc.erdos_renyi(n, 4.0, seed=5), K,
                                    device="cpu")
        before = dpe_n.comm_counts()
        dpe_n.enumerate_batch(np.array(stats_queries(60)),
                              engine=tc.BatchPathEnum(device="cpu",
                                                      backend="host"))
        after = dpe_n.comm_counts()
        res["enum_comm"][n] = dict(
            {key: after[key] - before[key] for key in after},
            owned_keys=dpe_n.last_split["owned_keys"])
    res["edge_rows"] = int(dpe.esrc.shape[0])
    res["indivisible_raises"] = None
    if rows > 1:
        try:
            dpe.query_batch_stats(np.array([[0, 1]] * (rows + 1)))
            res["indivisible_raises"] = False
        except ValueError:
            res["indivisible_raises"] = True

    d = dist.get_rank(mesh.get_group("data"))
    c = dist.get_rank(mesh.get_group("model"))
    tree = rank_tree(d, c)
    tt = {"w": torch.from_numpy(tree["w"]),
          "b": [torch.from_numpy(tree["b"][0])]}
    res["compressed"] = {}
    for name, group in (("data", mesh.get_group("data")),
                        ("world", dist.group.WORLD)):
        wire = Wire(group)
        r = compressed_all_reduce(tt, group, wire=wire)
        res["compressed"][name] = {"w": r["w"].numpy(),
                                   "b": [r["b"][0].numpy()]}
        res.setdefault("wire_counts", {})[name] = wire.counts()
    res["coords"] = (d, c)

    # the compressed gradient against the exact one over the whole batch
    world = dist.get_world_size()
    rng = np.random.default_rng(7)
    params = {"w1": torch.from_numpy(
                  rng.standard_normal((6, 16)).astype(np.float32) * 0.5),
              "b1": torch.from_numpy(
                  rng.standard_normal(16).astype(np.float32) * 0.1),
              "w2": torch.from_numpy(
                  rng.standard_normal((16, 1)).astype(np.float32) * 0.5)}
    x = rng.standard_normal((8 * world, 6)).astype(np.float32)
    batch = {"x": torch.from_numpy(x),
             "y": torch.from_numpy(np.sin(x[:, :1] * 2.0))}
    loss_fn = mlp_loss(torch)
    r = dist.get_rank()
    local = {key: v[8 * r:8 * (r + 1)] for key, v in batch.items()}
    loss, grads = make_compressed_grad_fn(loss_fn, dist.group.WORLD)(
        params, local)
    leaves = {key: v.detach().clone().requires_grad_(True)
              for key, v in params.items()}
    exact_loss, _ = loss_fn(leaves, batch)
    exact = torch.autograd.grad(exact_loss, list(leaves.values()))
    rel = [float((grads[key] - e).abs().max() / (e.abs().max() + 1e-9))
           for key, e in zip(leaves, exact)]
    res["grad"] = dict(loss_diff=abs(float(loss) - float(exact_loss)),
                       max_rel=max(rel))
    res["lm_grad"] = lm_grad_case(torch, dist, make_compressed_grad_fn)
    with open(path % rank, "wb") as fh:
        pickle.dump(res, fh)
    dist.destroy_process_group()


# vertices of the two graphs whose enumerate_batch collectives are compared
ENUM_COMM_SIZES = (60, 6000)


def exact_compressed_sum(torch, trees):
    """The compressed all-reduce of ``trees`` (one per rank, numpy leaves)
    rebuilt on the CPU from its definition: the largest rank's scale,
    each rank's values rounded onto it in [-127, 127], an int64 sum,
    then float32 times the scale."""
    def leaf(xs):
        xs = [torch.from_numpy(x) for x in xs]
        scale = torch.stack([x.abs().max() / 127.0 + 1e-12
                             for x in xs]).max()
        total = sum(torch.clamp(torch.round(x / scale), -127, 127).to(
            torch.int64) for x in xs)
        return (total.to(torch.float32) * scale).numpy()
    return {"w": leaf([t["w"] for t in trees]),
            "b": [leaf([t["b"][0] for t in trees])]}


# the graph of the card's mesh runs, larger than the CPU scenarios'
CUDA_GRAPH = dict(n=400, avg_degree=6.0, seed=11)
CUDA_K = 5


def cuda_side(rows, cols, rank, init_method, backend, path):
    """One rank of the port's mesh on the card (tests/test_torch_cuda.py):
    ``query_batch_stats`` and ``enumerate_batch`` on the default engine
    (``backend="device"`` on the card), with K5's launches and the
    queries this rank's row owned; then the compressed all-reduce of
    ``rank_tree`` over every rank, on CUDA tensors."""
    import torch
    import torch.distributed as dist

    import repro_torch.core as tc
    from repro_torch import compat
    from repro_torch.distributed import (DistributedPathEnum,
                                         compressed_all_reduce)
    from repro_torch.kernels import frontier_expand as fe

    mesh = compat.make_mesh((rows, cols), ("data", "model"), device="cuda",
                            backend=backend, init_method=init_method,
                            rank=rank)
    g = tc.erdos_renyi(CUDA_GRAPH["n"], CUDA_GRAPH["avg_degree"],
                       seed=CUDA_GRAPH["seed"])
    dpe = DistributedPathEnum(mesh, g, CUDA_K, device="cuda")
    qs = stats_queries(g.n)
    qp, qsx, tot, (ds, dt) = dpe.query_batch_stats(np.array(qs))
    k5 = fe.fused_launches
    out = dpe.enumerate_batch(np.array(qs), count_only=False)
    torch.cuda.synchronize()
    d = dist.get_rank(mesh.get_group("data"))
    c = dist.get_rank(mesh.get_group("model"))
    tree = rank_tree(d, c)
    summed = compressed_all_reduce(
        {"w": torch.from_numpy(tree["w"]).cuda(),
         "b": [torch.from_numpy(tree["b"][0]).cuda()]}, dist.group.WORLD)
    res = dict(stats=dict(qp=qp, qs=qsx, tot=tot, ds=ds, dt=dt),
               enum=summarize_output(out), wire=dpe.model.kind,
               edge_device=str(dpe.esrc.device),
               edge_rows=int(dpe.esrc.shape[0]),
               k5_launches=fe.fused_launches - k5,
               owned_queries=dpe.last_split["owned_queries"],
               coords=(d, c),
               compressed={"w": summed["w"].cpu().numpy(),
                           "b": [summed["b"][0].cpu().numpy()]},
               compressed_device=str(summed["w"].device))
    with open(path % rank, "wb") as fh:
        pickle.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "repro":
        repro_side(sys.argv[2])
    elif sys.argv[1] == "cuda":
        cuda_side(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6], sys.argv[7])
    else:
        port_side(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6])
