"""Scenarios of the LM's mesh layout, run on ``repro`` and on the port
in processes of their own, for tests/test_torch_mesh_lm.py and
tests/test_torch_dryrun.py.

* ``python tests/torch_shard_parity.py repro PARAMS OUT``: ``repro``'s
  train step of ``DENSE`` jitted with its shardings on a (4, 2) host
  mesh (eight forced CPU devices), and unsharded, from ``PARAMS``
  (``repro``'s initial parameters as numpy, pickled);
* ``python tests/torch_shard_parity.py port ROWS COLS RANK INIT PARAMS
  CKPT OUT``: one rank of the port's ``ROWS x COLS`` gloo mesh on the
  CPU (one torch thread), the process group initialised at ``INIT``;
  rank 0 also runs every case unsharded, and afterwards restarts the
  Trainer from ``CKPT`` on a 1 x 1 mesh of its own;
* ``python tests/torch_shard_parity.py cuda OUT``: on the card, a 1 x 1
  NCCL mesh (``cuda_side``; tests/test_torch_cuda.py);
* ``python tests/torch_shard_parity.py dryrun KIND OUT``: ``run_cell``
  on a 2 x 2 fake mesh for one ``reduced()`` arch of each family
  (``dryrun_side``).

Every side pickles plain values (floats, numpy arrays) to ``OUT`` (``%d``
in it takes the rank).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import time

import numpy as np

DENSE = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
             kv_heads=2, d_ff=128, vocab=128, head_dim=16, attn_chunk=16)
OPT = dict(total_steps=5)              # repro's test of the dense case
ARCH_OPT = dict(warmup_steps=1, total_steps=10)   # lr = peak at step 1
ARCHS = ["llama3p2_1b", "phi3_vision_4p2b", "musicgen_large",
         "qwen3_moe_30b_a3b", "llama4_maverick_400b_a17b", "mamba2_780m",
         "recurrentgemma_9b", "mistral_large_123b", "starcoder2_7b",
         "internlm2_1p8b"]
# one reduced() arch of each family, for the dry run
FAMILY_ARCHS = {"dense": "llama3p2_1b", "vlm": "phi3_vision_4p2b",
                "audio": "musicgen_large", "moe": "qwen3_moe_30b_a3b",
                "ssm": "mamba2_780m", "hybrid": "recurrentgemma_9b"}
SERVE_ARCHS = ["llama3p2_1b", "qwen3_moe_30b_a3b",
               "llama4_maverick_400b_a17b", "mamba2_780m", "recurrentgemma_9b"]
CUDA_ARCHS = ["llama3p2_1b", "qwen3_moe_30b_a3b",
              "llama4_maverick_400b_a17b", "mamba2_780m", "recurrentgemma_9b"]
# the dry run's train cells take ``arch_batch``'s shape, so their FLOPs
# compare with the gloo ranks' own counts
DRYRUN_SHAPE = dict(seq_len=16, global_batch=4)
TRAINER = dict(arch="llama3p2_1b", seq_len=16, global_batch=4, steps=4,
               stop_at=2)


def dryrun_shape(name):
    """The shape ``name`` cut to ``DRYRUN_SHAPE``."""
    from repro_torch.configs import get_shape
    return dataclasses.replace(get_shape(name), **DRYRUN_SHAPE)


def dense_tokens():
    """``DENSE``'s batch: (8, 32) tokens below its vocab, from numpy."""
    return np.random.default_rng(1).integers(0, 128, (8, 32)).astype(
        np.int32)


def arch_batch(cfg, B=4, S=16, seed=0):
    """Tokens, labels with one masked position, and the prefix for vlm
    and audio, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = toks.copy()
    labels[0, 3] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.frontend != "none":
        batch["prefix_emb"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def to_numpy(tree):
    """A tree of (D)Tensors as numpy arrays, DTensors gathered first."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as tree_mod

    def one(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
    return tree_mod.tree_map(one, tree)


# ---------------------------------------------------------------------------
# repro
# ---------------------------------------------------------------------------

def repro_side(params_path, out):
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp

    from repro.compat import make_mesh, set_mesh
    from repro.configs.base import ArchConfig
    from repro.distributed import sharding as S
    from repro.optim import adamw
    from repro.training.step import make_train_step

    cfg = ArchConfig(**DENSE)
    with open(params_path, "rb") as fh:
        params = jax.tree.map(jnp.asarray, pickle.load(fh))
    opt = adamw.init(params)
    toks = jnp.asarray(dense_tokens())
    batch = {"tokens": toks, "labels": toks}
    ts = make_train_step(cfg, adamw.OptimizerConfig(**OPT))
    mesh = make_mesh((4, 2), ("data", "model"))
    rules = S.ShardingRules(mesh)
    pspecs = S.tree_specs(params, rules.param_spec)
    psh = S.tree_shardings(mesh, pspecs)
    osh = S.tree_shardings(mesh, S.opt_shardings(pspecs, opt))
    bsh = S.tree_shardings(mesh, S.tree_specs(batch, rules.batch_spec))
    with set_mesh(mesh):
        jf = jax.jit(ts, in_shardings=(psh, osh, bsh),
                     out_shardings=(psh, osh, None))
        p1, _, m1 = jf(params, opt, batch)
    p2, _, m2 = jax.jit(ts)(params, opt, batch)
    res = {"sharded": {"loss": float(m1["loss"]),
                       "params": jax.tree.map(np.asarray, p1)},
           "plain": {"loss": float(m2["loss"]),
                     "params": jax.tree.map(np.asarray, p2)}}
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


def repro_initial_params():
    """``repro``'s initial ``DENSE`` parameters from ``PRNGKey(0)``, as
    numpy (``repro``'s tree)."""
    import jax

    from repro.configs.base import ArchConfig
    from repro.models import init_params

    params = init_params(ArchConfig(**DENSE), jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def train_case(torch, cfg, params, batch, mesh, opt_kw=OPT, device="cpu"):
    """One train step of ``cfg`` from ``params`` (plain CPU tensors) on
    ``batch`` (numpy), laid out on ``mesh`` or unsharded with ``mesh``
    None, and the gradients at ``params``.  Returns a dict of plain
    values: ``loss``, ``grad_norm``, the stepped ``params`` and the
    ``grads`` as numpy, whether every gradient came back on its
    parameter's placements, the parameters' placements, and this rank's
    FLOPs over the step as the dry run's ``CostMode`` counts them."""
    from repro_torch import tree as tree_mod
    from repro_torch.distributed import constraints as con
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.dryrun import CostMode
    from repro_torch.optim import adamw
    from repro_torch.training import step as step_mod

    fn = step_mod.make_train_step(cfg, adamw.OptimizerConfig(**opt_kw))
    opt = adamw.init(params)
    tb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if mesh is not None:
        pspecs = S.param_shardings(mesh, cfg, params)
        params = S.distribute_tree(params, mesh, pspecs)
        opt = S.distribute_tree(opt, mesh, S.opt_shardings(pspecs, opt))
        tb = S.distribute_tree(tb, mesh, S.batch_shardings(mesh, tb))
    with con.use_mesh(mesh), CostMode() as cost:
        stepped, _, m = fn(params, opt, tb)
    with con.use_mesh(mesh):
        _, _, grads = step_mod._value_and_grad(step_mod.make_loss_fn(cfg),
                                               params, tb)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "flops": cost.flops}
    if mesh is not None:
        pl = [(g.placements, p.placements) for g, p in
              zip(tree_mod.leaves(grads), tree_mod.leaves(params))]
        out["grads_on_param_placements"] = all(a == b for a, b in pl)
        out["placements"] = sorted({str(b) for _, b in pl})
    out["params"] = to_numpy(stepped)
    out["grads"] = to_numpy(grads)
    return out


def serve_case(torch, cfg, params, mesh, impl="xla", device="cpu", B=4):
    """A prefill of (B, 12) tokens, then two decode steps into a zero
    cache of 20 positions (lengths 12 and 13; with B = 1 the cache is
    split over its sequence), on the plain path
    (``impl="xla"``) or on the kernel route (``"flash"``: on the CPU the
    kernels' plain versions, on each rank's local shards).  Returns numpy
    (prefill logits, the prefill's K cache or None, decode logits of both
    steps, the cache after) and the attention routes taken."""
    from repro_torch.distributed import constraints as con
    from repro_torch.models import attention as attn_mod
    from repro_torch.distributed import sharding as S
    from repro_torch.models import transformer as tm
    from repro_torch.training import step as step_mod

    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 12)).astype(
        np.int32)).to(device)
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab, (2, B)).astype(
        np.int32)).to(device)
    cache = tm.init_cache(cfg, B, 20, device=device)
    lens = torch.full((B,), 12, dtype=torch.int32, device=device)
    batch = {"tokens": toks}
    if mesh is not None:
        params = S.distribute_tree(params, mesh,
                                   S.param_shardings(mesh, cfg, params))
        batch = S.distribute_tree(batch, mesh,
                                  S.batch_shardings(mesh, batch))
        cache = S.distribute_tree(cache, mesh,
                                  S.cache_shardings(mesh, cfg, cache))
    prefill = step_mod.make_prefill(cfg, impl=impl)
    serve = step_mod.make_serve_step(cfg, impl=impl)
    routes0 = dict(attn_mod.mesh_routes)
    out = {}
    with con.use_mesh(mesh):
        logits, kv, _ = prefill(params, batch)
        out["prefill_logits"] = to_numpy(logits)
        out["prefill_k"] = to_numpy(kv["k"]) if "k" in kv else None
        steps = []
        for i in range(2):
            t, ln = nxt[i], lens + i
            if mesh is not None:
                t, ln = (S.distribute_tree(x, mesh, S.batch_shardings(mesh, x))
                         for x in (t, ln))
            tok, cache, lg = serve(params, t, cache, ln)
            steps.append(to_numpy(lg))
        out["decode_logits"] = steps
        out["cache"] = to_numpy(cache)
    out["routes"] = {k: v - routes0[k] for k, v in
                     attn_mod.mesh_routes.items()}
    return out


def constrain_case(torch, mesh, device="cpu"):
    """``constrain`` outside a mesh (the same tensor back) and inside one
    on a plain tensor (the error's type name); the kernel wrappers handed
    DTensors (the errors' type names)."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.distributed import constraints as con
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import flash_attention as kf

    def raised(call):
        try:
            call()
        except TypeError as e:
            return type(e).__name__
        return None
    x = torch.ones(4, 8, 16, device=device)
    same = con.constrain(x, con.act_bsd) is x

    def inside():
        with con.use_mesh(mesh):
            con.constrain(x, con.act_bsd)
    rep = [Replicate()] * mesh.ndim
    q, k = (distribute_tensor(torch.ones(s, device=device), mesh, rep,
                              src_data_rank=None)
            for s in ((1, 8, 2, 16), (1, 8, 1, 16)))
    n = distribute_tensor(torch.full((1,), 8, device=device), mesh, rep,
                          src_data_rank=None)
    return {"outside_is_same": same, "inside_plain_raises": raised(inside),
            "flash_raises": raised(lambda: kf.flash_attention(q, k, k)),
            "decode_raises": raised(lambda: kd.decode_attention(
                q[:, 0], k, k, n))}


def trainer_run(torch, cfg, mesh, steps, ckpt_dir=None, ckpt_every=100):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import Trainer, TrainerConfig

    t = TRAINER
    data = SyntheticLM(vocab=cfg.vocab, seq_len=t["seq_len"],
                       global_batch=t["global_batch"], seed=3)
    tr = Trainer(cfg, adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                            total_steps=t["steps"]),
                 TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                               ckpt_dir=ckpt_dir, log_every=1, seed=0,
                               device="cpu"), mesh=mesh)
    params, _ = tr.fit(data)
    return {"losses": [r["loss"] for r in tr.metrics_log],
            "steps": [r["step"] for r in tr.metrics_log],
            "params": to_numpy(params)}


def port_side(rows, cols, rank, init, params_path, ckpt_dir, out):
    import signal

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ArchConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tm
    from repro_torch.compat import make_mesh

    mesh = make_mesh((rows, cols), ("data", "model"), device="cpu",
                     init_method=init, rank=rank)
    lead = rank == 0
    res = {}
    clock = time.perf_counter
    t0 = clock()

    # the dense case of repro's tests, from repro's initial parameters
    dense = ArchConfig(**DENSE)
    with open(params_path, "rb") as fh:
        p0 = tm.params_from_numpy(dense, pickle.load(fh), device="cpu")
    toks = dense_tokens()
    batch = {"tokens": toks, "labels": toks}
    res["dense"] = train_case(torch, dense, p0, batch, mesh)
    sp = dataclasses.replace(dense, seq_shard_activations=True)
    res["dense_sp"] = train_case(torch, sp, p0, batch, mesh)
    if lead:
        res["dense_plain"] = train_case(torch, dense, p0, batch, None)

    # one sharded step of every family's reduced()
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        p = tm.init_params(cfg, 0, device="cpu")
        b = arch_batch(cfg)
        t1 = clock()
        res[f"arch/{arch}"] = train_case(torch, cfg, p, b, mesh, ARCH_OPT)
        res.setdefault("case_s", {})[arch] = clock() - t1
        if lead:
            res[f"arch_plain/{arch}"] = train_case(torch, cfg, p, b, None,
                                                   ARCH_OPT)

    # prefill and decode on the plain path
    for arch in SERVE_ARCHS:
        cfg = get_arch(arch).reduced()
        p = tm.init_params(cfg, 0, device="cpu")
        res[f"serve/{arch}"] = serve_case(torch, cfg, p, mesh)
        if lead:
            res[f"serve_plain/{arch}"] = serve_case(torch, cfg, p, None)
    # the kernel route on local shards (the kernels' plain versions here)
    cfg = get_arch(SERVE_ARCHS[0]).reduced()
    p = tm.init_params(cfg, 0, device="cpu")
    res["serve_flash"] = serve_case(torch, cfg, p, mesh, impl="flash")
    # a batch of one: the cache split over its sequence
    res["serve_b1"] = serve_case(torch, cfg, p, mesh, impl="flash", B=1)
    if lead:
        res["serve_b1_plain"] = serve_case(torch, cfg, p, None, B=1)

    res["constrain"] = constrain_case(torch, mesh)
    res["seconds"] = {"cases": clock() - t0}

    # the Trainer: checkpoint on this mesh at stop_at ...
    cfg = get_arch(TRAINER["arch"]).reduced()
    res["trainer_first"] = trainer_run(torch, cfg, mesh, TRAINER["stop_at"],
                                       ckpt_dir)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    dist.barrier()
    dist.destroy_process_group()
    if lead:
        import shutil

        from repro_torch.checkpoint.manager import CheckpointManager
        saved, _ = CheckpointManager(ckpt_dir).restore(
            TRAINER["stop_at"], {"params": tm.init_params(cfg, 0,
                                                          device="cpu")})
        res["trainer_saved"] = to_numpy(saved["params"])
        copy = ckpt_dir.rstrip("/") + "_plain"
        shutil.copytree(ckpt_dir, copy)
        # ... resume on a one-rank mesh, and unsharded from a copy, and an
        # uninterrupted unsharded run
        one = make_local_mesh(device="cpu")
        res["trainer_resumed"] = trainer_run(torch, cfg, one,
                                             TRAINER["steps"], ckpt_dir)
        res["trainer_resumed_mesh"] = tuple(one.shape)
        dist.destroy_process_group()
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        res["trainer_resumed_plain"] = trainer_run(
            torch, cfg, None, TRAINER["steps"], copy)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        res["trainer_plain"] = trainer_run(torch, cfg, None,
                                           TRAINER["steps"])
    res["seconds"]["all"] = clock() - t0
    with open(out % rank, "wb") as fh:
        pickle.dump(res, fh)


def cuda_side(out):
    """On the card (tests/test_torch_cuda.py), a 1 x 1 NCCL mesh: for
    each of ``CUDA_ARCHS``' ``reduced()``, one train step laid out on it
    and unsharded, and a prefill and two decode steps with the kernels
    (``impl=None``: K6 and K7 on the local shards) against the unsharded
    kernel path, with the routes and launches; the kernel wrappers
    handed DTensors."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tm

    dev = torch.device("cuda", 0)
    mesh = make_local_mesh()
    res = {"mesh": (tuple(mesh.shape), mesh.device_type,
                    dist.get_backend())}
    for arch in CUDA_ARCHS:
        cfg = get_arch(arch).reduced()
        p = tm.init_params(cfg, 0, device=dev)
        b = arch_batch(cfg)
        res[f"arch/{arch}"] = train_case(torch, cfg, p, b, mesh, ARCH_OPT,
                                         dev)
        res[f"arch_plain/{arch}"] = train_case(torch, cfg, p, b, None,
                                               ARCH_OPT, dev)
    for arch in CUDA_ARCHS:
        cfg = get_arch(arch).reduced()
        p = tm.init_params(cfg, 0, device=dev)
        kernels.reset_launch_counts()
        res[f"serve/{arch}"] = serve_case(torch, cfg, p, mesh, None, dev)
        res[f"serve_launches/{arch}"] = kernels.launch_counts()
        res[f"serve_plain/{arch}"] = serve_case(torch, cfg, p, None, None,
                                                dev)
    res["constrain"] = constrain_case(torch, mesh, dev)
    dist.destroy_process_group()
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def dryrun_side(kind, out):
    """``run_cell`` on a 2 x 2 fake mesh for each family's ``reduced()``
    arch: ``kind`` "train", the train cells at ``arch_batch``'s shape
    (every rank for the dense family, rank 0 for the rest), or "serve",
    the prefill and decode cells at rank 0."""
    import torch

    torch.set_num_threads(1)
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun

    shapes = ("train_4k",) if kind == "train" else ("prefill_32k",
                                                    "decode_32k")
    res = {}
    for family, arch in FAMILY_ARCHS.items():
        cfg = get_arch(arch).reduced()
        for shape_name in shapes:
            shape = dryrun_shape(shape_name)
            ranks = range(4) if (family == "dense"
                                 and kind == "train") else (0,)
            res[(arch, shape_name)] = [
                dryrun.run_cell(arch, shape_name, "single",
                                mesh_shape=(2, 2), rank=r, cfg=cfg,
                                shape=shape, dtype=torch.float32)
                for r in ranks]
    dryrun.release_fake_group()
    if kind == "serve":
        # beside a default group made elsewhere, run_cell refuses to run
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_local_mesh
        make_local_mesh(device="cpu")
        try:
            dryrun.run_cell("llama3p2_1b", "decode_32k", "single",
                            mesh_shape=(1, 1), cfg=get_arch(
                                "llama3p2_1b").reduced(),
                            shape=dryrun_shape("decode_32k"))
            res["refused"] = None
        except RuntimeError as e:
            res["refused"] = str(e)
        dist.destroy_process_group()
    with open(out, "wb") as fh:
        pickle.dump(res, fh)


if __name__ == "__main__":
    if sys.argv[1] == "repro":
        repro_side(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "dryrun":
        dryrun_side(sys.argv[2], sys.argv[3])
    elif sys.argv[1] == "cuda":
        cuda_side(sys.argv[2])
    else:
        port_side(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6], sys.argv[7], sys.argv[8])
