"""The LM on a mesh: the port's sharded train step, prefill, decode and
Trainer on a CPU gloo 2 x 2 mesh against the unsharded port and
``repro``'s sharded step.

One module-wide run starts, all at once, the processes of
tests/torch_shard_parity.py: ``repro``'s side (a (4, 2) host mesh of
eight forced XLA CPU devices) and the four ranks of the port's 2 x 2
gloo mesh (one torch thread each).  Rank 0 also runs every case
unsharded, then restarts the Trainer from the 2 x 2 run's checkpoint on
a 1 x 1 mesh of its own.

Tolerances:
- ``repro``'s dense case (tests/test_distributed.py's config and
  optimizer) is held to that test's own bounds: loss within 1e-4,
  parameters within 1e-3, against the unsharded port step and against
  ``repro``'s (4, 2) sharded step;
- ``seq_shard_activations`` changes layout only: the same loss within
  1e-5 (tests/test_distributed.py's check);
- every arch's ``reduced()``: a layout changes the order of float32 sums
  only, so the loss within 1e-5 relative, the grad norm within 1e-5
  relative, every gradient leaf within 1e-4 of its largest entry
  (tests/torch_train_parity.py's bound; the MoE router's float32 sums
  reach 1.7e-5), and
  the parameters after a step at the peak learning rate under
  tests/torch_train_parity.py's rule;
- prefill and decode logits, and the caches they write, within 1e-5;
- a Trainer restarted on 1 x 1 from a checkpoint saved on 2 x 2 equals,
  bit for bit, an unsharded Trainer restarted from the same checkpoint
  (one rank's DTensor operations are the plain ones), and an
  uninterrupted unsharded run under the parameter rule above over the
  summed learning rate.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree as tree_mod
from repro_torch.compat import free_port

import torch_shard_parity as sp
from torch_train_parity import G_FLOOR, GRAD_RTOL

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT = 600
ROWS, COLS = 2, 2
RTOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{"repro": ..., "port": [rank 0's results, ...]}``."""
    tmp = tmp_path_factory.mktemp("shard")
    params_path = tmp / "repro_params.pkl"
    with open(params_path, "wb") as fh:
        pickle.dump(sp.repro_initial_params(), fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(HERE)]),
               OMP_NUM_THREADS="1")
    script = str(HERE / "torch_shard_parity.py")
    procs = [subprocess.Popen(
        [sys.executable, script, "repro", str(params_path),
         str(tmp / "repro.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)]
    procs.append(subprocess.Popen(
        [sys.executable, script, "dryrun", "train", str(tmp / "dry.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True))
    init = f"tcp://127.0.0.1:{free_port()}"
    out = str(tmp / "port_%d.pkl")
    procs += [subprocess.Popen(
        [sys.executable, script, "port", str(ROWS), str(COLS), str(r), init,
         str(params_path), str(tmp / "ckpt"), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ROWS * COLS)]
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
    return {"repro": load(tmp / "repro.pkl"), "dryrun": load(tmp / "dry.pkl"),
            "port": [load(out % r) for r in range(ROWS * COLS)]}


def max_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(tree_mod.leaves(a), tree_mod.leaves(b)))


def to_repro_layout(port_params):
    """The port's parameters (numpy) in ``repro``'s dense tree: the
    per-layer dicts stacked under ``supers/b0_attn``."""
    layers = port_params["layers"]
    out = {k: v for k, v in port_params.items() if k != "layers"}

    def stack(*xs):
        return np.stack(xs)
    out["supers"] = {"b0_attn": tree_mod.tree_map(stack, *layers)}
    return out


def assert_step_close(got, want, lr_total):
    """tests/torch_train_parity.py's rule on numpy trees: within 1e-2 of
    the summed learning rate where the reference gradient is at least
    ``G_FLOOR`` of its leaf's largest, within 3 lr elsewhere."""
    for (path, a), b, g in zip(tree_mod.leaves_with_path(got["params"]),
                               tree_mod.leaves(want["params"]),
                               tree_mod.leaves(want["grads"])):
        diff = np.abs(a.astype(np.float64) - b)
        strong = np.abs(g) >= G_FLOOR * np.abs(g).max()
        slack = 1e-6 * float(np.abs(b).max())
        assert float(np.where(strong, diff, 0).max()) \
            <= 1e-2 * lr_total + slack, path
        assert float(diff.max()) <= 3 * lr_total + slack, path


def test_ranks_agree(runs):
    """Every rank gathers the same full parameters and loss."""
    lead = runs["port"][0]
    for other in runs["port"][1:]:
        assert other["dense"]["loss"] == lead["dense"]["loss"]
        assert max_diff(other["dense"]["params"],
                        lead["dense"]["params"]) == 0.0


def test_dense_sharded_step_equals_unsharded(runs):
    got, want = runs["port"][0]["dense"], runs["port"][0]["dense_plain"]
    assert abs(got["loss"] - want["loss"]) < 1e-4
    assert max_diff(got["params"], want["params"]) < 1e-3
    assert got["grads_on_param_placements"]
    # the layout really is 2-D: some leaf sharded over both mesh dims
    assert any("Shard" in p.split(",")[0] and "Shard" in p.split(",")[1]
               for p in got["placements"])


@pytest.mark.parametrize("side", ["sharded", "plain"])
def test_dense_sharded_step_equals_repro(runs, side):
    got, want = runs["port"][0]["dense"], runs["repro"][side]
    assert abs(got["loss"] - want["loss"]) < 1e-4
    assert max_diff(to_repro_layout(got["params"]), want["params"]) < 1e-3


def test_seq_shard_activations_same_loss(runs):
    lead = runs["port"][0]
    assert abs(lead["dense_sp"]["loss"] - lead["dense"]["loss"]) < 1e-5
    assert max_diff(lead["dense_sp"]["params"],
                    lead["dense"]["params"]) < 1e-3


@pytest.mark.parametrize("arch", sp.ARCHS)
def test_arch_sharded_step_equals_unsharded(runs, arch):
    got = runs["port"][0][f"arch/{arch}"]
    want = runs["port"][0][f"arch_plain/{arch}"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=RTOL)
    assert got["grads_on_param_placements"]
    for (path, a), b in zip(tree_mod.leaves_with_path(got["grads"]),
                            tree_mod.leaves(want["grads"])):
        assert float(np.abs(a - b).max()) <= GRAD_RTOL * float(
            np.abs(b).max()) + 1e-12, path
    assert_step_close(got, want, 3e-4)


@pytest.mark.parametrize("arch", sorted(sp.FAMILY_ARCHS.values()))
def test_dry_run_train_cell_equals_gloo_ranks(runs, arch):
    """``run_cell`` on a 2 x 2 fake mesh (meta tensors) for the train
    step the gloo ranks ran: status ok, argument bytes equal to the local
    shards reckoned by hand from the specs (params, AdamW state, batch),
    and each rank's FLOPs equal to that rank's count on the real mesh,
    so their sum over the four ranks too."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import specs

    recs = runs["dryrun"][(arch, "train_4k")]
    gloo = [r[f"arch/{arch}"]["flops"] for r in runs["port"]]
    for r, rec in enumerate(recs):
        assert rec["status"] == "ok", rec
        assert rec["chips"] == ROWS * COLS
        assert rec["cost"]["flops_per_device"] == gloo[r]
    if len(recs) == ROWS * COLS:
        assert sum(rec["cost"]["flops_per_device"] for rec in recs) \
            == sum(gloo)
    # sharded work is less than the unsharded step's
    assert gloo[0] < runs["port"][0][f"arch_plain/{arch}"]["flops"]

    cfg = get_arch(arch).reduced()
    mesh = S.LayoutMesh((ROWS, COLS), ("data", "model"))
    rules = S.ShardingRules(mesh)
    p = specs.param_specs(cfg, torch.float32)
    batch = specs.input_specs(cfg, sp.dryrun_shape("train_4k"),
                              torch.float32)["batch"]
    want = 0
    for tree, rule, copies in ((p, rules.param_spec, 3),
                               (batch, rules.batch_spec, 1)):
        for path, x in tree_mod.leaves_with_path(tree):
            n = x.numel() * x.element_size()
            for entry in rule(path, tuple(x.shape)):
                for name in ((entry,) if isinstance(entry, str)
                             else entry or ()):
                    n //= dict(zip(mesh.mesh_dim_names, mesh.shape))[name]
            want += copies * n       # float32 params: mu and nu as large
    want += 4                                   # AdamW's int32 step
    assert recs[0]["memory"]["argument_bytes"] == want


@pytest.mark.parametrize("arch", sp.SERVE_ARCHS)
def test_sharded_prefill_and_decode_equal_unsharded(runs, arch):
    got = runs["port"][0][f"serve/{arch}"]
    want = runs["port"][0][f"serve_plain/{arch}"]
    assert max_diff(got["prefill_logits"], want["prefill_logits"]) < 1e-5
    if want["prefill_k"] is not None:
        assert max_diff(got["prefill_k"], want["prefill_k"]) < 1e-5
    assert max_diff(got["decode_logits"], want["decode_logits"]) < 1e-5
    assert max_diff(got["cache"], want["cache"]) < 1e-5


def test_sequence_split_cache_equals_unsharded(runs):
    """A batch of one: ``cache_spec`` splits the cache over its sequence,
    so a decode step writes its row by a masked copy and K7's route
    falls back to the plain path (the prefill keeps the kernel route on
    whole heads)."""
    got = runs["port"][0]["serve_b1"]
    want = runs["port"][0]["serve_b1_plain"]
    layers = 3
    assert got["routes"] == {"local_kernel": layers, "plain": 2 * layers}
    assert max_diff(got["prefill_logits"], want["prefill_logits"]) < 1e-5
    assert max_diff(got["decode_logits"], want["decode_logits"]) < 1e-5
    assert max_diff(got["cache"], want["cache"]) < 1e-5


def test_constrain_raises_inside_a_mesh_only(runs):
    rec = runs["port"][0]["constrain"]
    assert rec["outside_is_same"]
    assert rec["inside_plain_raises"] == "TypeError"


def test_kernel_wrappers_refuse_dtensors(runs):
    rec = runs["port"][0]["constrain"]
    assert rec["flash_raises"] == "TypeError"
    assert rec["decode_raises"] == "TypeError"


def test_kernel_route_runs_on_local_shards(runs):
    """``impl="flash"`` on DTensors: K6 and K7 (their plain versions on
    the CPU) on each rank's whole (batch, head) slices through
    ``local_map``, every attention call of the prefill and of both decode
    steps, equal to the unsharded plain path."""
    got = runs["port"][0]["serve_flash"]
    want = runs["port"][0][f"serve_plain/{sp.SERVE_ARCHS[0]}"]
    layers = 3                                  # llama3.2-1b reduced()
    assert got["routes"] == {"local_kernel": 3 * layers, "plain": 0}
    assert runs["port"][0][f"serve/{sp.SERVE_ARCHS[0]}"]["routes"] == {
        "local_kernel": 0, "plain": 0}
    assert max_diff(got["prefill_logits"], want["prefill_logits"]) < 1e-5
    assert max_diff(got["decode_logits"], want["decode_logits"]) < 1e-5
    assert max_diff(got["cache"], want["cache"]) < 1e-5


def test_checkpoint_saved_on_2x2_resumes_on_1x1(runs):
    lead = runs["port"][0]
    t = sp.TRAINER
    assert lead["trainer_resumed_mesh"] == (1, 1)
    assert lead["trainer_first"]["steps"] == list(range(t["stop_at"]))
    assert lead["trainer_resumed"]["steps"] == list(
        range(t["stop_at"], t["steps"]))
    # the saved tree is the 2 x 2 run's full parameters
    assert max_diff(lead["trainer_saved"],
                    lead["trainer_first"]["params"]) == 0.0
    # one rank's DTensors compute what plain tensors do
    assert lead["trainer_resumed"]["losses"] == \
        lead["trainer_resumed_plain"]["losses"]
    assert max_diff(lead["trainer_resumed"]["params"],
                    lead["trainer_resumed_plain"]["params"]) == 0.0


def test_restart_equals_uninterrupted_run(runs):
    lead = runs["port"][0]
    t = sp.TRAINER
    plain = lead["trainer_plain"]
    np.testing.assert_allclose(
        lead["trainer_first"]["losses"] + lead["trainer_resumed"]["losses"],
        plain["losses"], rtol=RTOL)
    # the learning rates of the run: warmup of 1 step to 1e-3, then the
    # cosine; their sum bounds how far a parameter can move
    lr_total = t["steps"] * 1e-3
    diff = max_diff(lead["trainer_resumed"]["params"], plain["params"])
    assert diff <= 1e-2 * lr_total, diff


def test_trainer_without_a_mesh_is_unchanged():
    """``Trainer(mesh=None)`` keeps plain tensors (no process group)."""
    from repro_torch.configs import get_arch
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import Trainer, TrainerConfig

    tr = Trainer(get_arch("llama3p2_1b").reduced(), adamw.OptimizerConfig(),
                 TrainerConfig(device="cpu"))
    params, opt = tr.init_state()
    assert tr.mesh is None and tr.shardings is None
    assert all(type(x) is torch.Tensor
               for x in tree_mod.leaves((params, opt)))
