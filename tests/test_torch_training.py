"""The port's training path (``optim.adamw``, ``transformer.loss_fn``,
``training.step``, ``training.trainer``, ``checkpoint.manager``,
``data.pipeline``, ``launch.train``) against ``repro``'s, on the CPU.

``repro``'s parameters and optimizer state go to the port through
``params_from_numpy`` and ``adamw.state_from_numpy``, so both packages
train the same weights on the same numpy batches, on the ``TINY``
config of tests/test_training.py.

Tolerances:
- The schedule is equal in float32, and ``SyntheticLM``, ``PathCorpus``
  and ``make_frontend_stub`` batches are equal bit for bit (numpy
  generators, and paths are a bit-identity promise of the port).
- Loss within 1e-5 relative; every gradient leaf within 1e-5 of its
  largest entry: XLA:CPU and torch's CPU matmuls sum in other orders in
  float32 (measured: 1e-6 at most on TINY).
- Updated parameters (``_assert_params_close``): AdamW moves an entry by
  about lr·g / (|g| + eps) a step, the sign of its gradient, so an entry
  whose gradient is near 0 can move either way between two float32
  summation orders.  Where the reference gradient is at least
  ``G_FLOOR`` of its leaf's largest, the entry is held within 1e-2 of
  the summed learning rate (plus 1e-6 of its leaf's largest value): a
  flipped sign would be 2 lr.  Every other entry is bounded by the
  update's own size, 3 × the summed learning rate.
- A trainer's learning rates within one float32 ulp (``LR_RTOL``):
  ``repro``'s own schedule, jitted inside its step and called eagerly,
  differs by one ulp at some steps (step 4 of ``OPT_KW``; the port's
  eager schedule equals the eager one there and differs at step 10).
- Restart equals an uninterrupted run bit for bit (one torch thread,
  the same CPU kernels, float32 restored exactly).
"""
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import power_law as jpower_law
from repro.data import pipeline as jpipe
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.training import step as jstep
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import tree as tree_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.core import power_law
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.training import step as tstep
from repro_torch.training.trainer import Trainer, TrainerConfig

TINY_KW = dict(name="tiny", family="dense", num_layers=2, d_model=64,
               num_heads=4, kv_heads=2, d_ff=128, vocab=256, head_dim=16,
               attn_chunk=16, tie_embeddings=True)
J_TINY, TINY = JArchConfig(**TINY_KW), ArchConfig(**TINY_KW)
G_FLOOR = 1e-3
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-5
LR_RTOL = 2 ** -23
OPT_KW = dict(peak_lr=1e-3, warmup_steps=3, total_steps=12)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_port(tree):
    """A tree of ``repro``'s parameter layout as the port's."""
    return ttf.params_from_numpy(TINY, _np_tree(tree), device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jtf.init_params(J_TINY, jax.random.PRNGKey(0))


def _batch(seed=0, step=0, masked=False):
    b = jpipe.SyntheticLM(vocab=TINY.vocab, seq_len=16, global_batch=4,
                          seed=seed).batch_at(step)
    if masked:                     # PathCorpus-style labels: -1 past EOS
        b["labels"][:, 10:] = -1
        b["labels"][1, 3:] = -1
    return b


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _assert_params_close(got, want, grads, lr_total):
    """``got`` (port tree) against ``want`` and ``grads`` (port-layout
    trees of ``repro``'s values) under the module docstring's rule."""
    for (path, a), b, g in zip(tree_mod.leaves_with_path(got),
                               tree_mod.leaves(want), tree_mod.leaves(grads)):
        a, b, g = a.double(), b.double(), g.double()
        diff = (a - b).abs()
        strong = g.abs() >= G_FLOOR * g.abs().max()
        tol = 1e-2 * lr_total + 1e-6 * b.abs().max()
        assert float(torch.where(strong, diff, 0).max()) <= tol, path
        assert float(diff.max()) <= 3 * lr_total + 1e-6 * b.abs().max(), path


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 5, 10, 50, 100])
def test_cosine_schedule_equals_repro(step):
    kw = dict(peak_lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = np.float32(jadamw.cosine_schedule(jadamw.OptimizerConfig(**kw),
                                             jnp.int32(step)))
    got = adamw.cosine_schedule(adamw.OptimizerConfig(**kw),
                                torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def _seeded_tree(rng, scale=1.0):
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "blk": [{"a": (rng.standard_normal(7) * scale).astype(np.float32),
                     "b": (rng.standard_normal((3, 4)) * scale).astype(
                         np.float32)}] * 2,
            "bias": (rng.standard_normal(4) * scale).astype(np.float32)}


@pytest.mark.parametrize("seed,gscale", [(0, 0.01), (1, 1.0), (2, 10.0)])
def test_clip_and_update_equal_repro(seed, gscale):
    """Three AdamW updates on seeded trees, the norm above and below the
    clip: params, moments, lr and norm against ``repro``'s."""
    rng = np.random.default_rng(seed)
    params = _seeded_tree(rng)
    grads = [_seeded_tree(rng, gscale) for _ in range(3)]
    jcfg = jadamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=2,
                                  total_steps=10)
    tcfg = adamw.OptimizerConfig(peak_lr=1e-2, warmup_steps=2,
                                 total_steps=10)
    as_t = lambda tree: tree_mod.tree_map(torch.from_numpy, tree)  # noqa
    jp, tp = jax.tree.map(jnp.asarray, params), as_t(params)
    js, ts = jadamw.init(jp), adamw.init(tp)
    for g in grads:
        jclip, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                               1.0)
        tclip, tn = adamw.clip_by_global_norm(as_t(g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(tree_mod.leaves(tclip), jax.tree.leaves(jclip)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-12)
        jp, js, jm = jadamw.update(jcfg, jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = adamw.update(tcfg, as_t(g), ts, tp)
        assert int(ts.step) == int(js.step) and ts.step.dtype == torch.int32
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        for a, b in zip(tree_mod.leaves((tp, ts.mu, ts.nu)),
                        jax.tree.leaves((jp, js.mu, js.nu))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-9)


def test_state_from_numpy_carries_repro_state(jparams):
    js = jadamw.init(jparams)
    js = js._replace(step=jnp.int32(7),
                     mu=jax.tree.map(lambda x: x + 1.0, js.mu))
    ts = adamw.state_from_numpy(TINY, _np_tree(js), device="cpu")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 7
    assert all(x.dtype == torch.float32 for x in tree_mod.leaves(ts.mu))
    assert all(torch.equal(x, torch.ones_like(x))
               for x in tree_mod.leaves(ts.mu))
    assert tree_mod.leaves_with_path(ts.nu)[0][0] == "embed"


# ---------------------------------------------------------------------------
# loss, gradients, train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_equal_repro(jparams, masked):
    b = _batch(masked=masked)
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p, x: jtf.loss_fn(p, J_TINY, x), has_aux=True))(
            jparams, jax.tree.map(jnp.asarray, b))
    loss, aux, grads = tstep._value_and_grad(tstep.make_loss_fn(TINY),
                                             _to_port(jparams),
                                             _torch_batch(b))
    np.testing.assert_allclose(float(loss), float(jl), rtol=LOSS_RTOL)
    assert float(aux["tokens"]) == float(jaux["tokens"])
    for (path, a), w in zip(tree_mod.leaves_with_path(grads),
                            tree_mod.leaves(_to_port(jg))):
        err = float((a - w).abs().max() / w.abs().max())
        assert err <= GRAD_RTOL, (path, err)


def test_loss_fn_remat_changes_nothing(jparams):
    """Remat (``torch.utils.checkpoint`` around each layer) gives the same
    loss and gradients as no remat, bit for bit, and no grad under
    ``no_grad``."""
    import dataclasses
    b = _torch_batch(_batch())
    out = []
    for cfg in (TINY, dataclasses.replace(TINY, remat=False)):
        out.append(tstep._value_and_grad(tstep.make_loss_fn(cfg),
                                         _to_port(jparams), b))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(tree_mod.leaves(out[0][2]), tree_mod.leaves(out[1][2])):
        assert torch.equal(a, c)
    with torch.no_grad():
        loss, _ = ttf.loss_fn(_to_port(jparams), TINY, b)
    assert torch.equal(loss, out[0][0]) and loss.grad_fn is None


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_repro(jparams, microbatches):
    b = _batch()
    opt = dict(peak_lr=1e-3, total_steps=10)
    jfn = jax.jit(jstep.make_train_step(
        J_TINY, jadamw.OptimizerConfig(**opt), microbatches=microbatches))
    jp, _, jm = jfn(jparams, jadamw.init(jparams),
                    jax.tree.map(jnp.asarray, b))
    tp0 = _to_port(jparams)
    tfn = tstep.make_train_step(TINY, adamw.OptimizerConfig(**opt),
                                microbatches=microbatches)
    tp, ts, tm = tfn(tp0, adamw.init(tp0), _torch_batch(b))
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert float(tm["lr"]) == float(jm["lr"]) and int(ts.step) == 1
    _, _, grads = tstep._value_and_grad(tstep.make_loss_fn(TINY), tp0,
                                        _torch_batch(b))
    _assert_params_close(tp, _to_port(jp), grads, float(jm["lr"]))
    assert torch.equal(tp0["embed"], _to_port(jparams)["embed"])


# ---------------------------------------------------------------------------
# the trainer against repro's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def repro_fit(jparams, tmp_path_factory):
    """``repro``'s Trainer: 6 steps, every step logged, a checkpoint at
    step 3 (its restored state is what the port carries across)."""
    d = str(tmp_path_factory.mktemp("jckpt"))
    data = jpipe.SyntheticLM(vocab=TINY.vocab, seq_len=16, global_batch=4)
    tr = JTrainer(J_TINY, jadamw.OptimizerConfig(**OPT_KW),
                  JTrainerConfig(steps=6, ckpt_every=3, ckpt_dir=d,
                                 log_every=1))
    final, _ = tr.fit(data)
    trees, _ = JCheckpointManager(d).restore(
        3, {"params": jparams, "opt": jadamw.init(jparams)})
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    return tr.metrics_log, final, trees


def _port_trainer(monkeypatch, params, state, **kw):
    tr = Trainer(TINY, adamw.OptimizerConfig(**OPT_KW),
                 TrainerConfig(steps=6, log_every=1, device="cpu", **kw))
    monkeypatch.setattr(tr, "init_state", lambda: (params, state))
    return tr


def _lr_total(log, first=0):
    return sum(r["lr"] for r in log if r["step"] >= first)


def test_trainer_fit_equals_repro(monkeypatch, jparams, repro_fit):
    jlog, jfinal, _ = repro_fit
    p0 = _to_port(jparams)
    tr = _port_trainer(monkeypatch, p0, adamw.init(p0))
    params, state = tr.fit(tpipe.SyntheticLM(vocab=TINY.vocab, seq_len=16,
                                             global_batch=4))
    assert [r["step"] for r in tr.metrics_log] == [r["step"] for r in jlog]
    for a, b in zip(tr.metrics_log, jlog):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=LR_RTOL)
    assert int(state.step) == 6
    _, _, grads = tstep._value_and_grad(tstep.make_loss_fn(TINY), p0,
                                        _torch_batch(_batch()))
    _assert_params_close(params, _to_port(jfinal), grads, _lr_total(jlog))


def test_repro_state_carried_across_midway(monkeypatch, repro_fit):
    """``repro``'s state after 3 steps (from its checkpoint) carried
    across, then 3 more steps on the port: equal to ``repro``'s own
    steps 3-5."""
    jlog, jfinal, trees = repro_fit
    p3 = ttf.params_from_numpy(TINY, _np_tree(trees["params"]), device="cpu")
    s3 = adamw.state_from_numpy(TINY, _np_tree(trees["opt"]), device="cpu")
    assert int(s3.step) == 3
    tr = _port_trainer(monkeypatch, p3, s3)
    data = tpipe.SyntheticLM(vocab=TINY.vocab, seq_len=16, global_batch=4)
    params, state = tr.fit(data, start_step=3)
    assert [r["step"] for r in tr.metrics_log] == [3, 4, 5]
    for a, b in zip(tr.metrics_log, jlog[3:]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(a["lr"], b["lr"], rtol=LR_RTOL)
    assert int(state.step) == 6
    _, _, grads = tstep._value_and_grad(
        tstep.make_loss_fn(TINY), p3,
        _torch_batch(data.batch_at(3)))
    _assert_params_close(params, _to_port(jfinal), grads,
                         _lr_total(jlog, first=3))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_synthetic_lm_equals_repro(host):
    kw = dict(vocab=300, seq_len=24, global_batch=6, seed=3,
              host_index=host[0], num_hosts=host[1])
    a, b = tpipe.SyntheticLM(**kw), jpipe.SyntheticLM(**kw)
    for step in (0, 1, 17):
        for key in ("tokens", "labels"):
            got, want = a.batch_at(step)[key], b.batch_at(step)[key]
            assert got.dtype == want.dtype
            assert got.tobytes() == want.tobytes()


def test_path_corpus_equals_repro():
    kw = dict(k=4, seq_len=16, global_batch=4)
    a = tpipe.PathCorpus(graph=power_law(200, 5.0, seed=4), device="cpu",
                         **kw)
    b = jpipe.PathCorpus(graph=jpower_law(200, 5.0, seed=4), **kw)
    assert a.vocab == b.vocab and a.engine.backend == "device"
    for step in range(3):
        for key in ("tokens", "labels"):
            got, want = a.batch_at(step)[key], b.batch_at(step)[key]
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()


def test_frontend_stub_equals_repro():
    a = tpipe.make_frontend_stub(np.random.default_rng(5), 2, 3, 8)
    b = jpipe.make_frontend_stub(np.random.default_rng(5), 2, 3, 8)
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (tpipe.BOS, tpipe.EOS, tpipe.SEP, tpipe.VERTEX_OFFSET) == (
        jpipe.BOS, jpipe.EOS, jpipe.SEP, jpipe.VERTEX_OFFSET)


# ---------------------------------------------------------------------------
# the port's mirrors of tests/test_training.py
# ---------------------------------------------------------------------------

def _cpu(**kw):
    return TrainerConfig(device="cpu", **kw)


def test_loss_decreases():
    data = tpipe.SyntheticLM(vocab=TINY.vocab, seq_len=32, global_batch=4)
    opt = adamw.OptimizerConfig(peak_lr=1e-3, warmup_steps=3, total_steps=25)
    tr = Trainer(TINY, opt, _cpu(steps=25, log_every=5))
    tr.fit(data)
    assert tr.metrics_log[-1]["loss"] < tr.metrics_log[0]["loss"]


def test_checkpoint_roundtrip_and_restart(tmp_path):
    data = tpipe.SyntheticLM(vocab=TINY.vocab, seq_len=16, global_batch=2)
    opt = adamw.OptimizerConfig(peak_lr=1e-3, total_steps=12)
    d = str(tmp_path / "ckpt")

    tr1 = Trainer(TINY, opt, _cpu(steps=6, ckpt_every=3, ckpt_dir=d,
                                  log_every=1))
    p1, o1 = tr1.fit(data)
    mgr = CheckpointManager(d)
    assert mgr.latest_step() == 6
    trees, manifest = mgr.restore(6, {"params": p1, "opt": o1})
    for a, b in zip(tree_mod.leaves(trees), tree_mod.leaves(
            {"params": p1, "opt": o1})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert manifest["extra"] == {"data_step": 6, "final": True}

    # restart continues from step 6 and reaches 12
    tr2 = Trainer(TINY, opt, _cpu(steps=12, ckpt_every=3, ckpt_dir=d,
                                  log_every=1))
    p2, o2 = tr2.fit(data)
    assert tr2.metrics_log[0]["step"] == 6  # resumed, not restarted
    assert mgr.latest_step() == 12

    # an uninterrupted 12-step run equals the restart bit for bit
    tr3 = Trainer(TINY, opt, _cpu(steps=12, log_every=1))
    p3, o3 = tr3.fit(data)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    for a, b in zip(tree_mod.leaves((p2, o2)), tree_mod.leaves((p3, o3))):
        assert torch.equal(a, b)


def test_checkpoint_retention_and_manifest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": np.arange(5), "b": {"c": np.ones((2, 2))},
            "t": [torch.arange(3, dtype=torch.int32)]}
    for s in (1, 2, 3):
        mgr.save(s, {"state": tree}, extra={"data_step": s})
    assert mgr.all_steps() == [2, 3]
    restored, manifest = mgr.restore(3, {"state": tree})
    np.testing.assert_array_equal(restored["state"]["a"], tree["a"])
    assert torch.equal(restored["state"]["t"][0], tree["t"][0])
    assert manifest["step"] == 3 and manifest["trees"] == ["state"]
    assert manifest["extra"]["data_step"] == 3
    with np.load(tmp_path / "step-0000000003" / "state.npz") as z:
        assert sorted(z.files) == ["a", "b/c", "t/0"]


def test_checkpoint_bfloat16_and_state_round_trip(tmp_path):
    """bfloat16 leaves go through their int16 view bit for bit (NaN and
    inf included); an ``AdamWState`` keys its fields by name."""
    x = torch.randn(5, 3).to(torch.bfloat16)
    x[0, 0], x[1, 1] = float("nan"), float("inf")
    params = {"w": x, "n": torch.zeros(3)}
    state = adamw.init(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"params": params, "opt": state})
    with np.load(tmp_path / "step-0000000001" / "opt.npz") as z:
        assert sorted(z.files) == ["mu/n", "mu/w", "nu/n", "nu/w", "step"]
    with np.load(tmp_path / "step-0000000001" / "params.npz") as z:
        assert z["w"].dtype == np.int16
    got, _ = mgr.restore(1, {"params": params, "opt": state})
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       x.view(torch.int16))
    assert isinstance(got["opt"], adamw.AdamWState)
    assert got["opt"].step.dtype == torch.int32


def test_emergency_save_handler(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    saved = {}
    mgr.install_signal_handler(lambda: saved.setdefault("hit", True))
    try:
        with pytest.raises(SystemExit) as exc:
            signal.raise_signal(signal.SIGTERM)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert saved.get("hit") and exc.value.code == 128 + signal.SIGTERM


def test_microbatch_accumulation_matches_full_batch():
    params = ttf.init_params(TINY, 0, device="cpu")
    opt = adamw.OptimizerConfig(peak_lr=1e-3, total_steps=10)
    batch = _torch_batch(tpipe.SyntheticLM(
        vocab=TINY.vocab, seq_len=16, global_batch=4).batch_at(0))
    st = adamw.init(params)
    p1, _, m1 = tstep.make_train_step(TINY, opt, microbatches=1)(
        params, st, batch)
    p2, _, m2 = tstep.make_train_step(TINY, opt, microbatches=2,
                                      unroll_accum=True)(params, st, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(tree_mod.leaves(p1), tree_mod.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


def test_path_corpus_batches_are_valid():
    pc = tpipe.PathCorpus(graph=power_law(200, 5.0, seed=4), k=4, seq_len=16,
                          global_batch=4, device="cpu")
    b = pc.batch_at(0)
    assert b["tokens"].shape == (4, 16)
    assert b["tokens"].min() >= 0
    assert b["tokens"].max() < pc.vocab
    assert (b["labels"] >= -1).all()


def test_data_stream_deterministic_restart():
    d1 = tpipe.SyntheticLM(vocab=64, seq_len=8, global_batch=2, seed=9)
    d2 = tpipe.SyntheticLM(vocab=64, seq_len=8, global_batch=2, seed=9)
    np.testing.assert_array_equal(d1.batch_at(7)["tokens"],
                                  d2.batch_at(7)["tokens"])


def test_cosine_schedule_shape():
    opt = adamw.OptimizerConfig(peak_lr=1.0, warmup_steps=10,
                                total_steps=100, min_lr_ratio=0.1)
    lrs = [float(adamw.cosine_schedule(opt, torch.tensor(s)))
           for s in (0, 5, 10, 50, 100)]
    assert lrs[0] < lrs[1] < lrs[2]
    assert abs(lrs[2] - 1.0) < 1e-6
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 0.1) < 1e-2


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launch_train_runs_reduced_preset(tmp_path, capsys):
    import json
    out = tmp_path / "m.json"
    train_main(["--preset", "reduced", "--arch", "llama3p2_1b", "--steps",
                "3", "--batch", "2", "--seq", "16", "--device", "cpu",
                "--metrics-out", str(out)])
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("arch=llama3p2_1b params=")
    rec = json.loads(out.read_text())
    assert [r["step"] for r in rec["log"]] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) for r in rec["log"])
    cfg = get_arch("llama3p2_1b").reduced()
    assert rec["params"] == sum(x.numel() for x in tree_mod.leaves(
        ttf.init_params(cfg, 0, device="cpu")))
