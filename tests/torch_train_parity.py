"""Shared cases of tests/test_torch_train_{families,recurrent}.py: one
train step of every registry arch's ``reduced()`` (and a tailed hybrid)
on the port against ``repro``.

``repro``'s side is one jitted function per case (loss, aux and
gradients by ``jax.value_and_grad``, and one ``make_train_step`` step
from a fresh AdamW state), compiled once; the port runs
``training.step._value_and_grad`` and ``make_train_step`` on the same
parameters (carried across by ``params_from_numpy``) and the same numpy
batch.

Tolerances (measured on these cases first, then set with room):
- loss within ``LOSS_RTOL`` relative and ``tokens`` equal;
- every gradient leaf within ``GRAD_RTOL`` of its largest entry: XLA:CPU
  and torch's CPU matmuls sum in other orders in float32, through up to
  five layers (tests/test_torch_families.py holds logits to 1e-4);
- the updated parameters under tests/test_torch_training.py's rule
  (``assert_params_close``): within 1e-2 of the step's learning rate
  where the reference gradient is at least ``G_FLOOR`` of its leaf's
  largest, and within the update's own size (3 lr) elsewhere.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.training import step as jstep
from repro_torch import configs as tconfigs
from repro_torch import tree as tree_mod
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw
from repro_torch.training import step as tstep

TAILED = "recurrentgemma_9b_tail"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
G_FLOOR = 1e-3
OPT_KW = dict(total_steps=10)


def cfgs(case):
    """(repro's config, the port's) for a case id: a registry arch's
    ``reduced()``, or ``TAILED`` (recurrentgemma's with 5 layers: (rec,
    rec, attn) once, then a (rec, rec) tail)."""
    arch = TAILED.rsplit("_", 1)[0] if case == TAILED else case
    j, t = jconfigs.get_arch(arch).reduced(), tconfigs.get_arch(arch).reduced()
    if case == TAILED:
        j = dataclasses.replace(j, num_layers=5)
        t = dataclasses.replace(t, num_layers=5)
    return j, t


def make_batch(cfg, B=2, S=32, seed=0):
    """Tokens, next-token labels with a few masked (-1) positions, and
    the prefix for vlm and audio, from numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    labels = toks.copy()
    labels[0, S - 5:] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.frontend != "none":
        batch["prefix_emb"] = (rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def repro_side(jcfg, jparams, batch):
    """(loss, aux, grads, params after one step, its metrics), numpy."""
    ts = jstep.make_train_step(jcfg, jadamw.OptimizerConfig(**OPT_KW))

    def both(p, b):
        (loss, aux), grads = jax.value_and_grad(
            lambda q: jtf.loss_fn(q, jcfg, b), has_aux=True)(p)
        p2, _, metrics = ts(p, jadamw.init(p), b)
        return loss, aux, grads, p2, metrics
    out = jax.jit(both)(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree.map(np.asarray, out)


def port_side(tcfg, tparams, batch):
    """The same five, from the port."""
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, aux, grads = tstep._value_and_grad(tstep.make_loss_fn(tcfg),
                                             tparams, tb)
    p2, state, metrics = tstep.make_train_step(
        tcfg, adamw.OptimizerConfig(**OPT_KW))(tparams, adamw.init(tparams),
                                               tb)
    return loss, aux, grads, p2, metrics


def assert_grads_close(got, want, rtol=GRAD_RTOL):
    """Each leaf of ``got`` within ``rtol`` of its largest entry in
    ``want`` (both in the port's layout)."""
    for (path, a), w in zip(tree_mod.leaves_with_path(got),
                            tree_mod.leaves(want)):
        assert torch.isfinite(a).all(), path
        scale = float(w.abs().max())
        err = float((a.double() - w.double()).abs().max())
        assert err <= rtol * scale + 1e-30, (path, err, scale)


def assert_params_close(got, want, grads, lr_total):
    """The rule of the module docstring, leaf by leaf."""
    for (path, a), b, g in zip(tree_mod.leaves_with_path(got),
                               tree_mod.leaves(want), tree_mod.leaves(grads)):
        a, b, g = a.double(), b.double(), g.double()
        diff = (a - b).abs()
        strong = g.abs() >= G_FLOOR * g.abs().max()
        slack = 1e-6 * float(b.abs().max())
        assert float(torch.where(strong, diff, 0).max()) \
            <= 1e-2 * lr_total + slack, path
        assert float(diff.max()) <= 3 * lr_total + slack, path


def check_case(case):
    """One train step of ``case`` on both packages, compared."""
    jcfg, tcfg = cfgs(case)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    to_port = lambda tree: ttf.params_from_numpy(  # noqa: E731
        tcfg, tree, device="cpu")
    tparams = to_port(jax.tree.map(np.asarray, jparams))
    batch = make_batch(tcfg)
    jl, jaux, jg, jp2, jm = repro_side(jcfg, jparams, batch)
    tl, taux, tg, tp2, tm = port_side(tcfg, tparams, batch)

    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    assert float(taux["tokens"]) == float(jaux["tokens"])
    want_grads = to_port(jg)
    assert_grads_close(tg, want_grads)
    assert set(tm) == set(jm)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    assert float(tm["lr"]) == float(jm["lr"])
    assert_params_close(tp2, to_port(jp2), want_grads, float(jm["lr"]))
    moved = any(not torch.equal(a, b) for a, b in zip(
        tree_mod.leaves(tparams), tree_mod.leaves(tp2)))
    assert moved
