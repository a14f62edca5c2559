"""Every registry arch trains on the port as on ``repro``, part two
(part one: tests/test_torch_train_families.py): qwen3-moe, mamba2 (ssm),
recurrentgemma (hybrid) and its 5-layer tailed cut, and the SSD repair.

The SSD repair (ROADMAP.md §3): ``repro``'s intra-chunk decay is
``where(tri, exp(decay), 0)``.  Its upper triangle's exp overflows to
inf once a chunk's summed dt passes 88.7, and the where's backward sends
0 · inf = NaN through exp.  The port masks the exponent
(``ssm._masked_decay``).  On mamba2's ``reduced()`` with chunks of 128
and every ``dt_bias`` 1.0 (softplus ≈ 1.31, 127 × 1.31 ≈ 166), one
sequence of 128 tokens: ``repro``'s gradients hold NaN, the port's are
finite, the losses agree (``tp.LOSS_RTOL``), and ``ssd_forward`` equals
the old expression's bit for bit.  The RG-LRU's ``clamp`` under a sqrt
has a zero gradient where it clamps, not a NaN: checked with the gates
saturated.  Cases and tolerances: tests/torch_train_parity.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch import tree as tree_mod
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.training import step as tstep

import torch_train_parity as tp

ARCHS = ["qwen3_moe_30b_a3b", "mamba2_780m", "recurrentgemma_9b", tp.TAILED]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread per process keeps
    parallel test workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("case", ARCHS)
def test_train_step_equals_repro(case):
    """Loss (moe aux included), every gradient and one AdamW step."""
    tp.check_case(case)


def _old_masked_decay(decay, keep):
    """``repro``'s expression, the port's before the repair."""
    return torch.where(keep, torch.exp(decay), 0.0)


@pytest.fixture(scope="module")
def ssd_failing_input():
    """(repro cfg, port cfg, repro params, port params, batch): the
    failing input of the module docstring."""
    jcfg, tcfg = tp.cfgs("mamba2_780m")
    jcfg = dataclasses.replace(jcfg, ssm_chunk=128)
    tcfg = dataclasses.replace(tcfg, ssm_chunk=128)
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    ssm = jparams["supers"]["b0_ssm"]["ssm"]
    ssm["dt_bias"] = jnp.ones_like(ssm["dt_bias"])
    tparams = ttf.params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams),
                                    device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (1, 128),
                                             dtype=np.int32)
    return jcfg, tcfg, jparams, tparams, {"tokens": toks, "labels": toks}


def test_ssd_gradients_finite_where_repro_is_nan(ssd_failing_input,
                                                 monkeypatch):
    jcfg, tcfg, jparams, tparams, batch = ssd_failing_input
    assert all(float(b["ssm"]["dt_bias"].min()) == 1.0
               for b in tparams["layers"])
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    assert any(np.isnan(np.asarray(g)).any() for g in jax.tree.leaves(jg))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _, grads = tstep._value_and_grad(tstep.make_loss_fn(tcfg), tparams,
                                           tb)
    np.testing.assert_allclose(float(loss), float(jl), rtol=tp.LOSS_RTOL)
    assert all(torch.isfinite(g).all() for g in tree_mod.leaves(grads))
    # the old expression gives the same loss and repro's NaN
    monkeypatch.setattr(tssm, "_masked_decay", _old_masked_decay)
    old_loss, _, old_grads = tstep._value_and_grad(
        tstep.make_loss_fn(tcfg), tparams, tb)
    assert torch.equal(old_loss, loss)
    assert any(torch.isnan(g).any() for g in tree_mod.leaves(old_grads))


@pytest.mark.parametrize("chunk", [16, 128])
def test_ssd_forward_bit_identical_to_old_expression(ssd_failing_input,
                                                     monkeypatch, chunk):
    _, tcfg, _, tparams, _ = ssd_failing_input
    cfg = dataclasses.replace(tcfg, ssm_chunk=chunk)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 128, cfg.d_model)).astype(np.float32))
    blk = tparams["layers"][0]["ssm"]
    new = tssm.ssd_forward(blk, x, cfg)
    monkeypatch.setattr(tssm, "_masked_decay", _old_masked_decay)
    assert torch.equal(tssm.ssd_forward(blk, x, cfg), new)
    assert torch.isfinite(new).all()


def test_rglru_saturated_gates_give_finite_gradients():
    """``lam`` at -30 (softplus ≈ 1e-13) puts 1 - a² under the clamp's
    1e-12 floor: the clamp's gradient is 0 there, and every gradient
    stays finite."""
    _, tcfg = tp.cfgs("recurrentgemma_9b")
    params = ttf.init_params(tcfg, 0, device="cpu")
    for blk in params["layers"]:
        if "rec" in blk:
            blk["rec"]["lam"] = torch.full_like(blk["rec"]["lam"], -30.0)
    batch = {k: torch.from_numpy(v) for k, v in tp.make_batch(tcfg).items()}
    loss, _, grads = tstep._value_and_grad(tstep.make_loss_fn(tcfg), params,
                                           batch)
    assert torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for g in tree_mod.leaves(grads))
    lam = [g["rec"]["lam"] for g in grads["layers"] if "rec" in g]
    assert lam and all(float(x.abs().max()) < 1e-6 for x in lam)
