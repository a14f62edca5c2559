"""Train, serve and prefill step factories (the port of
``repro.training.step``).

``make_train_step`` builds the update: loss -> gradients -> AdamW, with
optional gradient accumulation over microbatches (float32 gradient sums
over ``B / microbatches`` slices of the batch, a Python loop where
``repro`` scans: peak activation memory scales with B / microbatches
while the arithmetic is unchanged).  Gradients come from
``torch.autograd.grad`` on ``detach().requires_grad_(True)`` views of
the parameters, so the caller's tensors are never touched.

On a mesh (every parameter, state and batch leaf a DTensor, the step
called under ``distributed.constraints.use_mesh``) each gradient is put
back on its parameter's placements with ``redistribute`` before AdamW
sees it (``repro``'s ``out_shardings``: autograd returns a gradient
``Partial`` over the mesh dims its reduction spans), the microbatch
sums start from zeros on those placements, and the metrics come back
as plain (full, replicated) tensors.

``make_serve_step`` builds the single-token decode step used by the
serving engine: greedy (``argmax``) at temperature 0, else a sample from
``softmax(logits / temperature)`` drawn with ``torch.multinomial`` on the
caller's ``torch.Generator`` (its bits are not ``jax.random``'s).
``make_prefill`` wraps ``transformer.prefill`` (the batch's
``prefix_emb`` goes through with it).  Both pass ``impl`` down to the
attention layers (None: the kernels on a CUDA device, the plain path on
the CPU).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from .. import tree as tree_mod
from ..configs.base import ArchConfig
from ..distributed.sharding import replicate
from ..models import transformer
from ..optim import adamw


def make_loss_fn(cfg: ArchConfig) -> Callable:
    """``loss(params, batch)`` -> ``(loss, {"loss", "tokens"})``, as
    ``transformer.loss_fn``."""
    def loss(params, batch):
        return transformer.loss_fn(params, cfg, batch)
    return loss


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient on its parameter's placements (no-op off a mesh)."""
    if isinstance(p, DTensor):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _plain(x):
    """A metric as a plain tensor: a DTensor's full value."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def _value_and_grad(loss_fn: Callable, params, batch):
    """(loss, metrics, gradients in the parameters' tree, each on its
    parameter's placements), the loss and metrics detached."""
    leaves = [p.detach().requires_grad_(True)
              for p in tree_mod.leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_mod.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    grads = [_placed_like(g, p) for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_mod.unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.OptimizerConfig,
                    microbatches: int = 1,
                    unroll_accum: bool = False) -> Callable:
    """``train_step(params, opt_state, batch)`` -> (new params, new
    state, metrics): ``{"loss", "tokens", "lr", "grad_norm"}`` with one
    microbatch, ``{"loss", "lr", "grad_norm"}`` with more, as ``repro``.
    ``unroll_accum`` is ``repro``'s switch between its scan and a Python
    loop; the port has only the loop, so both give the same result."""
    del unroll_accum
    loss_fn = make_loss_fn(cfg)

    def train_step(params, opt_state, batch):
        if microbatches <= 1:
            loss, metrics, grads = _value_and_grad(loss_fn, params, batch)
        else:
            mbs = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                + tuple(v.shape[1:]))
                   for k, v in batch.items()}
            gsum = [torch.zeros_like(p, dtype=torch.float32)
                    for p in tree_mod.leaves(params)]
            lsum = None
            for i in range(microbatches):
                l, _, g = _value_and_grad(loss_fn, params,
                                          {k: v[i] for k, v in mbs.items()})
                gsum = [a + b.to(torch.float32)
                        for a, b in zip(gsum, tree_mod.leaves(g))]
                lsum = l if lsum is None else lsum + l
            grads = tree_mod.unflatten(params,
                                       [g / microbatches for g in gsum])
            loss = lsum / microbatches
            metrics = {"loss": loss}

        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, grads, opt_state, params)
        metrics = {k: _plain(v) for k, v in
                   {**metrics, **opt_metrics, "loss": loss}.items()}
        return new_params, new_opt, metrics

    return train_step


def make_serve_step(cfg: ArchConfig, temperature: float = 0.0, *,
                    impl: Optional[str] = None) -> Callable:
    """``serve_step(params, token, cache, cache_len, generator, commit)``
    -> (next tokens (B,) int32, cache, logits (B, V)); ``commit`` goes to
    ``transformer.decode_step``."""
    @torch.no_grad()
    def serve_step(params, token, cache, cache_len,
                   generator: Optional[torch.Generator] = None,
                   commit: Optional[torch.Tensor] = None):
        logits, cache = transformer.decode_step(params, cfg, token, cache,
                                                cache_len, impl=impl,
                                                commit=commit)
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            # DTensor logits: every rank takes the argmax of the whole row
            nxt = torch.argmax(replicate(logits), dim=-1)
        return nxt.to(torch.int32), cache, logits
    return serve_step


def make_prefill(cfg: ArchConfig, *, impl: Optional[str] = None) -> Callable:
    """``prefill_step(params, batch)`` -> (last-position logits, cache,
    lengths), as ``transformer.prefill``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(params, cfg, batch, impl=impl)
    return prefill_step
