"""Gradient compression: int8 quantization with error feedback (the port
of ``repro.distributed.compression``).

Quantizing a gradient to int8 with a per-tensor scale cuts the bytes a
data-parallel reduction carries, and the error-feedback residual keeps
SGD unbiased in the long run (the EF-SGD recipe).  ``quantize``,
``dequantize`` and ``quantize_with_feedback`` are ``repro``'s arithmetic
in float32, bit for bit.

``compressed_all_reduce`` is the counterpart of ``compressed_psum_tree``:
a grid shared across the ranks (the MAX all-reduce of each rank's
``max|x| / 127 + 1e-12``), each rank's values rounded onto it in
[-127, 127], an exact integer sum, then dequantized.  ``repro`` carries
the sum in int16, which holds up to 257 ranks' contributions exactly.
Neither NCCL nor gloo reduces int16 (NCCL has no such type; gloo
refuses it), so the port carries int32: the same exact sums and the same
dequantized results, on a wire twice the size of ``repro``'s.  A
narrower wire (for example two offset-binary 16-bit lanes in an int32:
``q + 127 <= 254`` summed over at most 257 ranks stays below 2^16) is
later work (ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from .. import tree as tree_mod
from .wire import ReduceOp, Wire


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)``: int8 values in [-127, 127] (round half to even)
    and the float32 scale ``max|x| / 127 + 1e-12``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The float32 values ``q`` stands for on the grid ``scale``."""
    return q.to(torch.float32) * scale


def quantize_with_feedback(x: torch.Tensor, residual: torch.Tensor):
    """Error feedback: quantize ``x + residual`` and return ``(q, scale,
    new_residual)``, the part the grid could not hold."""
    target = x + residual
    q, scale = quantize(target)
    return q, scale, target - dequantize(q, scale)


def compressed_all_reduce(tree, group: dist.ProcessGroup):
    """The sum over ``group`` of a tree (dicts, lists, tuples) of float32
    tensors, each carried as int8 values on a grid shared by the ranks.

    Every rank passes its own tree of the same structure and shapes and
    gets the same summed tree back.
    """
    wire = Wire(group)

    def one(x: torch.Tensor) -> torch.Tensor:
        scale = wire.all_reduce((x.abs().max() / 127.0 + 1e-12).reshape(1),
                                ReduceOp.MAX)[0]
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int32)
        return wire.all_reduce(q, ReduceOp.SUM).to(torch.float32) * scale

    return tree_mod.tree_map(one, tree)


def make_compressed_grad_fn(loss_fn: Callable, group: dist.ProcessGroup):
    """Data-parallel loss and gradient with the int8-compressed reduction.

    ``loss_fn(params, batch) -> (loss, aux)``.  Returns ``f(params,
    batch) -> (loss, grads)``: ``params`` is the same tree of tensors on
    every rank of ``group``, ``batch`` this rank's shard of the batch
    (its slice of the leading dim).  The local gradient comes from
    ``torch.autograd.grad`` on copies of ``params`` (the caller's tensors
    are not touched); the loss is averaged over the group, and the
    gradients, divided by the group's size, are summed by
    ``compressed_all_reduce``, so every rank gets the same mean.
    """
    def f(params, batch):
        wire = Wire(group)
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_mod.leaves(params)]
        loss, _aux = loss_fn(tree_mod.unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        loss = wire.all_reduce(loss.detach().reshape(1).clone(),
                               ReduceOp.SUM)[0] / wire.size
        grads = [g / wire.size for g in grads]
        return loss, compressed_all_reduce(
            tree_mod.unflatten(params, grads), group)

    return f
