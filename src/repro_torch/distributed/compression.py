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
refuses it), so the port carries two 16-bit lanes in each int32
(``pack_lanes``): element 2i in the low lane, offset-binary (q + 127 in
[0, 254]), and element 2i + 1 in the high lane, signed.  Over R <= 257
ranks the low lanes sum to at most 254 R < 2^16, so they never carry
into the high lane, and every partial sum, in any order a backend
reduces, lies in [-127 * 2^16 * R, (127 * 2^16 + 254) * R], inside
int32 (``unpack_lanes`` takes the lanes apart again).  The wire is
4 ceil(numel / 2) bytes a leaf, ``repro``'s 2 numel and 2 more bytes
when numel is odd, plus the scale's 4.  A group of more than 257 ranks
raises ``ValueError``, where ``repro``'s int16 sum would overflow
silently.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

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


#: The most ranks whose [-127, 127] values sum exactly in ``repro``'s
#: int16 (127 * 257 < 2^15), and whose offset-binary low lanes stay
#: below 2^16 (254 * 257 < 2^16).
MAX_RANKS = 257
_LANE = 1 << 16


def pack_lanes(q: torch.Tensor) -> torch.Tensor:
    """int32 ``q`` in [-127, 127], flattened and padded with one zero to an
    even length, as ``(ceil(numel / 2),)`` int32: ``(q[2i] + 127) +
    q[2i + 1] * 2^16``."""
    flat = q.reshape(-1).to(torch.int32)
    if flat.numel() % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    return (flat[0::2] + 127) + flat[1::2] * _LANE


def unpack_lanes(total: torch.Tensor, numel: int,
                 ranks: int) -> torch.Tensor:
    """The ``(numel,)`` int32 sums of the values ``ranks`` ranks packed,
    from the sum ``total`` of their ``pack_lanes`` words."""
    lo = total & (_LANE - 1)
    hi = (total - lo) >> 16        # exact: total - lo is a multiple of 2^16
    return torch.stack([lo - 127 * ranks, hi], 1).reshape(-1)[:numel]


def compressed_all_reduce(tree, group: dist.ProcessGroup,
                          wire: Optional[Wire] = None):
    """The sum over ``group`` of a tree (dicts, lists, tuples) of float32
    tensors, each carried as int8 values on a grid shared by the ranks,
    two to an int32 on the wire.

    Every rank passes its own tree of the same structure and shapes and
    gets the same summed tree back.  ``wire`` (a ``Wire`` over ``group``,
    a new one by default) carries the collectives, so its ``counts()``
    show each leaf's 4-byte scale and ``4 ceil(numel / 2)`` bytes of
    lanes.  Raises ``ValueError`` on a group of more than 257 ranks.
    """
    wire = wire or Wire(group)
    if wire.size > MAX_RANKS:
        raise ValueError(f"{wire.size} ranks: the compressed sum is exact "
                         f"for at most {MAX_RANKS}")

    def one(x: torch.Tensor) -> torch.Tensor:
        scale = wire.all_reduce((x.abs().max() / 127.0 + 1e-12).reshape(1),
                                ReduceOp.MAX)[0]
        q = torch.clamp(torch.round(x / scale), -127, 127)
        total = wire.all_reduce(pack_lanes(q), ReduceOp.SUM)
        return unpack_lanes(total, x.numel(), wire.size).reshape(
            x.shape).to(torch.float32) * scale

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
