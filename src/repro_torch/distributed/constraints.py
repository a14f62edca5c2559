"""Activation sharding constraints (the port of
``repro.distributed.constraints``).

``constrain(x, builder)`` lays x out on the *ambient* mesh, set by
``use_mesh(mesh)`` (a ``contextvars.ContextVar``: ``repro``'s
``compat.set_mesh``).  Outside any mesh it returns x as it is, so model
code calls it unconditionally.  Inside one, x must be a DTensor and is
redistributed to ``placements(builder(rules, x.shape), mesh)``; a plain
tensor raises, since it is an input that was never distributed.
Builders get a ``ShardingRules``, so every axis choice inherits the
divisibility fallbacks.

``use_mesh`` also turns on DTensor's implicit replication: tensors the
model makes itself (positions, masks, aranges, the SSD's triangles, MoE's
index tensors) join DTensor operations as replicated.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, Tuple

import torch

from .sharding import P, ShardingRules, placements

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                      default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """The ambient mesh for ``constrain`` inside the block (``None``
    clears it)."""
    token = _MESH.set(mesh)
    try:
        if mesh is None:
            yield mesh
        else:
            with _implicitly_replicated():
                yield mesh
    finally:
        _MESH.reset(token)


@contextlib.contextmanager
def _implicitly_replicated():
    """DTensor's ``implicit_replication``, restoring the setting it
    found: that context manager turns it off on exit, which would end an
    enclosing block's too (a layer's recompute in the backward nests
    ``use_mesh``)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def current_mesh():
    """The ambient mesh, or None."""
    return _MESH.get()


def current_rules() -> Optional[ShardingRules]:
    mesh = _MESH.get()
    return None if mesh is None else ShardingRules(mesh)


def constrain(x: torch.Tensor,
              builder: Callable[[ShardingRules, Tuple[int, ...]], P]):
    """x laid out by ``builder``'s spec on the ambient mesh; x itself
    outside a mesh."""
    rules = current_rules()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain: a plain {tuple(x.shape)} tensor inside a mesh; "
            f"the inputs were never distributed (sharding.distribute_tree)")
    spec = builder(rules, tuple(x.shape))
    return x.redistribute(rules.mesh, placements(spec, rules.mesh))


# -- common builders ---------------------------------------------------------

def act_bsd(rules: ShardingRules, shape) -> P:
    """(B, S, D) layer-boundary activation: batch over the dp group."""
    return P(rules.dp(shape[0]), None, None)


def act_bsd_sp(rules: ShardingRules, shape) -> P:
    """(B, S, D) residual with sequence parallelism: seq over model."""
    return P(rules.dp(shape[0]), rules.tp(shape[1]), None)


def act_bsf(rules: ShardingRules, shape) -> P:
    """(B, S, F) projected activation: batch over dp, features over
    model."""
    return P(rules.dp(shape[0]), None, rules.tp(shape[-1]))


def act_tokens_f(rules: ShardingRules, shape) -> P:
    """(T, F) flattened-token activation (MoE router / dispatch)."""
    return P(rules.dp(shape[0]), rules.tp(shape[-1]))


def moe_slots(rules: ShardingRules, shape) -> P:
    """(E, cap, D) expert dispatch slots: experts over model (EP)."""
    return P(rules.tp(shape[0]), None, None)


def ssd_intra(rules: ShardingRules, shape) -> P:
    """(B, nc, Q, Q, H) SSD intra-chunk tensors: heads over model."""
    return P(rules.dp(shape[0]), None, None, None, rules.tp(shape[-1]))


def logits_bsv(rules: ShardingRules, shape) -> P:
    """(B, S, V) LM logits: batch over dp, vocab over model."""
    return P(rules.dp(shape[0]), None, rules.tp(shape[-1]))


def act_heads(rules: ShardingRules, shape) -> P:
    """(B, L, H, hd): heads over model, else sequence, else batch only
    (H ∈ {36, 40} does not divide a 16-way model axis: those archs run
    sequence-parallel attention)."""
    b, l, h, hd = shape
    if rules.tp(h):
        return P(rules.dp(b), None, rules.tp(h), None)
    if rules.tp(l):
        return P(rules.dp(b), rules.tp(l), None, None)
    return P(rules.dp(b), None, None, None)


def logits_bhqk(rules: ShardingRules, shape) -> P:
    """(B, H, Q, K) attention logits: the same head/seq fallback."""
    b, h, q, k = shape
    if rules.tp(h):
        return P(rules.dp(b), rules.tp(h), None, None)
    if rules.tp(q):
        return P(rules.dp(b), None, rules.tp(q), None)
    return P(rules.dp(b), None, None, None)


def tokens_d(rules: ShardingRules, shape) -> P:
    """(T, D) MoE combine output: tokens over dp (``repro``'s inline
    builder in ``moe_ffn``)."""
    return P(rules.dp(shape[0]), None)
