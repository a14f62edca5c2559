"""Shared neural building blocks in plain PyTorch (the port of
``repro.models.layers``).

``swiglu`` pins its activations to the ambient mesh with ``repro``'s
sharding constraints (``distributed.constraints``); outside a mesh they
do nothing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import local_map

from ..distributed import constraints as con
from ..distributed.sharding import grad_placements, renumbered


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a ``1 + scale`` gain, cast back to x's type."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def take_rows(w: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``w[idx]``: rows of a 2-D w.  A DTensor w is gathered whole on
    every rank and the rows taken locally (``local_map``), the output
    split as idx is; each rank's gradient for w is then its part, summed
    over the mesh dims that split idx.  (DTensor's own strategies for
    the lookup's backward, an accumulating ``index_put``, and for a
    vocab-split ``embedding`` fail in some torch releases.)"""
    if not isinstance(w, DTensor):
        return w[idx]
    mesh = w.device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(idx, DTensor):
        idx = DTensor.from_local(idx, mesh, rep, run_check=False)
    ipl = list(idx.placements)
    return local_map(lambda w, i: w[i], out_placements=ipl,
                     in_placements=(rep, ipl),
                     in_grad_placements=(grad_placements(rep, ipl), ipl),
                     device_mesh=mesh, redistribute_inputs=True)(w, idx)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """The ``head_dim / 2`` rotary frequencies, float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate x (..., L, H, D) by positions (..., L), half-split layout."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs   # (..., L, D/2)
    cos = torch.cos(angles)[..., None, :]                 # (..., L, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _proj_spec(rules, shape):
    # (..., F): features over model, batch (leading dim) over dp
    lead = rules.dp(shape[0]) if len(shape) >= 2 else None
    mids = (None,) * max(len(shape) - 2, 0)
    return con.P(lead, *mids, rules.tp(shape[-1]))


def _out_spec(rules, shape):
    lead = rules.dp(shape[0]) if len(shape) >= 2 else None
    return con.P(lead, *((None,) * (len(shape) - 1)))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; weights (d_in, d_out)."""
    g = con.constrain(x @ w_gate, _proj_spec)
    u = con.constrain(x @ w_up, _proj_spec)
    return con.constrain((F.silu(g) * u) @ w_down, _out_spec)


def pad_seq(x: torch.Tensor, after: int) -> torch.Tensor:
    """x (B, L, C) with ``after`` zero rows appended along L; a DTensor
    padded on each rank's shard (``local_map``, the sequence whole):
    DTensor's own padding gives a malformed layout in some torch
    releases."""
    if not isinstance(x, DTensor):
        return F.pad(x, (0, 0, 0, after))
    pl = renumbered(x.placements, {0: 0, 2: 2})
    return local_map(lambda x: F.pad(x, (0, 0, 0, after)), out_placements=pl,
                     in_placements=(pl,), device_mesh=x.device_mesh,
                     redistribute_inputs=True)(x)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, L, C), w (C, W) -> (B, L, C) in x's
    type, ``out[l] = sum_i x[l - W + 1 + i] * w[:, i]`` with zeros before
    the start.  A loop over the W taps summed in float32, not
    ``F.conv1d``: cuDNN would take TF32 on the card by default.  On
    DTensors it runs on each rank's batch and channels (``local_map``:
    the sequence whole, w split over the channels as x is)."""
    if isinstance(x, DTensor):
        xpl = renumbered(x.placements, {0: 0, 2: 2})
        wpl = renumbered(xpl, {2: 0})
        return local_map(_causal_conv1d, out_placements=xpl,
                         in_placements=(xpl, wpl),
                         in_grad_placements=(xpl, grad_placements(wpl,
                                                                   xpl)),
                         device_mesh=x.device_mesh,
                         redistribute_inputs=True)(x, w)
    return _causal_conv1d(x, w)


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    W, L = w.shape[-1], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0)).to(torch.float32)
    wf = w.to(torch.float32)
    out = xp[:, :L] * wf[:, 0]
    for i in range(1, W):
        out = out + xp[:, i:i + L] * wf[:, i]
    return out.to(x.dtype)


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor):
    """One decode step of ``causal_conv1d``: x_t (B, C), conv_state
    (B, W-1, C) the last W-1 inputs.  Returns (y (B, C), the new state).
    On DTensors it runs on each rank's batch and channels, as
    ``causal_conv1d``."""
    if isinstance(x_t, DTensor):
        spl = renumbered(conv_state.placements, {0: 0, 2: 2})
        xpl = renumbered(spl, {0: 0, 2: 1})
        wpl = renumbered(spl, {2: 0})
        return local_map(_causal_conv1d_step, out_placements=(xpl, spl),
                         in_placements=(xpl, spl, wpl),
                         device_mesh=x_t.device_mesh,
                         redistribute_inputs=True)(x_t, conv_state, w)
    return _causal_conv1d_step(x_t, conv_state, w)


def _causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                        w: torch.Tensor):
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B, W, C)
    y = torch.einsum("bwc,cw->bc", window.to(torch.float32),
                     w.to(torch.float32))
    return y.to(x_t.dtype), window[:, 1:]


class MetaGenerator:
    """Stands in for a ``torch.Generator`` on the meta device, which
    torch does not have: parameters made there have shapes and dtypes
    and no values."""
    device = torch.device("meta")


def init_dense(shape: tuple, generator: torch.Generator,
               scale: float | None = None, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Normal weights of std ``scale`` (default ``1 / sqrt(fan_in)``) on the
    generator's device.  The numbers are not ``jax.random``'s.  On the
    meta device (``MetaGenerator``) nothing is drawn."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    gen = None if generator.device.type == "meta" else generator
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(scale).to(dtype)
