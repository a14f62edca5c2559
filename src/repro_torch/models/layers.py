"""Shared neural building blocks in plain PyTorch (the port of
``repro.models.layers``).

``repro``'s versions pin activations to a device mesh with sharding
constraints; the port runs on one card and has none.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with a ``1 + scale`` gain, cast back to x's type."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


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


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_up)) @ w_down``; weights (d_in, d_out)."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def causal_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, L, C), w (C, W) -> (B, L, C) in x's
    type, ``out[l] = sum_i x[l - W + 1 + i] * w[:, i]`` with zeros before
    the start.  A loop over the W taps summed in float32, not
    ``F.conv1d``: cuDNN would take TF32 on the card by default."""
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
    (B, W-1, C) the last W-1 inputs.  Returns (y (B, C), the new state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)     # (B, W, C)
    y = torch.einsum("bwc,cw->bc", window.to(torch.float32),
                     w.to(torch.float32))
    return y.to(x_t.dtype), window[:, 1:]


def init_dense(shape: tuple, generator: torch.Generator,
               scale: float | None = None, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """Normal weights of std ``scale`` (default ``1 / sqrt(fan_in)``) on the
    generator's device.  The numbers are not ``jax.random``'s."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w.mul_(scale).to(dtype)
