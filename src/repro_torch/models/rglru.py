"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427):
the port of ``repro.models.rglru``.

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t), with
a_t = exp(-c·softplus(Λ)·σ(r_t)), wrapped in Griffin's recipe: a linear
in, a depthwise causal conv, a GELU-gated output.  ``repro``'s
``jax.lax.associative_scan`` over L is a log-depth Hillis-Steele scan
with the same combine (ceil(log2 L) steps, each one batched op over the
whole sequence).  ``jax.nn.gelu`` is the tanh form by default, and so is
the GELU here.  ``lam`` stays float32 whatever the parameters' dtype, as
in ``repro``.  On a mesh the forward carries ``repro``'s constraints
(``act_bsf`` on the two in-projections, ``act_bsd`` on the output).  No
Pallas kernel here in ``repro``, so no CUDA kernel in the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..distributed import constraints as con
from .layers import causal_conv1d, causal_conv1d_step, init_dense

_C = 8.0  # Griffin's fixed scaling constant
f32 = torch.float32


def init_rglru(cfg: ArchConfig, generator: torch.Generator,
               dtype: torch.dtype = torch.float32) -> dict:
    """Projections, conv taps and gates in ``dtype``; ``lam`` (4.0 per
    channel, softplus(4) ≈ 4.02) float32."""
    d = cfg.d_model
    w = cfg.rnn_width or d
    return {
        "w_x": init_dense((d, w), generator, dtype=dtype),
        "w_gate_out": init_dense((d, w), generator, dtype=dtype),
        "w_out": init_dense((w, d), generator, dtype=dtype),
        "conv_w": init_dense((w, cfg.conv_width), generator, scale=0.5,
                             dtype=dtype),
        "lam": torch.full((w,), 4.0, dtype=f32, device=generator.device),
        "w_in_gate": init_dense((w, w), generator, dtype=dtype),
        "w_rec_gate": init_dense((w, w), generator, dtype=dtype),
    }


def _gates(params: dict, x: torch.Tensor):
    i_t = torch.sigmoid(x @ params["w_in_gate"])
    r_t = torch.sigmoid(x @ params["w_rec_gate"])
    log_a = -_C * F.softplus(params["lam"]) * r_t.to(f32)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return i_t, a, mult


def linear_scan(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + v_t from h = 0, along dim 1: a Hillis-Steele
    scan with ``repro``'s combine ((a1, v1), (a2, v2)) -> (a1·a2,
    v1·a2 + v2)."""
    L, shift = a.shape[1], 1
    while shift < L:
        v = torch.cat([v[:, :shift], v[:, :-shift] * a[:, shift:]
                       + v[:, shift:]], dim=1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a[:, shift:]], dim=1)
        shift *= 2
    return v


def rglru_forward(params: dict, x: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    """x (B, L, D) -> (B, L, D)."""
    xb = con.constrain(x @ params["w_x"], con.act_bsf)
    xb = causal_conv1d(xb, params["conv_w"])
    i_t, a, mult = _gates(params, xb)
    h = linear_scan(a, mult * (i_t * xb).to(f32))                # (B, L, W)
    gate = F.gelu(con.constrain(x @ params["w_gate_out"], con.act_bsf),
                  approximate="tanh")
    return con.constrain((h.to(x.dtype) * gate) @ params["w_out"],
                         con.act_bsd)


def rglru_decode_step(params: dict, x_t: torch.Tensor, state,
                      cfg: ArchConfig):
    """x_t (B, D); state = (conv window (B, W-1, width), h (B, width)
    float32).  Returns (out (B, D), the new state)."""
    conv_state, h = state
    xb, conv_state = causal_conv1d_step(x_t @ params["w_x"], conv_state,
                                        params["conv_w"])
    i_t, a, mult = _gates(params, xb)
    h = a * h + mult * (i_t * xb).to(f32)
    gate = F.gelu(x_t @ params["w_gate_out"], approximate="tanh")
    return (h.to(x_t.dtype) * gate) @ params["w_out"], (conv_state, h)


def init_rglru_state(cfg: ArchConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device: torch.device | str = "cuda"):
    """A zero state: (conv window (batch, W-1, width) in ``dtype``, h
    (batch, width) float32)."""
    device = resolve_device(device)
    w = cfg.rnn_width or cfg.d_model
    conv = torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                       device=device)
    return conv, torch.zeros((batch, w), dtype=f32, device=device)
