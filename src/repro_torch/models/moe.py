"""Mixture-of-experts FFN with capacity-bounded gather dispatch (the port
of ``repro.models.moe``).

Tokens are routed top-k by a float32 router.  In a forward or prefill
each expert gathers at most ``cap = round(T * K / E * capacity_factor)``
(token, k) pairs, ranked by position within the expert's queue through a
stable sort; overflowed pairs add nothing and the residual carries them.
At decode (``decode=True``) every token gathers its K experts' weights
exactly, with no capacity.  Both return the Switch-style load-balance
aux ``moe_balance``.  Expert weights are stacked (E, ...) as in
``repro``.  No Pallas kernel here in ``repro``, so no CUDA kernel in
the port: plain torch ops on either device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import init_dense


def init_moe(cfg: ArchConfig, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
    """The router (d, E), float32 whatever ``dtype``, and the stacked
    expert SwiGLU weights (E, d, f), (E, d, f), (E, f, d) at ``repro``'s
    scales (``init_dense`` takes the fan-in from the first axis, E)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": init_dense((d, e), generator, dtype=torch.float32),
        "w_gate": init_dense((e, d, f), generator, dtype=dtype),
        "w_up": init_dense((e, d, f), generator, dtype=dtype),
        "w_down": init_dense((e, f, d), generator, dtype=dtype),
    }


def _balance(probs: torch.Tensor, expert_ids: torch.Tensor,
             E: int) -> torch.Tensor:
    me = probs.mean(dim=0)                                       # (E,)
    ce = F.one_hot(expert_ids[:, 0], E).to(torch.float32).mean(dim=0)
    return E * (me * ce).sum()


def moe_ffn(params: dict, x: torch.Tensor, cfg: ArchConfig,
            decode: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, L, D) -> (B, L, D) in x's type, and ``{"moe_balance"}``."""
    B, L, D = x.shape
    E, K = cfg.num_experts, cfg.top_k
    T = B * L
    xt = x.reshape(T, D)

    logits = xt.to(torch.float32) @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)          # (T, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    aux = {"moe_balance": _balance(probs, expert_ids, E)}

    if decode:
        wg = params["w_gate"][expert_ids]                     # (T, K, D, F)
        wu = params["w_up"][expert_ids]
        wd = params["w_down"][expert_ids]
        g = torch.einsum("td,tkdf->tkf", xt, wg)
        u = torch.einsum("td,tkdf->tkf", xt, wu)
        y = torch.einsum("tkf,tkfd->tkd", F.silu(g) * u, wd)
        out = (y * gate_vals[..., None]).sum(dim=1)
        return out.reshape(B, L, D).to(x.dtype), aux

    # Python's round (half to even), as repro: a capacity of 2.5 is 2
    cap = int(max(1, round(T * K / E * cfg.capacity_factor)))
    dev = x.device
    # each (token, k) pair's position in its expert's queue, by a stable
    # sort of the expert ids and the rank within each run
    e_flat = expert_ids.reshape(-1)                               # (T*K,)
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    seg_start = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos = torch.empty_like(e_flat)
    pos[order] = torch.arange(T * K, device=dev) - seg_start[sorted_e]
    # an overflowed pair goes to a spare column ``cap``, cut off after the
    # scatters: repro's mode="drop" with every index in range
    p_idx = torch.where(pos < cap, pos, cap)
    tok_ids = torch.arange(T, device=dev).repeat_interleave(K)
    slot_tok = torch.zeros((E, cap + 1), dtype=torch.long, device=dev)
    slot_gate = torch.zeros((E, cap + 1), dtype=torch.float32, device=dev)
    slot_valid = torch.zeros((E, cap + 1), dtype=torch.bool, device=dev)
    slot_tok[e_flat, p_idx] = tok_ids
    slot_gate[e_flat, p_idx] = gate_vals.reshape(-1)
    slot_valid[e_flat, p_idx] = True
    slot_tok, slot_gate = slot_tok[:, :cap], slot_gate[:, :cap]
    slot_valid = slot_valid[:, :cap]

    xe = xt[slot_tok]                                         # (E, cap, D)
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    ye = torch.bmm(F.silu(g) * u, params["w_down"])
    ye = ye * slot_gate[..., None] * slot_valid[..., None]       # float32
    # empty slots point at token 0 and add zero
    out = torch.zeros((T, D), dtype=ye.dtype, device=dev).index_add_(
        0, slot_tok.reshape(-1), ye.reshape(-1, D))
    return out.reshape(B, L, D).to(x.dtype), aux
