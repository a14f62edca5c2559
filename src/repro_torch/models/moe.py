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

On a mesh the slots carry ``repro``'s constraints (``moe_slots``:
experts over ``model``; the combined tokens over the dp group).  Two
regions have no DTensor sharding strategy and run under ``local_map``:
the slot tables (a stable argsort, a searchsorted and three scatters)
are built on every rank from the replicated routing, and the combine's
``index_add_`` sums each rank's own experts into a partial (T, D) that
the tokens' constraint reduces.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..distributed import constraints as con
from ..distributed.sharding import ShardingRules, placements
from .layers import init_dense, take_rows


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
        if isinstance(xt, DTensor):
            out = _decode_on_mesh(params, xt, expert_ids, gate_vals)
        else:
            out = _decode_experts(params, xt, expert_ids, gate_vals)
        return out.reshape(B, L, D).to(x.dtype), aux

    # Python's round (half to even), as repro: a capacity of 2.5 is 2
    cap = int(max(1, round(T * K / E * cfg.capacity_factor)))
    if isinstance(xt, DTensor):
        rep = [Replicate()] * xt.device_mesh.ndim
        slot_tok, slot_gate, slot_valid = local_map(
            lambda e, g: _slot_tables(e, g, T, K, E, cap),
            out_placements=(rep, rep, rep), in_placements=(rep, rep),
            device_mesh=xt.device_mesh, redistribute_inputs=True)(
                expert_ids, gate_vals)
    else:
        slot_tok, slot_gate, slot_valid = _slot_tables(expert_ids, gate_vals,
                                                       T, K, E, cap)

    xe = con.constrain(take_rows(xt, slot_tok), con.moe_slots)  # (E, cap, D)
    g = con.constrain(torch.bmm(xe, params["w_gate"]), con.moe_slots)
    u = con.constrain(torch.bmm(xe, params["w_up"]), con.moe_slots)
    ye = torch.bmm(F.silu(g) * u, params["w_down"])
    ye = con.constrain(ye * slot_gate[..., None] * slot_valid[..., None],
                       con.moe_slots)                            # float32
    if isinstance(ye, DTensor):
        out = _combine_on_mesh(slot_tok, ye, T)
    else:
        # empty slots point at token 0 and add zero
        out = torch.zeros((T, D), dtype=ye.dtype,
                          device=ye.device).index_add_(
            0, slot_tok.reshape(-1), ye.reshape(-1, D))
    out = con.constrain(out, con.tokens_d)
    return out.reshape(B, L, D).to(x.dtype), aux


def _slot_tables(expert_ids: torch.Tensor, gate_vals: torch.Tensor, T: int,
                 K: int, E: int, cap: int):
    """(slot_tok, slot_gate, slot_valid), each (E, cap), from the (T, K)
    routing: the (token, k) pairs each expert gathers, ranked by position
    within the expert's queue through a stable sort of the expert ids and
    the rank within each run."""
    dev = expert_ids.device
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
    return slot_tok[:, :cap], slot_gate[:, :cap], slot_valid[:, :cap]


def _combine_on_mesh(slot_tok: torch.Tensor, ye: DTensor, T: int) -> DTensor:
    """The combine's ``index_add_`` on each rank's experts, the slots laid
    out by ``moe_slots``: a (T, D) partial sum over every mesh dim that
    splits the experts."""
    mesh = ye.device_mesh
    pl = list(placements(con.moe_slots(ShardingRules(mesh), tuple(ye.shape)),
                         mesh))
    out_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]

    def local(st, ye):
        D = ye.shape[-1]
        return torch.zeros((T, D), dtype=ye.dtype, device=ye.device
                           ).index_add_(0, st.reshape(-1), ye.reshape(-1, D))
    return local_map(local, out_placements=out_pl, in_placements=(pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(slot_tok, ye)


def _decode_experts(params: dict, xt: torch.Tensor, expert_ids: torch.Tensor,
                    gate_vals: torch.Tensor) -> torch.Tensor:
    """Each token through its K experts' weights, gathered exactly: (T,
    D) float32."""
    wg = params["w_gate"][expert_ids]                     # (T, K, D, F)
    wu = params["w_up"][expert_ids]
    wd = params["w_down"][expert_ids]
    g = torch.einsum("td,tkdf->tkf", xt, wg)
    u = torch.einsum("td,tkdf->tkf", xt, wu)
    y = torch.einsum("tkf,tkfd->tkd", F.silu(g) * u, wd)
    return (y * gate_vals[..., None]).sum(dim=1)


def _decode_on_mesh(params: dict, xt: DTensor, expert_ids, gate_vals):
    """``_decode_experts`` on each rank's experts (``local_map``): the
    tokens and their routes whole on every rank, the expert stacks split
    over the mesh dims that ``param_spec`` splits them over (each rank's
    weights whole along D and F), a partial sum over those dims."""
    mesh = xt.device_mesh
    rules = ShardingRules(mesh)
    wpl = {name: [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in placements(rules.param_spec(
                      f"moe/{name}", tuple(params[name].shape)), mesh)]
           for name in ("w_gate", "w_up", "w_down")}
    split = wpl["w_gate"]
    rep = [Replicate()] * mesh.ndim
    # the first local expert: this rank's block along the splitting dims
    coord, block, blocks = mesh.get_coordinate(), 0, 1
    for i, p in enumerate(split):
        if isinstance(p, Shard):
            block, blocks = block * mesh.size(i) + coord[i], \
                blocks * mesh.size(i)
    offset = block * (params["w_gate"].shape[0] // blocks)

    def local(xt, ids, gates, wg, wu, wd):
        # routes to another rank's experts add nothing here
        ids = ids - offset
        keep = (ids >= 0) & (ids < wg.shape[0])
        return _decode_experts({"w_gate": wg, "w_up": wu, "w_down": wd},
                               xt, torch.where(keep, ids, 0), gates * keep)
    out_pl = [Partial() if isinstance(p, Shard) else Replicate()
              for p in split]
    return local_map(local, out_placements=out_pl,
                     in_placements=(rep, rep, rep, wpl["w_gate"],
                                    wpl["w_up"], wpl["w_down"]),
                     device_mesh=mesh, redistribute_inputs=True)(
                         xt, expert_ids, gate_vals, params["w_gate"],
                         params["w_up"], params["w_down"])
