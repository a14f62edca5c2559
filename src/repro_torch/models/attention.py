"""Grouped-query attention: the plain chunked path and the kernel path
(the port of ``repro.models.attention``).

``impl="xla"`` keeps ``repro``'s name for its plain path: the queries go
in chunks of ``cfg.attn_chunk`` rows, one chunk at a time, so the logits
working set stays (B, H, chunk, Lk).  ``impl="flash"`` runs the
hand-written kernels: K6 (``kernels/flash_attention.py``) on prefill and
K7 (``kernels/decode_attention.py``) on decode.  The default ``None``
picks ``"flash"`` when x lies on a CUDA device and ``"xla"`` on the CPU,
the path ``repro``'s transformer takes there.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..distributed import constraints as con
from ..distributed.sharding import ShardingRules, placements, renumbered
from ..kernels import decode_attention as kd
from ..kernels import flash_attention as kf
from .layers import apply_rope, init_dense

NEG_INF = -1e30
IMPLS = ("xla", "flash")

# DTensor calls that resolved to the kernels, by the route they took
mesh_routes = {"local_kernel": 0, "plain": 0}


def init_attention(cfg: ArchConfig, generator: torch.Generator,
                   dtype: torch.dtype = torch.float32) -> dict:
    """The four projections, (d_in, d_out) as in ``repro``."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.kv_heads, cfg.hd
    return {
        "wq": init_dense((d, h * hd), generator, dtype=dtype),
        "wk": init_dense((d, hkv * hd), generator, dtype=dtype),
        "wv": init_dense((d, hkv * hd), generator, dtype=dtype),
        "wo": init_dense((h * hd, d), generator, dtype=dtype),
    }


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """``impl`` checked, or the default for x's device."""
    if impl is None:
        return "flash" if x.is_cuda else "xla"
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS} or None, got {impl!r}")
    return impl


def _xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: Optional[int], q_chunk: int,
                   q_offset: int = 0) -> torch.Tensor:
    """q (B, Lq, H, D); k, v (B, Lk, Hkv, D).  Chunked over Lq, one chunk
    at a time; the KV heads are repeated to H once.  On DTensors whose
    ``act_heads`` layout keeps each rank's (batch, head) slices whole,
    the chunks run on the local shards (``local_map``)."""
    H = q.shape[2]
    group = H // k.shape[2]
    q = con.constrain(q, con.act_heads)
    kq = k.repeat_interleave(group, dim=2) if group > 1 else k
    vq = v.repeat_interleave(group, dim=2) if group > 1 else v
    kq = con.constrain(kq, con.act_heads)
    vq = con.constrain(vq, con.act_heads)
    kw = dict(causal=causal, window=window, q_chunk=q_chunk,
              q_offset=q_offset)
    if _is_dtensor(q):
        pl = _head_split(q, kq)
        if pl is not None:
            mesh = q.device_mesh
            q, kq, vq = (x.redistribute(mesh, pl) for x in (q, kq, vq))

            def local(q, k, v):
                with con.use_mesh(None):
                    return _chunked(q, k, v, **kw)
            pl = list(pl)
            return local_map(local, out_placements=pl,
                             in_placements=(pl, pl, pl),
                             device_mesh=mesh)(q, kq, vq)
    return _chunked(q, kq, vq, **kw)


def _chunked(q: torch.Tensor, kq: torch.Tensor, vq: torch.Tensor, *,
             causal: bool, window: Optional[int], q_chunk: int,
             q_offset: int) -> torch.Tensor:
    """The chunk loop of ``_xla_attention`` over q, kq, vq (B, L, H, D)."""
    B, Lq, H, D = q.shape
    Lk = kq.shape[1]
    scale = 1.0 / math.sqrt(D)
    qc = min(q_chunk, Lq)
    if Lq % qc != 0:
        qc = Lq
    ki = torch.arange(Lk, device=q.device)
    outs = []
    for c0 in range(0, Lq, qc):
        logits = con.constrain(
            torch.einsum("bqhd,bkhd->bhqk", q[:, c0:c0 + qc],
                         kq).to(torch.float32), con.logits_bhqk) * scale
        if causal:
            rows = torch.arange(c0, c0 + qc, device=q.device) + q_offset
            mask = rows[:, None] >= ki[None, :]
            if window:
                mask &= (rows[:, None] - ki[None, :]) < window
            logits = torch.where(mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        outs.append(con.constrain(
            torch.einsum("bhqk,bkhd->bqhd", p.to(vq.dtype), vq),
            con.act_heads))
    return con.constrain(torch.cat(outs, dim=1), con.act_heads)


def _is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def _whole_groups(t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """t, with tensor dim ``dim`` replicated over each mesh dim that
    splits it but does not divide ``n`` (the groups a reshape will cut
    ``dim`` into; n = 1 for a dim a reshape merges into the one before),
    so no rank's part cuts a group; a plain t as it is."""
    if not _is_dtensor(t):
        return t
    mesh, pl = t.device_mesh, list(t.placements)
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim and n % mesh.size(i):
            pl[i] = Replicate()
    return t.redistribute(mesh, pl)


def _split_heads(t: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    """(B, L, n·hd) -> (B, L, n, hd)."""
    B, L = t.shape[:2]
    return _whole_groups(t, 2, n).reshape(B, L, n, hd)


def _on_mesh(x: torch.Tensor, mesh) -> DTensor:
    """x, or a plain x as a DTensor replicated over ``mesh``."""
    if _is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _head_split(q: DTensor, k: DTensor):
    """The placements of ``act_heads`` for q (B, L, H, D) and k (B, L,
    Hkv, D) on q's mesh when they split only batch and heads, and the
    same way; else None."""
    rules = ShardingRules(q.device_mesh)
    sq = con.act_heads(rules, tuple(q.shape))
    sk = con.act_heads(rules, tuple(k.shape))
    if sq[1] is not None or sq[3] is not None or tuple(sq) != tuple(sk):
        return None
    return placements(sq, q.device_mesh)


def _flash_on_mesh(q, k, v, win):
    """K6 on DTensors: on each rank's local shards when ``_head_split``
    allows, else the plain path (module docstring)."""
    pl = _head_split(q, k)
    if pl is None:
        mesh_routes["plain"] += 1
        return None
    mesh = q.device_mesh
    q, k, v = (x.redistribute(mesh, pl) for x in (q, k, v))

    def local(q, k, v):
        return kf.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=True, window=win)
    mesh_routes["local_kernel"] += 1
    pl = list(pl)
    return local_map(local, out_placements=pl, in_placements=(pl, pl, pl),
                     device_mesh=mesh)(q, k, v)


def _write_row(cache: torch.Tensor, row: torch.Tensor,
               slot: torch.Tensor) -> None:
    """``cache[b, slot[b]] = row[b]`` for every b, in place; cache (B, S,
    Hkv, hd), row (B, Hkv, hd).  A DTensor cache is written on each
    rank's local shard, or by a masked copy when its sequence is split."""
    if not _is_dtensor(cache):
        cache[torch.arange(cache.shape[0], device=cache.device),
              slot.long()] = row
        return
    mesh, pl = cache.device_mesh, cache.placements
    if any(isinstance(p, Shard) and p.dim == 1 for p in pl):
        hit = (torch.arange(cache.shape[1], device=cache.device)[None, :]
               == slot.long()[:, None])
        cache.copy_(torch.where(hit[:, :, None, None], row[:, None], cache))
        return
    local = cache.to_local()
    row = _on_mesh(row, mesh).redistribute(
        mesh, renumbered(pl, {0: 0, 2: 1, 3: 2}))
    slot = _on_mesh(slot, mesh).redistribute(mesh,
                                             renumbered(pl, {0: 0}))
    local[torch.arange(local.shape[0], device=local.device),
          slot.to_local().long()] = row.to_local()


def _decode_on_mesh(q, ck, cv, lengths):
    """K7 on DTensors: on each rank's local shards when the cache is
    split only over batch and KV heads and q's heads can follow, else
    the plain path (module docstring)."""
    mesh, pl = ck.device_mesh, ck.placements
    if any(isinstance(p, Shard) and p.dim in (1, 3) for p in pl):
        mesh_routes["plain"] += 1
        return None
    qpl = renumbered(pl, {0: 0, 2: 1})
    lpl = renumbered(pl, {0: 0})
    q = q.redistribute(mesh, qpl)
    lengths = _on_mesh(lengths, mesh).redistribute(mesh, lpl)
    mesh_routes["local_kernel"] += 1
    return local_map(
        lambda q, ck, cv, n: kd.decode_attention(q.contiguous(), ck, cv, n),
        out_placements=list(qpl),
        in_placements=(list(qpl), list(pl), list(pl), list(lpl)),
        device_mesh=mesh)(q, ck, cv, lengths)


def attention(params: dict, x: torch.Tensor, cfg: ArchConfig,
              positions: torch.Tensor, *, impl: Optional[str] = None,
              window: Optional[int] = None, kv_cache=None, cache_len=None,
              valid_len=None):
    """Self-attention over x (B, L, D).

    Prefill (``kv_cache`` None): returns ``(out, (k, v))`` so prefill can
    seed the cache.  Decode: x is (B, 1, D) and ``kv_cache=(k, v)`` holds
    (B, S, Hkv, hd) tensors; this token's K and V are written into them in
    place at ``cache_len`` (B,) (``repro`` returns updated copies), and
    ``valid_len`` (B,) optionally overrides the number of valid entries
    (``cache_len + 1``; ring buffers for windowed attention).  Returns
    ``(out, (k, v))`` with the same cache tensors.
    """
    impl = resolve_impl(impl, x)
    B, L, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.kv_heads, cfg.hd
    q = _split_heads(con.constrain(x @ params["wq"], con.act_bsf), h, hd)
    k = _split_heads(con.constrain(x @ params["wk"], con.act_bsf), hkv, hd)
    v = _split_heads(con.constrain(x @ params["wv"], con.act_bsf), hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    win = window if window else (cfg.attn_window or None)
    if kv_cache is None:
        out = None
        if impl == "flash" and _is_dtensor(q):
            out = _flash_on_mesh(q, k, v, win)
        elif impl == "flash":
            out = kf.flash_attention(q, k, v, causal=True, window=win)
        if out is None:
            out = _xla_attention(q, k, v, causal=True, window=win,
                                 q_chunk=cfg.attn_chunk)
        new_cache = (k, v)
    else:
        ck, cv = kv_cache                                   # (B, S, Hkv, hd)
        _write_row(ck, k[:, 0], cache_len)
        _write_row(cv, v[:, 0], cache_len)
        lengths = (cache_len + 1) if valid_len is None else valid_len
        out = None
        if impl == "flash" and _is_dtensor(q):
            out = _decode_on_mesh(q[:, 0], ck, cv, lengths)
        elif impl == "flash":
            out = kd.decode_attention(q[:, 0].contiguous(), ck, cv, lengths)
        if out is not None:
            out = out[:, None]
        else:
            S = ck.shape[1]
            scale = 1.0 / math.sqrt(hd)
            qg = _whole_groups(q[:, 0], 1, hkv).reshape(B, hkv, h // hkv,
                                                        hd)
            logits = torch.einsum("bhgd,bshd->bhgs", qg,
                                  ck).to(torch.float32) * scale
            mask = (torch.arange(S, device=x.device)[None, :]
                    < lengths[:, None])
            logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
            p = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhgs,bshd->bhgd", p.to(cv.dtype), cv)
            out = out.reshape(B, 1, h, hd)
        new_cache = (ck, cv)

    # merging the heads keeps a split of the heads, not of head_dim
    out = _whole_groups(out, 3, 1).reshape(B, out.shape[1], h * hd)
    out = out @ params["wo"]
    return con.constrain(out, con.act_bsd), new_cache
