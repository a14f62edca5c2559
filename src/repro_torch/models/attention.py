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

from ..configs.base import ArchConfig
from ..kernels import decode_attention as kd
from ..kernels import flash_attention as kf
from .layers import apply_rope, init_dense

NEG_INF = -1e30
IMPLS = ("xla", "flash")


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
    at a time; the KV heads are repeated to H once."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(D)
    qc = min(q_chunk, Lq)
    if Lq % qc != 0:
        qc = Lq
    kq = k.repeat_interleave(group, dim=2) if group > 1 else k
    vq = v.repeat_interleave(group, dim=2) if group > 1 else v
    ki = torch.arange(Lk, device=q.device)
    outs = []
    for c0 in range(0, Lq, qc):
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, c0:c0 + qc],
                              kq).to(torch.float32) * scale
        if causal:
            rows = torch.arange(c0, c0 + qc, device=q.device) + q_offset
            mask = rows[:, None] >= ki[None, :]
            if window:
                mask &= (rows[:, None] - ki[None, :]) < window
            logits = torch.where(mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p.to(vq.dtype), vq))
    return torch.cat(outs, dim=1)


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
    q = (x @ params["wq"]).reshape(B, L, h, hd)
    k = (x @ params["wk"]).reshape(B, L, hkv, hd)
    v = (x @ params["wv"]).reshape(B, L, hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    win = window if window else (cfg.attn_window or None)
    if kv_cache is None:
        if impl == "flash":
            out = kf.flash_attention(q, k, v, causal=True, window=win)
        else:
            out = _xla_attention(q, k, v, causal=True, window=win,
                                 q_chunk=cfg.attn_chunk)
        new_cache = (k, v)
    else:
        ck, cv = kv_cache                                   # (B, S, Hkv, hd)
        bidx = torch.arange(B, device=x.device)
        pos_idx = cache_len.long()
        ck[bidx, pos_idx] = k[:, 0]
        cv[bidx, pos_idx] = v[:, 0]
        lengths = (cache_len + 1) if valid_len is None else valid_len
        if impl == "flash":
            out = kd.decode_attention(q[:, 0].contiguous(), ck, cv,
                                      lengths)[:, None]
        else:
            S = ck.shape[1]
            scale = 1.0 / math.sqrt(hd)
            qg = q[:, 0].reshape(B, hkv, h // hkv, hd)
            logits = torch.einsum("bhgd,bshd->bhgs", qg,
                                  ck).to(torch.float32) * scale
            mask = (torch.arange(S, device=x.device)[None, :]
                    < lengths[:, None])
            logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
            p = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhgs,bshd->bhgd", p.to(cv.dtype), cv)
            out = out.reshape(B, 1, h, hd)
        new_cache = (ck, cv)

    out = out.reshape(B, out.shape[1], h * hd) @ params["wo"]
    return out, new_cache
