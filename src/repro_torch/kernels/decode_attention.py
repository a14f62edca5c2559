"""K7: single-token attention with grouped KV heads over a KV cache.

The counterpart of ``repro``'s Pallas kernel ``_decode_kernel``
(``kernels/decode_attention.py``, wrapper ``ops.decode_attention``):
q (B, H, D), caches (B, S, Hkv, D), float32 or bfloat16, ``lengths``
(B,) valid prefix lengths; out (B, H, D) in q's type.

The CUDA source is ``csrc/decode_attention.cu``; it says what bounds the
kernel on the card.  It reads the cache in place and streams only each
row's first ``lengths[b]`` positions: no padding of S (``repro``'s
wrapper pads the whole cache to a multiple of 512 on every step).  A
long cache is split along S across blocks, and a second pass combines
the chunks' partials: ``decode_splits`` picks the split from the shapes
and the SM count alone, and ``decode_attention_split_plain`` is that
split-and-combine arithmetic in plain PyTorch (for the tests; no path
runs it).  A CUDA tensor launches the kernel; a CPU tensor takes
``decode_attention_plain``, ``repro``'s ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import check_inputs, refuse_autograd, refuse_dtensor

# kernel launches since process start (chip_smoke.py resets and reads
# them); one a wrapper call, the combine pass included
launches: int = 0

# a cache is split only into chunks of at least this many positions, so
# the engine's short caches keep one launch with no combine pass
MIN_CHUNK = 1024
# blocks the split aims for, per SM
BLOCKS_PER_SM = 4


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, lengths: torch.Tensor, *,
                           scale: float | None = None) -> torch.Tensor:
    """Decode attention in plain PyTorch (``repro``'s
    ``ref.decode_attention_ref``): the KV heads repeated to H, float32
    logits masked past each row's length, a softmax, P cast back to the
    cache's type for the product.  A row of length 0 gives NaN here (a
    softmax over nothing); the kernel gives zeros."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    group = H // Hkv
    kq = k_cache.repeat_interleave(group, dim=2) if group > 1 else k_cache
    vq = v_cache.repeat_interleave(group, dim=2) if group > 1 else v_cache
    logits = torch.einsum("bhd,bshd->bhs", q, kq).to(torch.float32) * scale
    mask = (torch.arange(S, device=q.device)[None, None, :]
            < lengths.to(q.device)[:, None, None])
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p.to(vq.dtype), vq)
    return out.to(q.dtype)


def decode_splits(batch: int, kv_heads: int, seq_len: int,
                  num_sms: int) -> tuple[int, int]:
    """``(splits, chunk)`` for a cache of ``seq_len`` positions: enough
    chunks that ``batch * kv_heads * splits`` blocks give every one of
    ``num_sms`` SMs ``BLOCKS_PER_SM`` blocks, none shorter than
    ``MIN_CHUNK``; ``splits * chunk >= seq_len`` and ``splits >= 1``.
    Nothing here reads the lengths: a decode step never waits for the
    host to see them."""
    rows = max(1, batch * kv_heads)
    want = -(-BLOCKS_PER_SM * num_sms // rows)
    splits = max(1, min(want, seq_len // MIN_CHUNK))
    chunk = max(1, -(-seq_len // splits))
    return -(-seq_len // chunk) if seq_len else 1, chunk


def decode_attention_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 lengths: torch.Tensor, *, chunk: int,
                                 scale: float | None = None) -> torch.Tensor:
    """The kernel's split arithmetic in plain PyTorch, in float32: per
    chunk of ``chunk`` positions the partials m (the largest logit below
    the length, -1e30 if none), l (the sum of exp(logit - m)) and acc
    (those weights times V), then the combine ``sum(acc_c w_c) /
    max(sum(l_c w_c), 1e-30)`` with ``w_c = exp(m_c - max m)``.  A row
    of length 0 gives zeros."""
    B, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    group = H // Hkv
    lens = lengths.to(q.device).clamp(0, S)
    ms, ls, accs = [], [], []
    for c0 in range(0, max(S, 1), chunk):
        kc = k_cache[:, c0:c0 + chunk].float()
        vc = v_cache[:, c0:c0 + chunk].float()
        kq = kc.repeat_interleave(group, dim=2)
        vq = vc.repeat_interleave(group, dim=2)
        logits = torch.einsum("bhd,bshd->bhs", q.float(), kq) * scale
        pos = c0 + torch.arange(kc.shape[1], device=q.device)
        mask = (pos[None, None, :] < lens[:, None, None]).expand_as(logits)
        logits = logits.masked_fill(~mask, -1e30)
        m = logits.amax(-1, keepdim=True) if logits.shape[-1] else \
            torch.full((B, H, 1), -1e30, device=q.device)
        p = torch.exp(logits - m) * mask
        ms.append(m)
        ls.append(p.sum(-1, keepdim=True))
        accs.append(torch.einsum("bhs,bshd->bhd", p, vq))
    m_all = torch.cat(ms, -1)                                 # (B, H, C)
    w = torch.exp(m_all - m_all.amax(-1, keepdim=True))
    denom = (torch.cat(ls, -1) * w).sum(-1, keepdim=True).clamp_min(1e-30)
    acc = (torch.stack(accs, -1) * w[:, :, None, :]).sum(-1)
    return (acc / denom).to(q.dtype)


def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """q (B, H, D); k_cache, v_cache (B, S, Hkv, D); lengths (B,) integer
    on q's device.  Returns (B, H, D); ``scale`` defaults to
    ``1 / sqrt(D)``.  On the card, inputs that autograd tracks raise
    (``refuse_autograd``).  A DTensor raises on either device
    (``refuse_dtensor``)."""
    global launches
    refuse_dtensor("decode_attention", {"q": q, "k_cache": k_cache,
                                        "v_cache": v_cache,
                                        "lengths": lengths})
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q must be (B, H, D) and the "
                         f"caches (B, S, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, H, D = q.shape
    _, S, Hkv, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D or Hkv == 0 \
            or H % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and the "
                         f"cache {tuple(k_cache.shape)} disagree (H must be "
                         f"a multiple of Hkv)")
    # int64 lengths are taken as well: the launch reads an int32 copy
    ints = (torch.int32, torch.int64)  # repro-torch-lint: disable=kernel-contract
    if lengths.shape != (B,) or lengths.dtype not in ints:
        raise ValueError(f"decode_attention: lengths must be ({B},) int32 "
                         f"or int64, got {tuple(lengths.shape)} "
                         f"{lengths.dtype}")
    if lengths.device != q.device:
        raise ValueError(f"decode_attention: lengths is on "
                         f"{lengths.device}, q on {q.device}")
    check_inputs("decode_attention", {"q": q, "k_cache": k_cache,
                                      "v_cache": v_cache}, D)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return decode_attention_plain(q, k_cache, v_cache, lengths,
                                      scale=scale)
    refuse_autograd("decode_attention", {"q": q, "k_cache": k_cache,
                                         "v_cache": v_cache})
    lens = lengths.to(torch.int32).contiguous()
    splits, chunk = decode_splits(
        B, Hkv, S,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    out = torch.empty_like(q)
    parts = [None, None, None]
    if splits > 1:
        parts = [torch.empty((B, H, splits), dtype=torch.float32,
                             device=q.device) for _ in range(2)]
        parts.append(torch.empty((B, H, splits, D), dtype=torch.float32,
                                 device=q.device))
    ptrs = [0 if x is None else x.data_ptr() for x in parts]
    status = _launcher()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), *ptrs, B, S, H, Hkv, D,
        int(q.dtype == torch.bfloat16), scale, splits, chunk,
        _build.stream(q.device))
    _build.check(status, "decode_attention")
    launches += 1
    return out
