"""K7: single-token attention with grouped KV heads over a KV cache.

The counterpart of ``repro``'s Pallas kernel ``_decode_kernel``
(``kernels/decode_attention.py``, wrapper ``ops.decode_attention``):
q (B, H, D), caches (B, S, Hkv, D), float32 or bfloat16, ``lengths``
(B,) valid prefix lengths; out (B, H, D) in q's type.

The CUDA source is ``csrc/decode_attention.cu``; it says what bounds the
kernel on the card.  It reads the cache in place and streams only each
row's first ``lengths[b]`` positions: no padding of S (``repro``'s
wrapper pads the whole cache to a multiple of 512 on every step).  A
CUDA tensor launches it; a CPU tensor takes ``decode_attention_plain``,
``repro``'s ``ref.decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import check_inputs

# kernel launches since process start (chip_smoke.py resets and reads them)
launches: int = 0


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


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """q (B, H, D); k_cache, v_cache (B, S, Hkv, D); lengths (B,) integer
    on q's device.  Returns (B, H, D); ``scale`` defaults to
    ``1 / sqrt(D)``."""
    global launches
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
    if lengths.shape != (B,) or lengths.dtype not in (torch.int32,
                                                       torch.int64):
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
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    status = _lib().decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, S, H, Hkv, D, int(q.dtype == torch.bfloat16),
        scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, "decode_attention")
    launches += 1
    return out
