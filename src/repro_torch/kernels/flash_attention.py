"""K6: blocked online-softmax (flash) attention with grouped KV heads.

The counterpart of ``repro``'s Pallas kernel ``_flash_kernel``
(``kernels/flash_attention.py``, wrapper ``ops.flash_attention``):
q (B, Lq, H, D), k and v (B, Lk, Hkv, D), float32 or bfloat16, out
(B, Lq, H, D) in q's type; KV head ``h // (H // Hkv)``; causal and
sliding-window masks from global indices with the offset ``Lk - Lq``.

Each dtype has one CUDA kernel, and its source says what bounds it on
the card: bfloat16 runs on the tensor cores (``wgmma``) in
``csrc/flash_attention_sm90.cu``; float32 runs on the tensor cores too,
in ``csrc/flash_attention.cu``, with each operand split into two TF32
parts and every product taken as hi·hi + hi·lo + lo·hi in float32 (plain
TF32 keeps 11 bits and would break the float32 contract's 2e-5; the
split keeps about 22).  A CUDA tensor launches its dtype's kernel,
whatever its lengths, and a failed build or launch raises: the kernels
mask ragged ``Lq``, ``Lk`` and ``Lq != Lk`` themselves, so nothing falls
back to a plain version (``repro``'s wrapper falls back to
``ref.mha_ref`` for those because of the TPU's tile alignment).  A CPU
tensor takes ``flash_attention_plain``, ``repro``'s ``ref.mha_ref``.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.distributed.tensor import DTensor

from . import _build

# kernel launches since process start (chip_smoke.py resets and reads
# them): the float32 (split TF32) kernel's and the bfloat16 wgmma kernel's
f32_launches: int = 0
wgmma_launches: int = 0

HEAD_DIMS = (16, 32, 64, 96, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """Attention in plain PyTorch (``repro``'s ``ref.mha_ref``): the KV
    heads repeated to H, float32 logits, a softmax, and P cast back to
    v's type for the product."""
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    group = H // Hkv
    kq = k.repeat_interleave(group, dim=2) if group > 1 else k
    vq = v.repeat_interleave(group, dim=2) if group > 1 else v
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kq).to(torch.float32) * scale
    if causal:
        qi = torch.arange(Lq, device=q.device)[:, None] + (Lk - Lq)
        ki = torch.arange(Lk, device=q.device)[None, :]
        mask = qi >= ki
        if window is not None:
            mask &= (qi - ki) < window
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(vq.dtype), vq)
    return out.to(q.dtype)


def _launcher(bf16: bool):
    """The C launch function of the dtype's kernel (same arguments)."""
    if bf16:
        fn = _build.load("flash_attention_sm90").flash_attention_sm90_launch
    else:
        fn = _build.load("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def refuse_dtensor(name: str, tensors: dict) -> None:
    """Raise on a DTensor: a kernel runs on one rank's local shard, which
    ``models/attention.py`` hands it through ``local_map``.  Shared with
    K7's wrapper."""
    for arg, x in tensors.items():
        if isinstance(x, DTensor):
            raise TypeError(f"{name}: {arg} is a DTensor; pass its local "
                            f"shard (models/attention.py runs the kernel "
                            f"under local_map)")


def check_inputs(name: str, tensors: dict, head_dim: int) -> None:
    """Raise unless the tensors share one device and one dtype (float32
    or bfloat16), are contiguous (and 16-byte aligned on the card, for
    the kernels' 16-byte copies), and the head dim is one the kernels
    are built for.  Shared with K7's wrapper."""
    first = next(iter(tensors.values()))
    for arg, x in tensors.items():
        if x.device != first.device:
            raise ValueError(f"{name}: {arg} is on {x.device}, the others "
                             f"on {first.device}")
        if x.dtype != first.dtype:
            raise TypeError(f"{name}: {arg} is {x.dtype}, the others "
                            f"{first.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if x.is_cuda and x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start 16-byte aligned")
    if first.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype must be float32 or bfloat16, got "
                        f"{first.dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {head_dim} is not one of "
                         f"{HEAD_DIMS}")


def refuse_autograd(name: str, tensors: dict) -> None:
    """Raise on CUDA inputs that autograd tracks: the kernels have no
    backward (``repro``'s Pallas kernels have none either), and their
    output would carry no ``grad_fn``.  Training takes ``impl="xla"``.
    Shared with K7's wrapper."""
    if torch.is_grad_enabled() and any(x.requires_grad
                                       for x in tensors.values()):
        raise RuntimeError(
            f"{name}: the kernel has no backward; under autograd take the "
            f"plain attention path (impl=\"xla\"), as training does")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q (B, Lq, H, D); k, v (B, Lk, Hkv, D); returns (B, Lq, H, D).

    ``window`` (applied only when ``causal``) keeps the columns with
    ``row + Lk - Lq - col < window``; ``scale`` defaults to
    ``1 / sqrt(D)``.  On the card the dtype picks the kernel: bfloat16
    launches the ``wgmma`` kernel, float32 the split-TF32 kernel, and
    inputs that autograd tracks raise (``refuse_autograd``); a CPU tensor
    takes ``flash_attention_plain``.  A DTensor raises on either device
    (``refuse_dtensor``)."""
    global f32_launches, wgmma_launches
    refuse_dtensor("flash_attention", {"q": q, "k": k, "v": v})
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be (B, Lq, H, D) and k, v "
                         f"(B, Lk, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Lq, H, D = q.shape
    _, Lk, Hkv, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or H % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (H must be a multiple "
                         f"of Hkv)")
    check_inputs("flash_attention", {"q": q, "k": k, "v": v}, D)
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    refuse_autograd("flash_attention", {"q": q, "k": k, "v": v})
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    status = _launcher(bf16)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Lq, Lk,
        H, Hkv, D, scale, int(causal), int(window or 0),
        _build.stream(q.device))
    _build.check(status, "flash_attention_sm90" if bf16 else
                 "flash_attention")
    if bf16:
        wgmma_launches += 1
    else:
        f32_launches += 1
    return out
