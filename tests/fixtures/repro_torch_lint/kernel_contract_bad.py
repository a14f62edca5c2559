"""Known-bad kernel module: every clause of the port's kernel contract
broken once."""
import ctypes

import torch
import triton  # imported at import time, not at first use

from . import _build

PAD = 0  # the shared sentinel is -1

_LIB = _build.load("semiring")  # built at import, not at first use


def scale_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2


def _lib() -> ctypes.CDLL:
    return _build.load("semiring")


def scale(x: torch.Tensor) -> torch.Tensor:
    # no branch for a CPU tensor: the plain version is never reached
    out = torch.empty_like(x)
    _lib().scale_launch(x.data_ptr(), out.data_ptr(), x.numel())
    return out


def scale_hidden(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return scale_plain(x)
    try:
        _lib().scale_launch(x.data_ptr(), x.data_ptr(), x.numel())
    except OSError:
        return scale_plain(x)  # a fallback that hides the kernel
    return x


def scale_moved(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return scale_plain(x)
    try:
        _lib().scale_launch(x.data_ptr(), x.data_ptr(), x.numel())
    except RuntimeError:
        x = x.to("cpu")  # the work moves off the card
    return x


def index(x: torch.Tensor) -> torch.Tensor:
    if not x.is_cuda:
        return scale_plain(x)
    idx = x.long()  # int64 in a launching function
    _lib().scale_launch(idx.data_ptr(), idx.data_ptr(), idx.numel())
    return idx.to(torch.int64)
