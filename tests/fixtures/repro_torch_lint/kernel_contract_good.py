"""Known-good kernel module: the port's kernel contract kept."""
import ctypes

import torch

from . import _build

PAD = -1

launches: int = 0


def scale_plain(x: torch.Tensor) -> torch.Tensor:
    # plain versions may index with int64
    return x * torch.ones(1, dtype=torch.int64)


def _lib() -> ctypes.CDLL:
    import triton  # noqa: F401 — at first use, inside the launch path
    return _build.load("semiring")


def _launch(x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    _build.check(_lib().scale_launch(x.data_ptr(), out.data_ptr(),
                                     x.numel()), "scale")
    return out


def scale(x: torch.Tensor) -> torch.Tensor:
    global launches
    if not x.is_cuda:
        return scale_plain(x)
    try:
        out = _launch(x)
    except RuntimeError as exc:
        raise RuntimeError("scale failed on the card") from exc
    launches += 1
    return out


def scale_on_card(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return _launch(x.to(torch.int32))
    else:
        return scale_plain(x)


def helper(x: torch.Tensor) -> torch.Tensor:
    # reaches no kernel: not held to the contract
    return x.long()
