"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``: the port
exists to run on the card.  A ``"cuda"`` request on a machine without a
CUDA device raises here; nothing falls back to the CPU.  ``"cpu"`` is an
explicit request, and then each kernel wrapper runs its plain version.
``"meta"`` (shapes and dtypes, no storage) is what the dry run's
stand-ins are built on (``launch/specs.py``).
"""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device`` with an explicit index for CUDA;
    raises RuntimeError if CUDA is requested and unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was requested but torch finds no CUDA "
                "device; pass device='cpu' to run the plain versions on "
                "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r}: cuda, cpu or "
                         f"meta")
    return dev
