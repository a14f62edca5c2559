"""Known-good module: every import used, a quoted annotation included."""
from __future__ import annotations

import collections
from typing import Optional

import torch

__all__ = ["ones", "Cache"]


def ones(n: int, device: Optional[str] = None) -> torch.Tensor:
    return torch.ones(n, device=device)


class Cache:
    store: "collections.OrderedDict[str, torch.Tensor]"
