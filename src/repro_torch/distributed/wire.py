"""Collectives over one process group, with their calls and bytes counted.

The mesh engine and the compressed all-reduce reach ``torch.distributed``
only through ``Wire``.  NCCL carries device tensors as they are.  Gloo
does not take every collective on CUDA tensors, so over a gloo group a
CUDA tensor is copied to the host, reduced or gathered there, and copied
back: that is how the gloo path works (``kind == "host"``), chosen by the
group's backend and never by a failure, and the NCCL path never copies.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

ReduceOp = dist.ReduceOp


class Wire:
    """All-reduce and all-gather over ``group``, counted per call."""

    def __init__(self, group: dist.ProcessGroup) -> None:
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        # gloo reduces on the host; NCCL on the device
        self.kind = "host" if self.backend == "gloo" else "device"
        self.reduce_calls = 0
        self.reduce_bytes = 0
        self.gather_calls = 0
        self.gather_bytes = 0

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "host" and x.is_cuda:
            return x.cpu()
        return x.contiguous()

    def all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """``x`` reduced over the group with ``op``, on ``x``'s device
        (a new tensor or ``x`` itself, reduced in place)."""
        self.reduce_calls += 1
        self.reduce_bytes += x.numel() * x.element_size()
        buf = self._to_wire(x)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(x.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in group-rank
        order, on ``x``'s device."""
        self.gather_calls += 1
        self.gather_bytes += x.numel() * x.element_size()
        buf = self._to_wire(x)
        parts: List[torch.Tensor] = [torch.empty_like(buf)
                                     for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts).to(x.device)

    def counts(self) -> dict:
        """The calls and payload bytes (one rank's tensor) so far."""
        return {"all_reduce_calls": self.reduce_calls,
                "all_reduce_bytes": self.reduce_bytes,
                "all_gather_calls": self.gather_calls,
                "all_gather_bytes": self.gather_bytes}
