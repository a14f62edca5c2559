"""Mesh construction (the port of ``repro.launch.mesh``).

Functions, never module-level meshes: importing this module touches no
process-group or device state (the dry run builds its fake group
first).  ``make_production_mesh`` keeps ``repro``'s pod shapes and axis
names, so the dry run's specs compare with ``repro``'s cell by cell; it
needs a default process group of 256 or 512 ranks (the dry run's fake
one).  On H100 nodes of eight NVLink-connected cards, its 16-way
``model`` axis spans two NVLink domains: ``repro``'s layout, kept as it
is (PERF.md §7).
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..compat import make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str = "cuda"
                         ) -> DeviceMesh:
    """(16, 16) data×model single pod; (2, 16, 16) pod×data×model for two
    pods, over the default process group (which must have 256 or 512
    ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(model_parallel: int = 1,
                    device: torch.device | str = "cuda") -> DeviceMesh:
    """A (ranks / model_parallel, model_parallel) ``("data", "model")``
    mesh over the ranks of the default process group; with no group, a
    one-rank group on a free localhost port (``compat.make_mesh``).
    ``"cuda"`` without a card raises."""
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel="
                         f"{model_parallel}")
    return make_mesh((n // model_parallel, model_parallel),
                     ("data", "model"), device=device)


HARDWARE = {
    # NVIDIA H100 SXM5 80GB, per card (data-sheet values)
    "peak_flops_bf16": 989e12,   # FLOP/s, dense bfloat16 tensor cores
    "hbm_bandwidth": 3.35e12,    # B/s
    "nvlink_bandwidth": 450e9,   # B/s a direction (NVLink 4, 18 links)
    "hbm_bytes": 80e9,
}
