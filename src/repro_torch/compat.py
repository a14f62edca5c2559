"""Capability probe and mesh construction for the port's mesh engine.

``repro``'s ``compat`` module papers over JAX version skew; the port has
none to paper over, so its counterpart is what ``repro_torch.distributed``
needs to know about the machine: whether CUDA is there and the device is
a Hopper part (sm_90, the kernels' target), and which
``torch.distributed`` backends this build of PyTorch carries.
``make_mesh`` then builds the ``DeviceMesh`` the engine runs on.
"""
from __future__ import annotations

import dataclasses
import math
import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Capabilities:
    """What the machine offers the port."""
    cuda: bool                              # torch sees a CUDA device
    device_name: Optional[str]              # CUDA device 0's name
    compute_capability: Optional[Tuple[int, int]]
    sm90: bool                              # compute capability 9.0
    nccl: bool                              # the NCCL backend is built in
    gloo: bool                              # the gloo backend is built in


def probe() -> Capabilities:
    """The capabilities of this process's machine (reads CUDA device 0)."""
    cuda = torch.cuda.is_available()
    cc = torch.cuda.get_device_capability(0) if cuda else None
    return Capabilities(
        cuda=cuda,
        device_name=torch.cuda.get_device_name(0) if cuda else None,
        compute_capability=cc, sm90=cc == (9, 0),
        nccl=dist.is_available() and dist.is_nccl_available(),
        gloo=dist.is_available() and dist.is_gloo_available())


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              device: torch.device | str = "cuda",
              backend: Optional[str] = None,
              init_method: Optional[str] = None,
              rank: Optional[int] = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with ``mesh_dim_names`` ``names``.

    Initialises the default process group first if none is set: NCCL for
    a ``"cuda"`` device, gloo for ``"cpu"``, or ``backend`` when given
    (gloo on ``"cuda"`` is the one-card, several-process mesh).  The
    group spans ``prod(shape)`` ranks; ``init_method`` and ``rank``
    default to ``env://`` and ``$RANK`` when ``MASTER_ADDR`` is set, and
    a one-rank mesh without them takes a free localhost port.  A
    ``"cuda"`` device makes its index the process's current device.
    ``"cuda"`` without a card raises, as every entry point of the port
    does: nothing falls back to the CPU.
    """
    dev = resolve_device(device)
    shape = tuple(int(x) for x in shape)
    names = tuple(names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and names {names} differ in "
                         f"length")
    world = math.prod(shape)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if init_method is None:
            if "MASTER_ADDR" in os.environ:
                init_method = "env://"
            elif world == 1:
                init_method = f"tcp://127.0.0.1:{free_port()}"
            else:
                raise ValueError(
                    f"a {world}-rank mesh needs init_method (or "
                    f"MASTER_ADDR and MASTER_PORT) and rank")
        if rank is None:
            rank = int(os.environ.get("RANK", 0))
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    if dist.get_world_size() != world:
        raise ValueError(f"mesh {shape} needs {world} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)
