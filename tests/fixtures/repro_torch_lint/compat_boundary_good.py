"""Known-good port module: its own imports, the device from
core.device, the mesh from compat."""
import importlib

import torch
import torch.distributed as dist

import repro_torch
from repro_torch import compat
from repro_torch.core.device import resolve_device

from . import tree


def pick_device(device="cuda"):
    return resolve_device(device)


def mesh():
    return compat.make_mesh((1,), ("data",), device="cpu")


def lazily():
    return importlib.import_module("repro_torch.kernels.ops")


def ready():
    return dist.is_available() and dist.is_initialized()


__all__ = ["repro_torch", "tree", "torch"]
