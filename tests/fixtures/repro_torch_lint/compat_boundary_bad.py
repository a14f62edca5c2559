"""Known-bad port module: JAX and the reference imported, the card
probed and a process group made outside their one place."""
import importlib

import jax
import jaxlib.xla_extension
import torch
import torch.distributed as dist
from repro.core import graph
from torch.distributed.device_mesh import init_device_mesh


def pick_device():
    if torch.cuda.is_available():
        return "cuda"
    return "cpu"


def lazily():
    return importlib.import_module("repro.kernels.ops")


def group(world, rank):
    dist.init_process_group("gloo", rank=rank, world_size=world)
    return init_device_mesh("cpu", (world,))


__all__ = ["jax", "jaxlib", "graph"]
