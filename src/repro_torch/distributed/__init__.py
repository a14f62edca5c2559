"""The mesh engine on ``torch.distributed`` (the port of
``repro.distributed``): queries over a ``DeviceMesh``'s ``data`` dim,
edges over ``model`` (``engine``), and the int8-compressed all-reduce
(``compression``).  ``repro``'s ``sharding`` and ``constraints``, which
lay out the LM's parameters, caches and activations over a mesh, are
not ported yet (ROADMAP.md)."""

from .compression import (compressed_all_reduce, dequantize,
                          make_compressed_grad_fn, quantize,
                          quantize_with_feedback)
from .engine import (DistributedPathEnum, DistributedTenantRouter,
                     make_distributed_bfs, make_distributed_walk_dp)
from .wire import Wire

__all__ = ["DistributedPathEnum", "DistributedTenantRouter", "Wire",
           "compressed_all_reduce", "dequantize", "make_compressed_grad_fn",
           "make_distributed_bfs", "make_distributed_walk_dp", "quantize",
           "quantize_with_feedback"]
