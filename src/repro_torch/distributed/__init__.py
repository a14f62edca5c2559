"""The port of ``repro.distributed`` on ``torch.distributed``: the mesh
engine, queries over a ``DeviceMesh``'s ``data`` dim and edges over
``model`` (``engine``), the int8-compressed all-reduce
(``compression``), and the LM's layout over a mesh with DTensor: the
sharding rules for parameters, caches and batches (``sharding``) and
the activation constraints the model code calls (``constraints``)."""

from .compression import (compressed_all_reduce, dequantize,
                          make_compressed_grad_fn, quantize,
                          quantize_with_feedback)
from .engine import (DistributedPathEnum, DistributedTenantRouter,
                     make_distributed_bfs, make_distributed_walk_dp)
from .wire import Wire
from .constraints import constrain, current_mesh, use_mesh
from .sharding import (P, LayoutMesh, NamedSharding, ShardingRules,
                       batch_shardings, cache_shardings, distribute_tree,
                       full_tree, opt_shardings, param_shardings,
                       placements, tree_shardings, tree_specs)

__all__ = ["DistributedPathEnum", "DistributedTenantRouter", "LayoutMesh",
           "NamedSharding", "P", "ShardingRules", "Wire", "batch_shardings",
           "cache_shardings", "compressed_all_reduce", "constrain",
           "current_mesh", "dequantize", "distribute_tree", "full_tree",
           "make_compressed_grad_fn", "make_distributed_bfs",
           "make_distributed_walk_dp", "opt_shardings", "param_shardings",
           "placements", "quantize", "quantize_with_feedback",
           "tree_shardings", "tree_specs", "use_mesh"]
