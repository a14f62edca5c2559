"""PathEnum core on PyTorch: index, estimators, optimizer, enumerators
(the port of ``repro.core``; DESIGN.md §1-2 describe the pipeline)."""

from . import (clock, constraints, oracle, planner, rank, relations,
               sharing)
from .baseline import BaselineResult, generic_dfs
from .batch import (DEFAULT_GRAPH_ID, BatchItem, BatchOutput, BatchPathEnum,
                    BatchTiming, CacheStats, IndexCache,
                    batched_index_distances, edge_mask_hash, tenant_of)
from .device import resolve_device
from .enumerate import (EngineLimit, EnumResult, EnumStats,
                        enumerate_paths_idx, resolve_backend)
from .fused import enumerate_fused_device
from .estimator import WalkCountDP, preliminary_estimate, walk_count_dp
from .graph import (DeviceGraph, Graph, complete, erdos_renyi, from_edges,
                    grid, layered_dag, power_law, random_graph_suite)
from .index import (DeviceIndexArrays, LightweightIndex, build_index,
                    build_index_device)
from .join import enumerate_paths_join, hop_count_dp
from .pathenum import PathEnum, QueryOutput, QueryTiming
from .planner import DEFAULT_TAU, Plan, plan_query
from .rank import RankSpec, make_rank_spec

__all__ = [
    "BaselineResult", "RankSpec", "constraints", "generic_dfs",
    "make_rank_spec", "relations",
    "BatchItem", "BatchOutput", "BatchPathEnum", "BatchTiming", "CacheStats",
    "DEFAULT_GRAPH_ID", "IndexCache", "batched_index_distances",
    "edge_mask_hash", "enumerate_fused_device", "sharing", "tenant_of",
    "DEFAULT_TAU", "DeviceGraph", "DeviceIndexArrays", "EngineLimit",
    "EnumResult", "EnumStats", "Graph", "LightweightIndex", "PathEnum",
    "Plan", "QueryOutput", "QueryTiming", "WalkCountDP", "build_index",
    "build_index_device", "clock", "complete", "enumerate_paths_idx",
    "enumerate_paths_join", "erdos_renyi", "from_edges", "grid",
    "hop_count_dp", "layered_dag", "oracle", "plan_query", "planner",
    "power_law",
    "preliminary_estimate", "random_graph_suite", "rank", "resolve_backend",
    "resolve_device", "walk_count_dp",
]
