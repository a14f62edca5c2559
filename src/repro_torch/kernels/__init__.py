"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions
(the port of ``repro.kernels``: the PathEnum kernels, DESIGN.md §9, and
the LM attention kernels).

decode_attention — K7, single-token attention over a KV cache, split
                   across blocks for long caches
flash_attention  — K6, blocked online-softmax attention on the tensor
                   cores (bfloat16; float32 as split TF32)
frontier_expand  — K1 and K5, the IDX-DFS frontier hop (single-query,
                   masks or compacted children, and fused over many
                   queries)
ops              — the single-query and fused expands, K2 (the
                   resident work deque, one persistent kernel per
                   round), bfs_dense
semiring_spmm    — K3 counting SpMM and K4 min-plus SpMV (one launch
                   for a whole bounded BFS)

CUDA tensors launch the kernels (built from ``csrc/`` at first use by
``_build``); CPU tensors take the plain versions.  ``bfs_dense``,
``counting_spmm`` and ``minplus_spmv`` are re-exported as ``repro``'s
package does.  ``decode_attention``, ``flash_attention`` and
``frontier_expand`` stay the submodules whose counters
``launch_counts()`` reads; their wrappers are called through them.
"""
from . import (decode_attention, flash_attention, frontier_expand, ops,
               semiring_spmm)
from .semiring_spmm import bfs_dense, counting_spmm, minplus_spmv


def launch_counts() -> dict:
    """Kernel launches (deque rounds for K2) since the last reset; K6's
    two kernels apart (``flash_attention`` the float32 split-TF32 kernel,
    ``flash_attention_sm90`` the bfloat16 wgmma kernel).  K1
    (``frontier_masks``) and K4 (``minplus_spmv``) count launches from
    every entry; ``frontier_hop`` and ``bfs_dense`` count those of K1's
    hop entry and of the one-launch BFS alone."""
    return {"frontier_masks": frontier_expand.launches,
            "frontier_hop": frontier_expand.hop_launches,
            "frontier_fused_masks": frontier_expand.fused_launches,
            "frontier_deque_round": ops.deque_rounds,
            "counting_spmm": semiring_spmm.counting_launches,
            "minplus_spmv": semiring_spmm.minplus_launches,
            "bfs_dense": semiring_spmm.bfs_launches,
            "flash_attention": flash_attention.f32_launches,
            "flash_attention_sm90": flash_attention.wgmma_launches,
            "decode_attention": decode_attention.launches}


def reset_launch_counts() -> None:
    """Set every launch count to 0."""
    frontier_expand.launches = 0
    frontier_expand.hop_launches = 0
    frontier_expand.fused_launches = 0
    ops.deque_rounds = 0
    semiring_spmm.counting_launches = 0
    semiring_spmm.minplus_launches = 0
    semiring_spmm.bfs_launches = 0
    flash_attention.f32_launches = 0
    flash_attention.wgmma_launches = 0
    decode_attention.launches = 0
