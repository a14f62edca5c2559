"""K3 and K4: the semiring products of the device walk-count DP.

The full-fledged estimator (Alg. 5) runs on a dense ``(n, n)`` index
adjacency (DESIGN.md §9):

* ``minplus_spmv`` (K4) — one bounded-BFS relaxation,
  ``out[v] = min(dist[v], inf, min_u adj[u, v] + dist[u])``, looped k
  times by ``ops.bfs_dense`` to give the DP's level masks;
* ``counting_spmm`` (K3) — one DP level, ``out = A @ x`` over float32
  walk counts, exact while every partial sum stays below 2^24
  (``core.estimator.EXACT_COUNT_MAX``).

Counterparts of ``repro``'s Pallas kernels ``_minplus_kernel`` and
``_counting_kernel`` (``kernels/semiring_spmm.py``).  The CUDA source is
``csrc/semiring.cu``; it says what bounds each product on the card.
CUDA tensors launch the kernels, CPU tensors take the ``*_plain``
versions, and the two launch counters count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since process start (chip_smoke.py resets and reads them)
minplus_launches: int = 0
counting_launches: int = 0


def minplus_spmv_plain(adj: torch.Tensor, dist: torch.Tensor, *,
                       inf: float) -> torch.Tensor:
    """One min-plus relaxation in plain PyTorch (``ref.minplus_spmv_ref``)."""
    cand = (adj + dist[:, None]).amin(dim=0)
    return torch.minimum(dist, torch.clamp(cand, max=inf))


def counting_spmm_plain(adj: torch.Tensor,
                        counts: torch.Tensor) -> torch.Tensor:
    """One counting-semiring level in plain PyTorch
    (``ref.counting_spmm_ref``): ``adj @ counts`` in float32."""
    return adj.to(torch.float32) @ counts.to(torch.float32)


# output tile and K step of the q > 1 kernel (csrc/semiring.cu)
GEMM_TILE_ROWS = 128
GEMM_TILE_COLS = 128
GEMM_K_STEP = 32


def counting_splits(n: int, q: int, sms: int) -> tuple[int, int]:
    """``(splits, k_split)``: the K slices of the q > 1 kernel at (n, q) on
    a card of ``sms`` SMs.  As many slices as keep the output tiles times
    the slices within the SM count (one block per SM, no second wave),
    each slice ``k_split`` columns deep, a multiple of the K step and at
    least 128 when there is more than one; the slices cover [0, n) and
    none is empty."""
    def cdiv(a: int, b: int) -> int:
        return -(-a // b)

    tiles = cdiv(n, GEMM_TILE_ROWS) * cdiv(q, GEMM_TILE_COLS)
    splits = max(1, min(sms // tiles, n // 128))
    k_split = cdiv(cdiv(n, splits), GEMM_K_STEP) * GEMM_K_STEP
    return cdiv(n, k_split), k_split


def _lib() -> ctypes.CDLL:
    lib = _build.load("semiring")
    if lib.minplus_spmv_launch.argtypes is None:
        lib.minplus_spmv_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p])
        lib.minplus_spmv_launch.restype = ctypes.c_int
        lib.counting_spmm_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.counting_spmm_launch.restype = ctypes.c_int
    return lib


def _check_f32(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def minplus_spmv(adj: torch.Tensor, dist: torch.Tensor, *,
                 inf: float) -> torch.Tensor:
    """One bounded-BFS relaxation over a dense (n, n) float32 adjacency
    (1.0 for an edge, ``inf`` otherwise); ``dist`` (n,) float32."""
    global minplus_launches
    n = adj.shape[0]
    if adj.shape != (n, n) or dist.shape != (n,):
        raise ValueError(f"adj must be (n, n) and dist (n,), got "
                         f"{tuple(adj.shape)} and {tuple(dist.shape)}")
    _check_f32("adj", adj, adj.device)
    _check_f32("dist", dist, adj.device)
    if not adj.is_cuda:
        return minplus_spmv_plain(adj, dist, inf=inf)
    out = torch.empty_like(dist)
    status = _lib().minplus_spmv_launch(
        adj.data_ptr(), dist.data_ptr(), out.data_ptr(), n, inf,
        _build.stream(adj.device))
    _build.check(status, "minplus_spmv")
    minplus_launches += 1
    return out


def counting_spmm(adj: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """One walk-count DP level: (n, n) float32 counts @ (n, q) float32.

    On the card, q = 1 (the DP's shape) takes the GEMV kernel; q > 1 the
    SGEMM, split along K by ``counting_splits`` with the partials in a
    scratch this wrapper allocates and added in a fixed order."""
    global counting_launches
    n, q = counts.shape
    if adj.shape != (n, n):
        raise ValueError(f"adj must be ({n}, {n}), got {tuple(adj.shape)}")
    _check_f32("adj", adj, adj.device)
    _check_f32("counts", counts, adj.device)
    if not adj.is_cuda:
        return counting_spmm_plain(adj, counts)
    out = torch.empty((n, q), dtype=torch.float32, device=adj.device)
    splits, k_split, scratch = 1, n, 0
    if q > 1:
        sms = torch.cuda.get_device_properties(
            adj.device).multi_processor_count
        splits, k_split = counting_splits(n, q, sms)
        if splits > 1:
            part = torch.empty((splits, n, q), dtype=torch.float32,
                               device=adj.device)
            scratch = part.data_ptr()
    status = _lib().counting_spmm_launch(
        adj.data_ptr(), counts.data_ptr(), out.data_ptr(), scratch, n, q,
        splits, k_split, _build.stream(adj.device))
    _build.check(status, "counting_spmm")
    counting_launches += 1
    return out
