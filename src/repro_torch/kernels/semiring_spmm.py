"""K3 and K4: the semiring products of the device walk-count DP.

The full-fledged estimator (Alg. 5) runs on a dense ``(n, n)`` index
adjacency (DESIGN.md §9):

* ``minplus_spmv`` (K4) — one bounded-BFS relaxation,
  ``out[v] = min(dist[v], inf, min_u adj[u, v] + dist[u])``, or with
  ``transposed=True`` the relaxation over ``adj``'s transpose read along
  ``adj``'s rows (the reverse BFS, with no transposed copy);
* ``bfs_dense`` (K4) — k such relaxations from one source, the DP's
  level masks (re-exported by ``ops``): on the card one launch for all k,
  on the CPU a loop of plain relaxations;
* ``counting_spmm`` (K3) — one DP level, ``out = A @ x`` over float32
  walk counts, exact while every partial sum stays below 2^24
  (``core.estimator.EXACT_COUNT_MAX``).

Counterparts of ``repro``'s Pallas kernels ``_minplus_kernel`` and
``_counting_kernel`` (``kernels/semiring_spmm.py``).  The CUDA source is
``csrc/semiring.cu``; it says what bounds each product on the card.
CUDA tensors launch the kernels, CPU tensors take the ``*_plain``
versions.  ``counting_launches`` counts K3's launches and
``minplus_launches`` every launch of K4's kernel, from either entry;
``bfs_launches`` counts those of ``bfs_dense`` alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

# kernel launches since process start (chip_smoke.py resets and reads them)
minplus_launches: int = 0
bfs_launches: int = 0
counting_launches: int = 0


def minplus_spmv_plain(adj: torch.Tensor, dist: torch.Tensor, *,
                       inf: float, transposed: bool = False) -> torch.Tensor:
    """One min-plus relaxation in plain PyTorch (``ref.minplus_spmv_ref``),
    over ``adj.T`` (a view) where ``transposed``."""
    if transposed:
        adj = adj.T
    cand = (adj + dist[:, None]).amin(dim=0)
    return torch.minimum(dist, torch.clamp(cand, max=inf))


def bfs_dense_plain(adj: torch.Tensor, src: int, k: int, *,
                    inf: float = 1e9, transposed: bool = False
                    ) -> torch.Tensor:
    """Bounded BFS in plain PyTorch: k plain relaxations from ``src``."""
    dist = torch.full((adj.shape[0],), inf, dtype=torch.float32,
                      device=adj.device)
    dist[src] = 0.0
    for _ in range(k):
        dist = minplus_spmv_plain(adj, dist, inf=inf, transposed=transposed)
    return dist


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
    if lib.minplus_launch.argtypes is None:
        lib.minplus_launch.argtypes = (
            [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p])
        lib.minplus_launch.restype = ctypes.c_int
        lib.counting_spmm_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.counting_spmm_launch.restype = ctypes.c_int
    return lib


# scratch of a K4 launch, in n-float rows: two level buffers and the
# partial mins of up to 16 row slices by parity (csrc/semiring.cu)
_MINPLUS_SCRATCH = 2 + 2 * 16


def _minplus_cuda(adj: torch.Tensor, dist: Optional[torch.Tensor], src: int,
                  k: int, inf: float, transposed: bool) -> torch.Tensor:
    """One launch of K4: ``k`` relaxations of ``dist`` (None: 0 at ``src``,
    ``inf`` elsewhere).  The output and the scratch are one allocation."""
    global minplus_launches
    n = adj.shape[0]
    buf = torch.empty((_MINPLUS_SCRATCH + 1) * n, dtype=torch.float32,
                      device=adj.device)
    status = _lib().minplus_launch(
        adj.data_ptr(), None if dist is None else dist.data_ptr(), src,
        buf.data_ptr(), buf[n:].data_ptr(), n, k, inf, int(transposed),
        _build.stream(adj.device))
    _build.check(status, "minplus")
    minplus_launches += 1
    return buf[:n]


def _check_f32(name: str, x: torch.Tensor, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_adj(adj: torch.Tensor) -> int:
    n = adj.shape[0]
    if adj.dim() != 2 or adj.shape != (n, n):
        raise ValueError(f"adj must be (n, n), got {tuple(adj.shape)}")
    _check_f32("adj", adj, adj.device)
    return n


def minplus_spmv(adj: torch.Tensor, dist: torch.Tensor, *, inf: float,
                 transposed: bool = False) -> torch.Tensor:
    """One bounded-BFS relaxation over a dense (n, n) float32 adjacency
    (1.0 for an edge, ``inf`` otherwise), over its transpose where
    ``transposed``; ``dist`` (n,) float32.  On the card, one launch of K4
    with k = 1."""
    n = _check_adj(adj)
    if dist.shape != (n,):
        raise ValueError(f"dist must be ({n},), got {tuple(dist.shape)}")
    _check_f32("dist", dist, adj.device)
    if not adj.is_cuda:
        return minplus_spmv_plain(adj, dist, inf=inf, transposed=transposed)
    return _minplus_cuda(adj, dist, 0, 1, inf, transposed)


def bfs_dense(adj: torch.Tensor, src: int, k: int, *, inf: float = 1e9,
              transposed: bool = False) -> torch.Tensor:
    """Bounded BFS over a dense (n, n) float32 adjacency (over its
    transpose where ``transposed``): k min-plus relaxations from ``src``;
    unreachable vertices keep ``inf``.  On the card one launch of K4 runs
    all k levels; on the CPU ``bfs_dense_plain`` loops."""
    global bfs_launches
    n = _check_adj(adj)
    if not -n <= src < n:
        raise IndexError(f"src {src} out of range for {n} vertices")
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    if not adj.is_cuda:
        return bfs_dense_plain(adj, src, k, inf=inf, transposed=transposed)
    out = _minplus_cuda(adj, None, src % n, k, inf, transposed)
    bfs_launches += 1
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
