"""Cardinality estimation (Section 6.2) and the cut search (Alg. 5),
ported from ``repro.core.estimator``.

* ``preliminary_estimate`` — Eq. 5 from the index's γ̂ statistics, host
  scalar math.
* ``walk_count_dp`` — the full-fledged estimator, Eq. 6/7 via the DP of
  Algorithm 5.  The host build runs in float64 over the index edge list.
  ``backend="device"`` runs the same DP through the semiring kernels
  (DESIGN.md §9): level masks from k min-plus relaxations (K4,
  ``ops.bfs_dense``) over the dense index adjacency built on the
  device, and one counting-semiring product (K3) per DP level.  float32
  accumulation is exact only below 2^24 (EXACT_COUNT_MAX), so a device
  build whose tables reach it promotes itself to the host build, and
  ``WalkCountDP.backend_used`` says which build produced the numbers.
  Below the bound the two builds are bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .index import LightweightIndex, check_index_device

EXACT_COUNT_MAX = float(1 << 24)

# dense-tile ceiling for the device DP: the kernels run on an (n, n)
# dense adjacency, so past this the host edge-list DP is used
DEVICE_DP_MAX_N = 2048


def preliminary_estimate(index: LightweightIndex) -> float:
    """Eq. 5 — estimated search-space size from γ̂ statistics."""
    total = 0.0
    prod = 1.0
    for j in range(index.k):
        prod *= float(index.gamma[j])
        total += prod
        if prod == 0.0:
            break
    return total


@dataclasses.dataclass
class WalkCountDP:
    """The DP tables and the §6.3 cost model derived from them."""
    k: int
    c_to: np.ndarray      # (k+1, n) float64, c_k^i(v)
    c_from: np.ndarray    # (k+1, n) float64, c_i^0(v)
    q_prefix: np.ndarray  # (k+1,) |Q[0:i]|
    q_suffix: np.ndarray  # (k+1,) |Q[i:k]|
    cut: int              # i* = argmin |Q[0:i]| + |Q[i:k]|
    t_dfs: float
    t_join: float
    q_total: float        # |Q| = δ_W
    # "host" (float64 edge-list DP) or "device" (semiring kernels; the
    # device build promotes itself to "host" when a count reaches
    # EXACT_COUNT_MAX, so "device" certifies exactness)
    backend_used: str = "host"

    @property
    def est_results(self) -> float:
        """The estimated result count (|Q|)."""
        return self.q_total


def _level_masks(index: LightweightIndex) -> np.ndarray:
    k = index.k
    ii = np.arange(k + 1)
    return ((index.dist_s[None, :] <= ii[:, None])
            & (index.dist_t[None, :] <= (k - ii)[:, None]))


def _index_edge_list(index: LightweightIndex):
    """Index edge list (eu, ev) as int64 arrays."""
    eu = np.repeat(np.arange(index.n, dtype=np.int64),
                   (index.fwd_end[:, index.k]
                    - index.fwd_begin).astype(np.int64))
    ev = index.fwd_dst.astype(np.int64)
    return eu, ev


def _finish_dp(k: int, c_to: np.ndarray, c_from: np.ndarray, t: int,
               backend_used: str) -> WalkCountDP:
    """The §6.3 cost model from the level tables, shared by both builds so
    equal tables give a bit-identical WalkCountDP."""
    q_prefix = c_from.sum(axis=1)
    q_suffix = c_to.sum(axis=1)
    cut = int(np.argmin(q_prefix + q_suffix))
    q_total = float(c_from[k, t])
    t_dfs = float(q_prefix[1:].sum())
    t_join = float(q_total + q_prefix[1:cut + 1].sum() + q_suffix[cut:].sum())
    return WalkCountDP(k=k, c_to=c_to, c_from=c_from, q_prefix=q_prefix,
                       q_suffix=q_suffix, cut=cut, t_dfs=t_dfs, t_join=t_join,
                       q_total=q_total, backend_used=backend_used)


def _dense_adjacency(index: LightweightIndex):
    """The index edges as dense (n, n) float32 matrices on the index's
    device: the min-plus weights (1.0 / inf) and the edge counts."""
    dev = index.device
    eu, ev = _index_edge_list(index)
    eu_t = torch.from_numpy(eu).to(dev)
    ev_t = torch.from_numpy(ev).to(dev)
    n = index.n
    inf = 1e9
    wadj = torch.full((n, n), inf, dtype=torch.float32, device=dev)
    wadj[eu_t, ev_t] = 1.0                 # multi-edges collapse for BFS
    amat = torch.zeros((n, n), dtype=torch.float32, device=dev)
    amat.index_put_((eu_t, ev_t), torch.ones(eu_t.shape[0], device=dev),
                    accumulate=True)
    return wadj, amat, inf


def device_index_distances(index: LightweightIndex):
    """(dist_s, dist_t) by min-plus BFS (K4, ``ops.bfs_dense``) over the
    dense index adjacency on the index's device, as int64 host arrays
    with the k+1 sentinel.  Exact on every index vertex: some shortest
    s→v (v→t) path lies inside the index (the §3.2 closure argument)."""
    wadj, _amat, inf = _dense_adjacency(index)
    return _bfs_levels(index, wadj, inf)


def _bfs_levels(index: LightweightIndex, wadj: torch.Tensor, inf: float):
    from ..kernels import ops as kops
    k = index.k
    dd_s = kops.bfs_dense(wadj, index.s, k, inf=inf)
    dd_t = kops.bfs_dense(wadj, index.t, k, inf=inf, transposed=True)
    dist_s = torch.clamp(dd_s, max=k + 1).to(torch.int64)
    dist_t = torch.clamp(dd_t, max=k + 1).to(torch.int64)
    return dist_s.cpu().numpy(), dist_t.cpu().numpy()


def _walk_count_dp_device(index: LightweightIndex) -> Optional[WalkCountDP]:
    """Alg. 5 through the semiring kernels on the index's device.  Returns
    None when a level count reaches EXACT_COUNT_MAX (the caller promotes
    to the host float64 build)."""
    from ..kernels.semiring_spmm import counting_spmm
    idx = index
    dev = idx.device
    k, t = idx.k, idx.t
    wadj, a_fwd, inf = _dense_adjacency(idx)
    dist_s, dist_t = _bfs_levels(idx, wadj, inf)
    a_rev = a_fwd.T.contiguous()

    ds = torch.from_numpy(dist_s).to(dev)
    dt = torch.from_numpy(dist_t).to(dev)
    ii = torch.arange(k + 1, device=dev)
    lvl = (ds[None, :] <= ii[:, None]) & (dt[None, :] <= (k - ii)[:, None])

    # backward: c_to[i] = c_k^i, one counting product per level
    cur = lvl[k].to(torch.float32)
    c_to_levels = [cur]
    for i in range(k - 1, -1, -1):
        vec = torch.where(dt <= (k - i - 1), cur, 0.0)     # I_t budget
        contrib = counting_spmm(a_fwd, vec[:, None].contiguous())[:, 0]
        contrib[t] += cur[t]                               # (t,t) self-loop
        cur = torch.where(lvl[i], contrib, 0.0)
        c_to_levels.append(cur)
    c_to = torch.stack(c_to_levels[::-1]).double().cpu().numpy()

    # forward: c_from[i] = c_i^0, mirrored through A^T
    cur = lvl[0].to(torch.float32)
    c_from_levels = [cur]
    for i in range(1, k + 1):
        vec = torch.where(ds <= (i - 1), cur, 0.0)         # I_s budget
        contrib = counting_spmm(a_rev, vec[:, None].contiguous())[:, 0]
        contrib[t] += cur[t]
        cur = torch.where(lvl[i], contrib, 0.0)
        c_from_levels.append(cur)
    c_from = torch.stack(c_from_levels).double().cpu().numpy()

    # overflow fence: every partial sum is bounded by some level value
    # (non-negative terms), so scanning the tables covers the whole DP
    if max(c_to.max(initial=0.0), c_from.max(initial=0.0)) \
            >= EXACT_COUNT_MAX:
        return None
    return _finish_dp(k, c_to, c_from, t, backend_used="device")


def walk_count_dp(index: LightweightIndex, backend: Optional[str] = None,
                  device: torch.device | str = "cuda") -> WalkCountDP:
    """Alg. 5 / Eq. 6-7.  ``backend`` None/"host" is the float64 edge-list
    DP; "device" runs the semiring kernels on the index's device (which
    ``device`` must name) and promotes to the host build on float32
    overflow.  Both builds are bit-identical whenever the device build
    is returned."""
    if backend not in (None, "host", "device"):
        raise ValueError(f"unknown walk_count_dp backend {backend!r}")
    check_index_device(index, device)
    if backend == "device":
        dp = _walk_count_dp_device(index)
        if dp is not None:
            return dp
    idx = index
    n, k, t = idx.n, idx.k, idx.t
    lvl = _level_masks(idx)

    eu, ev = _index_edge_list(idx)
    du = idx.dist_s[eu].astype(np.int64)
    dv = idx.dist_t[ev].astype(np.int64)

    # backward: c_to[i] = c_k^i  (Alg. 5 lines 1-5)
    c_to = np.zeros((k + 1, n), dtype=np.float64)
    c_to[k, :] = np.where(lvl[k], 1.0, 0.0)
    for i in range(k - 1, -1, -1):
        nxt = c_to[i + 1]
        contrib = np.zeros(n, dtype=np.float64)
        m = dv <= (k - i - 1)
        np.add.at(contrib, eu[m], nxt[ev[m]])
        contrib[t] += nxt[t]           # virtual (t,t) self-loop (§3.1)
        c_to[i] = np.where(lvl[i], contrib, 0.0)

    # forward: c_from[i] = c_i^0  (Alg. 5 lines 6-10)
    c_from = np.zeros((k + 1, n), dtype=np.float64)
    c_from[0, :] = np.where(lvl[0], 1.0, 0.0)
    for i in range(1, k + 1):
        prv = c_from[i - 1]
        contrib = np.zeros(n, dtype=np.float64)
        m = du <= (i - 1)
        np.add.at(contrib, ev[m], prv[eu[m]])
        contrib[t] += prv[t]
        c_from[i] = np.where(lvl[i], contrib, 0.0)

    return _finish_dp(k, c_to, c_from, t, backend_used="host")
