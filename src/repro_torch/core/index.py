"""The light-weight query-dependent index (Section 4.2 / Algorithm 3),
ported from ``repro.core.index``.

Semantics are ``repro``'s, field for field:

* ``dist_s[v] = S(s, v | G - {t})`` and ``dist_t[v] = S(v, t | G - {s})``.
* Index edges are the graph edges with ``dist_s[u] + 1 + dist_t[v] <= k``,
  ``v != s`` and ``u != t``; forward sorted by ``(u, dist_t[v])`` and
  addressed through ``fwd_begin`` (n,) / ``fwd_end`` (n, k+1), reverse
  sorted by ``(v, dist_s[u])``.
* ``gamma`` (k,) float64, the Eq.-5 statistic.

Two builds give identical indexes (tests/test_torch_index.py):
``build_index`` on the host in numpy, and ``build_index_device``, the
counterpart of ``repro``'s ``build_index_jax``, on a device in torch.
The device build computes ``gamma`` in float64 like the host build (the
JAX build uses float32), so the Eq.-5 estimate and the plan do not
depend on which build ran.  Sorting composes stable sorts: one stable
sort of the fused key ``primary * (k+2) + secondary`` orders exactly as
numpy's ``lexsort((secondary, primary))``.

The index's host fields stay numpy (the host drivers read them); an
index also records the ``device`` its kernels run on, and
``device_arrays()`` holds the forward index there as int32 tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import bfs
from .device import resolve_device
from .graph import Graph, from_edges


@dataclasses.dataclass
class DeviceIndexArrays:
    """Device int32 copies of the forward index for the frontier kernel
    (DESIGN.md §9): ``begin`` (n,), ``end`` (n, k+1) and ``dst`` (mf,)
    padded to a power of two (at least one element) with −1."""
    begin: torch.Tensor
    end: torch.Tensor
    dst: torch.Tensor

    def memory_bytes(self) -> int:
        """Bytes held on the device."""
        return sum(x.numel() * x.element_size()
                   for x in (self.begin, self.end, self.dst))


@dataclasses.dataclass
class LightweightIndex:
    """The index of one query (s, t, k): ``repro``'s fields plus the
    ``device`` its device-backend stages run on."""
    n: int
    k: int
    s: int
    t: int
    dist_s: np.ndarray        # (n,) int32, sentinel k+1
    dist_t: np.ndarray        # (n,) int32, sentinel k+1
    fwd_dst: np.ndarray       # (mf,) int32
    fwd_eid: np.ndarray       # (mf,) int64, original edge id
    fwd_begin: np.ndarray     # (n,) int64
    fwd_end: np.ndarray       # (n, k+1) int64
    rev_src: np.ndarray       # (mf,) int32
    rev_begin: np.ndarray     # (n,) int64
    rev_end: np.ndarray       # (n, k+1) int64
    level_count: np.ndarray   # (k+1,) int64, |C_i|
    gamma: np.ndarray         # (k,) float64
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))

    def it(self, v: int, b: int) -> np.ndarray:
        """I_t(v, b): neighbours v' of v with dist_t[v'] <= b."""
        if b < 0:
            return self.fwd_dst[0:0]
        b = min(b, self.k)
        return self.fwd_dst[self.fwd_begin[v]:self.fwd_end[v, b]]

    def is_(self, v: int, b: int) -> np.ndarray:
        """I_s(v, b): in-neighbours v' of v with dist_s[v'] <= b."""
        if b < 0:
            return self.rev_src[0:0]
        b = min(b, self.k)
        return self.rev_src[self.rev_begin[v]:self.rev_end[v, b]]

    @property
    def num_index_edges(self) -> int:
        """Number of index edges."""
        return int(self.fwd_dst.shape[0])

    @classmethod
    def from_numpy(cls, fields: dict,
                   device: torch.device | str = "cuda"
                   ) -> "LightweightIndex":
        """An index over plain numpy fields named as ``repro``'s
        ``LightweightIndex`` names them (e.g. ``dataclasses.asdict`` of
        one), whose device stages run on ``device``."""
        arrays = {name: np.asarray(fields[name]) for name in
                  ("dist_s", "dist_t", "fwd_dst", "fwd_eid", "fwd_begin",
                   "fwd_end", "rev_src", "rev_begin", "rev_end",
                   "level_count", "gamma")}
        return cls(n=int(fields["n"]), k=int(fields["k"]),
                   s=int(fields["s"]), t=int(fields["t"]),
                   device=resolve_device(device), **arrays)

    def device_arrays(self) -> DeviceIndexArrays:
        """The forward index as int32 tensors on the index's device, made
        once and kept on the index (indexes are immutable once built).
        ``dst`` pads to the next power of two with an inert −1."""
        cached = self.__dict__.get("_device_arrays")
        if cached is None:
            mf = max(int(self.fwd_dst.shape[0]), 1)
            dst = np.full(1 << (mf - 1).bit_length(), -1, np.int32)
            dst[: self.fwd_dst.shape[0]] = self.fwd_dst

            def put(a: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(
                    np.ascontiguousarray(a, dtype=np.int32)).to(self.device)
            cached = DeviceIndexArrays(begin=put(self.fwd_begin),
                                       end=put(self.fwd_end), dst=put(dst))
            self.__dict__["_device_arrays"] = cached
        return cached


def check_index_device(idx: LightweightIndex,
                       device: torch.device | str) -> torch.device:
    """Resolve ``device`` and require that it is the index's device."""
    dev = resolve_device(device)
    if dev != idx.device:
        raise ValueError(f"the index lives on {idx.device}, the call asked "
                         f"for {dev}")
    return dev


def _offsets_from_sorted(keys_primary: np.ndarray,
                         keys_secondary: np.ndarray, n: int,
                         k: int) -> Tuple[np.ndarray, np.ndarray]:
    """begin (n,), end (n, k+1) over arrays sorted by (primary, sec):
    ``begin[v]`` counts entries with primary < v and ``end[v, b]``
    also admits primary == v with secondary <= b."""
    width = np.int64(k + 2)
    fused = (keys_primary.astype(np.int64) * width
             + np.minimum(keys_secondary.astype(np.int64), k + 1))
    grid = np.arange(n, dtype=np.int64) * width
    begin = np.searchsorted(fused, grid, side="left")
    probes = grid[:, None] + np.arange(k + 1, dtype=np.int64)[None, :]
    end = np.searchsorted(fused, probes.reshape(-1),
                          side="right").reshape(n, k + 1)
    return begin, end


def build_index(graph: Graph, s: int, t: int, k: int,
                dist_fn=bfs.index_distances_np,
                edge_mask: Optional[np.ndarray] = None,
                device: torch.device | str = "cuda") -> LightweightIndex:
    """Algorithm 3, host build (numpy), for an index whose device stages
    run on ``device``.

    ``edge_mask`` (the Appendix-E predicate extension) filters edges
    whose entry is False before the distance BFS.
    """
    dev = resolve_device(device)
    g = graph
    if edge_mask is not None:
        keep = np.asarray(edge_mask, dtype=bool)
        g = from_edges(g.n, np.stack([g.esrc[keep], g.edst[keep]], axis=1),
                       dedup=False)
    dist_s, dist_t = dist_fn(g, s, t, k)
    dist_s = np.asarray(dist_s, dtype=np.int32)
    dist_t = np.asarray(dist_t, dtype=np.int32)

    u, v = g.esrc.astype(np.int64), g.edst.astype(np.int64)
    # Prop. 4.3 plus the relation rules of §3.1: no edge re-enters s and
    # no edge leaves t
    keep = ((dist_s[u] + 1 + dist_t[v]) <= k) & (v != s) & (u != t)
    keep_ids = np.nonzero(keep)[0]
    fu, fv = u[keep], v[keep]

    order_f = np.lexsort((dist_t[fv], fu))
    fu_s, fv_s = fu[order_f], fv[order_f]
    fwd_eid = keep_ids[order_f]
    fwd_begin, fwd_end = _offsets_from_sorted(fu_s, dist_t[fv_s], g.n, k)

    order_r = np.lexsort((dist_s[fu], fv))
    ru_s, rv_s = fu[order_r], fv[order_r]
    rev_begin, rev_end = _offsets_from_sorted(rv_s, dist_s[ru_s], g.n, k)

    ii = np.arange(k + 1)
    lvl = ((dist_s[None, :] <= ii[:, None])
           & (dist_t[None, :] <= (k - ii)[:, None]))
    level_count = lvl.sum(axis=1).astype(np.int64)

    gamma = np.zeros(k, dtype=np.float64)
    for j in range(k):
        cj = np.nonzero(lvl[j])[0]
        if cj.size:
            b = k - j - 1
            cnts = fwd_end[cj, b] - fwd_begin[cj]
            gamma[j] = float(cnts.mean())

    return LightweightIndex(
        n=g.n, k=k, s=s, t=t, dist_s=dist_s, dist_t=dist_t,
        fwd_dst=fv_s.astype(np.int32), fwd_eid=fwd_eid,
        fwd_begin=fwd_begin, fwd_end=fwd_end,
        rev_src=ru_s.astype(np.int32), rev_begin=rev_begin, rev_end=rev_end,
        level_count=level_count, gamma=gamma, device=dev)


# ---------------------------------------------------------------------------
# device build (the counterpart of repro's build_index_jax)
# ---------------------------------------------------------------------------

def _offsets_device(fused: torch.Tensor, n: int,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_offsets_from_sorted`` on a device, over the sorted fused keys."""
    width = k + 2
    grid = torch.arange(n, dtype=torch.int64, device=fused.device) * width
    begin = torch.searchsorted(fused, grid)
    probes = grid[:, None] + torch.arange(k + 1, device=fused.device)[None]
    end = torch.searchsorted(fused, probes.reshape(-1),
                             right=True).reshape(n, k + 1)
    return begin, end


def build_index_device(graph: Graph, s: int, t: int, k: int,
                       device: torch.device | str = "cuda"
                       ) -> LightweightIndex:
    """Algorithm 3 on ``device``: the BFS, the edge filter, the sorts, the
    offsets and the statistics all run there; the finished fields come
    back to the host once, and the forward index stays on the device as
    the index's ``device_arrays()``.  Identical to ``build_index``."""
    dev = resolve_device(device)
    n = graph.n
    dg = graph.to(dev)
    u, v = dg.esrc.long(), dg.edst.long()
    dist_s = bfs.bfs_edge_relax(u, v, n, k, s, t)
    dist_t = bfs.bfs_edge_relax(v, u, n, k, t, s)

    keep = ((dist_s[u] + 1 + dist_t[v]) <= k) & (v != s) & (u != t)
    keep_ids = torch.nonzero(keep).view(-1)
    fu, fv = u[keep_ids], v[keep_ids]
    width = k + 2

    # forward: sort by (u, dist_t[v]); the kept dist_t[v] is <= k - 1
    fkey = fu * width + dist_t[fv].long()
    fkey_s, order_f = torch.sort(fkey, stable=True)
    fv_s = fv[order_f]
    fwd_eid = keep_ids[order_f]
    fwd_begin, fwd_end = _offsets_device(fkey_s, n, k)

    # reverse: sort by (v, dist_s[u])
    rkey = fv * width + dist_s[fu].long()
    rkey_s, order_r = torch.sort(rkey, stable=True)
    ru_s = fu[order_r]
    rev_begin, rev_end = _offsets_device(rkey_s, n, k)

    ii = torch.arange(k + 1, device=dev)
    lvl = ((dist_s[None, :] <= ii[:, None])
           & (dist_t[None, :] <= (k - ii)[:, None]))
    level_count = lvl.sum(dim=1)

    # gamma_j = mean |I_t(v, k-j-1)| over C_j: an exact int64 sum over a
    # float64 count, as numpy's mean computes it on the host
    budgets = torch.arange(k - 1, -1, -1, device=dev)
    deg = (fwd_end.index_select(1, budgets)
           - fwd_begin[:, None]).T                        # (k, n)
    gsum = torch.where(lvl[:k], deg, 0).sum(dim=1)
    cnt = level_count[:k]
    gamma = torch.where(cnt > 0, gsum.double() / cnt.clamp(min=1).double(),
                        0.0)

    fwd_end32 = fwd_end.to(torch.int32)
    mf = max(int(fv_s.shape[0]), 1)
    dst = torch.full((1 << (mf - 1).bit_length(),), -1, dtype=torch.int32,
                     device=dev)
    dst[: fv_s.shape[0]] = fv_s.to(torch.int32)
    arrays = DeviceIndexArrays(begin=fwd_begin.to(torch.int32),
                               end=fwd_end32.contiguous(), dst=dst)

    def host(x: torch.Tensor, dtype) -> np.ndarray:
        return x.cpu().numpy().astype(dtype, copy=False)

    idx = LightweightIndex(
        n=n, k=k, s=s, t=t,
        dist_s=host(dist_s, np.int32), dist_t=host(dist_t, np.int32),
        fwd_dst=host(fv_s, np.int32), fwd_eid=host(fwd_eid, np.int64),
        fwd_begin=host(fwd_begin, np.int64), fwd_end=host(fwd_end, np.int64),
        rev_src=host(ru_s, np.int32), rev_begin=host(rev_begin, np.int64),
        rev_end=host(rev_end, np.int64),
        level_count=host(level_count, np.int64),
        gamma=host(gamma, np.float64), device=dev)
    idx.__dict__["_device_arrays"] = arrays
    return idx
