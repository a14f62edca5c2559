"""IDX-JOIN (Algorithm 6), ported from ``repro.core.join``: evaluate
Q[0:i*] and Q[i*:k] by frontier expansion, then sort-merge join them on
the cut vertex.

The ``(t,t)`` virtual self-loop of the relation construction (§3.1 rule
3) pads a partial that reaches t early, so the halves cover every path
length ≤ k in one evaluation.  The within-half simple-path check runs
during expansion, the cross-half check at join time.  The join itself
is host numpy; the join plan's hop-count DP (``hop_count_dp``) runs on
the device under ``backend="device"`` (DESIGN.md §9).  Ranked joins
belong to a later slice of the port.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from . import clock, estimator, rank
from .enumerate import (CONSTRAINTS_LATER, DEVICE_AUTO_MIN_EDGES, EngineLimit,
                        EnumResult, EnumStats, _finalize, _trim_to_first_n)
from .graph import PAD
from .index import LightweightIndex


@dataclasses.dataclass
class JoinStats(EnumStats):
    """EnumStats plus the join's half sizes and candidate pairs."""
    ra_size: int = 0
    rb_size: int = 0
    pairs: int = 0


def resolve_join_backend(idx: LightweightIndex,
                         backend: Optional[str]) -> str:
    """Where the hop-count DP runs (the join column of the §9 matrix).

    ``device`` runs the semiring kernels, except for indexes wider than
    ``estimator.DEVICE_DP_MAX_N`` vertices (the kernels work on an
    (n, n) dense adjacency); ``auto`` additionally needs a dense-enough
    index on a CUDA device (or ``REPRO_DEVICE_ENUM=force``);
    ``REPRO_DEVICE_ENUM=off|0`` forces the host.
    """
    if backend is not None and backend not in ("host", "device", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    if os.environ.get("REPRO_DEVICE_ENUM", "").lower() in ("off", "0"):
        return "host"
    if backend is None or backend == "host":
        return "host"
    if idx.n > estimator.DEVICE_DP_MAX_N:
        return "host"
    if backend == "device":
        return "device"
    if idx.num_index_edges < DEVICE_AUTO_MIN_EDGES:
        return "host"
    if os.environ.get("REPRO_DEVICE_ENUM") == "force":
        return "device"
    return "device" if idx.device.type == "cuda" else "host"


def hop_count_dp(idx: LightweightIndex, backend: Optional[str] = None
                 ) -> estimator.WalkCountDP:
    """The join plan's hop-count DP (Alg. 5) where `resolve_join_backend`
    puts it, on the index's device; bit-identical across backends."""
    return estimator.walk_count_dp(
        idx, backend=resolve_join_backend(idx, backend), device=idx.device)


def _expand_to_width(idx: LightweightIndex, start_vertices: np.ndarray,
                     start_pos: int, width: int, stats: EnumStats,
                     max_partials: Optional[int]) -> np.ndarray:
    """All walk tuples of ``width`` vertices starting at position
    ``start_pos`` from the start vertices, t-padded (Alg. 6 Search), with
    the within-half duplicate check (padding t exempt)."""
    k, t = idx.k, idx.t
    rows = np.full((start_vertices.shape[0], width), PAD, dtype=np.int32)
    rows[:, 0] = start_vertices
    for d in range(width - 1):
        last = rows[:, d].astype(np.int64)
        finished = rows[:, d] == t
        b = k - start_pos - d - 1
        begin = idx.fwd_begin[last]
        end = idx.fwd_end[last, b] if b >= 0 else begin
        cnt = np.where(finished, 1, (end - begin)).astype(np.int64)
        stats.edges_accessed += int(cnt[~finished].sum())
        total = int(cnt.sum())
        if total == 0:
            return rows[:0, :]
        if max_partials is not None and total > max_partials:
            raise EngineLimit(f"join half exceeded {max_partials} partials")
        parent = np.repeat(np.arange(rows.shape[0], dtype=np.int64), cnt)
        offs = np.zeros(rows.shape[0], dtype=np.int64)
        np.cumsum(cnt[:-1], out=offs[1:])
        slot = np.arange(total, dtype=np.int64) - offs[parent]
        vnew = np.where(
            finished[parent], t,
            idx.fwd_dst[np.minimum(begin[parent] + slot,
                                   idx.fwd_dst.shape[0] - 1)]
            if idx.fwd_dst.size else t).astype(np.int32)
        new_rows = rows[parent].copy()
        new_rows[:, d + 1] = vnew
        dup = ((new_rows[:, : d + 1] == vnew[:, None]).any(axis=1)
               & (vnew != t))
        stats.partials_generated += total
        stats.invalid_partials += int(dup.sum())
        rows = new_rows[~dup]
        if rows.shape[0] == 0:
            return rows
    return rows


def enumerate_paths_join(
    idx: LightweightIndex,
    cut: int,
    count_only: bool = False,
    first_n: Optional[int] = None,
    max_partials: Optional[int] = None,
    max_results: Optional[int] = None,
    constraint=None,
    deadline: Optional[float] = None,
    order: Optional[str] = None,
    weights: Optional[np.ndarray] = None,
    _shared_ra=None,
) -> EnumResult:
    """Algorithm 6 with cut position ``cut`` (i*).

    ``_shared_ra`` is the cross-query sharing hook (DESIGN.md §13): a
    callable ``(stats, max_partials) -> ndarray`` that stands in for the
    R_a half expansion, deriving the same width-``cut+1`` relation (same
    rows, same stats, same ``EngineLimit``) from a group's shared prefix
    walk (``core.sharing``).  R_b and the join are unchanged.

    ``first_n`` evaluates both halves but stops emitting after exactly n
    results (``exhausted=False``); ``deadline`` (absolute
    ``clock.now()``) is checked before each half and between cut-key
    groups.  ``constraint`` and ``order`` belong to a later slice.
    """
    k, s, t = idx.k, idx.s, idx.t
    if not 0 < cut < k:
        raise ValueError(f"cut must be in (0, k), got {cut}")
    rank.make_rank_spec(order, weights)
    if constraint is not None:
        raise NotImplementedError(CONSTRAINTS_LATER)
    stats = JoinStats()

    def _expired() -> bool:
        return deadline is not None and clock.expired(deadline)

    if _expired():
        return _finalize(idx, [], [], 0, stats, exhausted=False)

    if _shared_ra is not None:
        ra = _shared_ra(stats, max_partials)
    else:
        ra = _expand_to_width(idx, np.array([s], np.int32), 0, cut + 1,
                              stats, max_partials)
    stats.ra_size = ra.shape[0]
    if ra.shape[0] == 0:
        return _finalize(idx, [], [], 0, stats, exhausted=True)
    if _expired():
        return _finalize(idx, [], [], 0, stats, exhausted=False)

    keys = np.unique(ra[:, cut])
    rb = _expand_to_width(idx, keys.astype(np.int32), cut, k - cut + 1, stats,
                          max_partials)
    stats.rb_size = rb.shape[0]
    if rb.shape[0] == 0:
        return _finalize(idx, [], [], 0, stats, exhausted=True)

    # sort-merge join on the cut vertex
    order_a = np.argsort(ra[:, cut], kind="stable")
    order_b = np.argsort(rb[:, 0], kind="stable")
    ra_s, rb_s = ra[order_a], rb[order_b]
    ka, kb = ra_s[:, cut], rb_s[:, 0]

    out_paths: List[np.ndarray] = []
    out_lens: List[np.ndarray] = []
    count = 0
    a_start = np.searchsorted(ka, keys, side="left")
    a_end = np.searchsorted(ka, keys, side="right")
    b_start = np.searchsorted(kb, keys, side="left")
    b_end = np.searchsorted(kb, keys, side="right")

    A_BLOCK = 256  # bounds the (na_blk, nb, cut, k-cut) clash tensor
    for ki in range(keys.shape[0]):
        if _expired():
            return _finalize(idx, out_paths, out_lens, count, stats,
                             exhausted=False)
        na, nb = a_end[ki] - a_start[ki], b_end[ki] - b_start[ki]
        if na == 0 or nb == 0:
            continue
        stats.pairs += int(na * nb)
        A = ra_s[a_start[ki]:a_end[ki]]
        B = rb_s[b_start[ki]:b_end[ki]]
        bi = B[:, 1:]
        bmask = bi != t
        for a0 in range(0, na, A_BLOCK):
            ai = A[a0:a0 + A_BLOCK, :cut]
            # cross-half check: a non-t prefix vertex must not reappear
            # in the suffix interior
            clash = ((ai[:, None, :, None] == bi[None, :, None, :])
                     & (ai != t)[:, None, :, None]
                     & bmask[None, :, None, :]).any(axis=(2, 3))
            ia, ib = np.nonzero(~clash)
            if ia.size == 0:
                continue
            tuples = np.concatenate([ai[ia], B[ib]], axis=1)
            lens = np.argmax(tuples == t, axis=1).astype(np.int32)
            rows = tuples.copy()
            rows[np.arange(k + 1)[None, :] > lens[:, None]] = PAD
            count += rows.shape[0]
            stats.results += rows.shape[0]
            if max_results is not None and count > max_results:
                raise EngineLimit(f"more than {max_results} results")
            if not count_only:
                out_paths.append(rows)
                out_lens.append(lens)
            if first_n is not None and count >= first_n:
                count = _trim_to_first_n(out_paths, out_lens, count,
                                         first_n, count_only, stats)
                return _finalize(idx, out_paths, out_lens, count, stats,
                                 exhausted=False)

    return _finalize(idx, out_paths, out_lens, count, stats, exhausted=True,
                     canonical=True)
