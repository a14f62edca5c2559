"""IDX-JOIN (Algorithm 6), ported from ``repro.core.join``: evaluate
Q[0:i*] and Q[i*:k] by frontier expansion, then sort-merge join them on
the cut vertex.

The ``(t,t)`` virtual self-loop of the relation construction (§3.1 rule
3) pads a partial that reaches t early, so the halves cover every path
length ≤ k in one evaluation.  The within-half simple-path check runs
during expansion, the cross-half check at join time.  The join itself
is host numpy; the join plan's hop-count DP (``hop_count_dp``) runs on
the device under ``backend="device"`` (DESIGN.md §9).  A constraint is
applied to full tuples at join time (``check_full``, Appendix E).

Ranked mode (DESIGN.md §10): ``order=`` keeps the same halves and the
same per-group join, but processes cut-key groups in ascending order of
a lower bound on their cheapest joinable result and gates emission on
the next group's bound, so anytime truncations are rank-optimal prefixes
and a full run returns the canonical ``(cost, sequence)`` order of the
DFS drivers.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from . import clock, estimator, rank
from .enumerate import (DEVICE_AUTO_MIN_EDGES, EngineLimit, EnumResult,
                        EnumStats, _finalize, _trim_to_first_n)
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
    groups.  ``constraint`` filters full tuples at join time.  ``order``
    switches to the ranked join (`_join_ranked`); ``order`` and
    ``constraint`` together raise ValueError.
    """
    k, s, t = idx.k, idx.s, idx.t
    if not 0 < cut < k:
        raise ValueError(f"cut must be in (0, k), got {cut}")
    spec = rank.make_rank_spec(order, weights)
    if spec is not None and constraint is not None:
        raise ValueError("order= cannot be combined with constraint= "
                         "(constrained ranked enumeration is not "
                         "supported; post-filter instead)")
    if spec is not None:
        return _join_ranked(idx, cut, spec, count_only=count_only,
                            first_n=first_n, max_partials=max_partials,
                            max_results=max_results, deadline=deadline)
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
            if constraint is not None:
                keep = constraint.check_full(idx, rows, lens)
                rows, lens = rows[keep], lens[keep]
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


# ---------------------------------------------------------------------------
# ranked join (DESIGN.md §10)
# ---------------------------------------------------------------------------

def _half_costs(idx: LightweightIndex, rows: np.ndarray,
                spec: "rank.RankSpec") -> np.ndarray:
    """Per-row cost of a (possibly t-padded) join half: the edges up to
    the first t (or the full width when t is absent), counted (int64) or
    weight-accumulated left to right (float64) like every driver."""
    t = idx.t
    is_t = rows == t
    has = is_t.any(axis=1)
    hops = np.where(has, np.argmax(is_t, axis=1),
                    rows.shape[1] - 1).astype(np.int64)
    if not spec.is_weight:
        return hops
    keys, vals = rank.index_edge_table(idx, spec.weights)
    n = np.int64(idx.n)
    costs = np.zeros(rows.shape[0], dtype=np.float64)
    for j in range(rows.shape[1] - 1):
        act = hops > j
        if not act.any():
            break
        q = rows[act, j].astype(np.int64) * n + rows[act, j + 1]
        costs[act] = costs[act] + vals[np.searchsorted(keys, q)]
    return costs


def _join_ranked(idx: LightweightIndex, cut: int, spec: "rank.RankSpec",
                 count_only: bool, first_n: Optional[int],
                 max_partials: Optional[int], max_results: Optional[int],
                 deadline: Optional[float]) -> EnumResult:
    """Ranked Algorithm 6: the same halves and per-group join, ordered
    group scheduling (DESIGN.md §10).

    Each realized cut key gets ``lb = min cost_a(key) + min
    cost_b(key)``, a lower bound on its cheapest joinable result; groups
    run in ascending ``(lb, key)`` order.  After any group, every result
    whose cost lies below the next group's bound (less
    ``rank.weight_slack`` for floats) can no longer be preceded, so a
    deadline or an early ``first_n`` emits exactly those, canonically
    sorted.  A full run sorts everything, equal to the DFS drivers.
    """
    k, s, t = idx.k, idx.s, idx.t
    stats = JoinStats()

    def _expired() -> bool:
        return deadline is not None and clock.expired(deadline)

    if _expired():
        return _finalize(idx, [], [], 0, stats, exhausted=False)

    ra = _expand_to_width(idx, np.array([s], np.int32), 0, cut + 1, stats,
                          max_partials)
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

    order_a = np.argsort(ra[:, cut], kind="stable")
    order_b = np.argsort(rb[:, 0], kind="stable")
    ra_s, rb_s = ra[order_a], rb[order_b]
    ka, kb = ra_s[:, cut], rb_s[:, 0]
    a_start = np.searchsorted(ka, keys, side="left")
    a_end = np.searchsorted(ka, keys, side="right")
    b_start = np.searchsorted(kb, keys, side="left")
    b_end = np.searchsorted(kb, keys, side="right")

    cost_a = _half_costs(idx, ra_s, spec)
    cost_b = _half_costs(idx, rb_s, spec)
    lb = np.full(keys.shape[0], np.inf, dtype=np.float64)
    for ki in range(keys.shape[0]):
        if b_end[ki] > b_start[ki]:
            lb[ki] = cost_a[a_start[ki]:a_end[ki]].min() \
                + cost_b[b_start[ki]:b_end[ki]].min()
    group_order = np.lexsort((keys, lb))

    acc_rows: List[np.ndarray] = []
    acc_lens: List[np.ndarray] = []
    acc_costs: List[np.ndarray] = []
    total = 0

    def _emit(threshold: float, exhausted: bool) -> EnumResult:
        """Emit the accumulated results safely below ``threshold`` (the
        least bound of the groups not run; inf once none remain), sorted
        canonically and first_n-trimmed."""
        if total == 0:
            return _finalize(idx, [], [], 0, stats, exhausted=exhausted)
        costs = np.concatenate(acc_costs)
        if np.isfinite(threshold):
            eff = threshold - rank.weight_slack(threshold) \
                if spec.is_weight else threshold
            safe = costs < eff
        else:
            safe = np.ones(costs.shape[0], dtype=bool)
        n_emit = int(safe.sum())
        if first_n is not None:
            n_emit = min(n_emit, first_n)
        stats.results = n_emit
        if count_only:
            return _finalize(idx, [], [], n_emit, stats,
                             exhausted=exhausted)
        rows = np.concatenate(acc_rows, axis=0)[safe]
        lens = np.concatenate(acc_lens)[safe]
        perm = rank.canonical_perm(rows, costs[safe])
        rows, lens = rows[perm][:n_emit], lens[perm][:n_emit]
        return _finalize(idx, [rows], [lens], n_emit, stats,
                         exhausted=exhausted)

    A_BLOCK = 256
    for j in range(group_order.shape[0]):
        ki = group_order[j]
        if not np.isfinite(lb[ki]):
            break                       # dead groups sort last
        if _expired():
            return _emit(float(lb[ki]), exhausted=False)
        na, nb = a_end[ki] - a_start[ki], b_end[ki] - b_start[ki]
        stats.pairs += int(na * nb)
        A = ra_s[a_start[ki]:a_end[ki]]
        B = rb_s[b_start[ki]:b_end[ki]]
        bi = B[:, 1:]
        bmask = bi != t
        for a0 in range(0, na, A_BLOCK):
            ai = A[a0:a0 + A_BLOCK, :cut]
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
            total += rows.shape[0]
            if max_results is not None and total > max_results:
                raise EngineLimit(f"more than {max_results} results")
            acc_rows.append(rows)
            acc_lens.append(lens)
            acc_costs.append(np.asarray(
                rank.path_costs(idx, rows, lens, spec), dtype=np.float64))
        nxt = float(lb[group_order[j + 1]]) \
            if j + 1 < group_order.shape[0] else np.inf
        # max(first_n, 1): first_n=0 still needs one result to exist
        # before the cut counts as truncation (as in the DFS drivers,
        # where an empty exhaustive run reports exhausted=True)
        if first_n is not None and total >= max(first_n, 1) \
                and np.isfinite(nxt):
            costs = np.concatenate(acc_costs)
            eff = nxt - rank.weight_slack(nxt) if spec.is_weight else nxt
            if int((costs < eff).sum()) >= first_n:
                return _emit(nxt, exhausted=False)

    exhausted = not (first_n is not None and total >= max(first_n, 1))
    return _emit(np.inf, exhausted=exhausted)
