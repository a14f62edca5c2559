"""IDX-DFS as a chunked depth-first frontier walk (Algorithm 4), ported
from ``repro.core.enumerate``.

Partial results are rows of a fixed-width int32 matrix; one hop expands
every row of a chunk, and a LIFO deque of chunks keeps the walk depth
first (DESIGN.md §2).  Two expansion backends share the driver loop
(DESIGN.md §9): ``host`` runs ``_expand_chunk`` in numpy, ``device`` runs
K1's hop entry on the index's device.  Full unconstrained device walks
keep the work deque resident on the device (K2, ``_drive_resident``).
Paths, emission order, ``EnumStats`` and chunk boundaries are
bit-identical across backends and equal ``repro``'s.

Constrained queries (Appendix E, ``core.constraints``) carry one state
slot per partial through the host step; they run on the host, as in
``repro``.  Ranked (any-k) enumeration (DESIGN.md §10,
``order="hops"|"weight"``) replaces the LIFO chunk walk with a
priority-ordered frontier: the host runs a best-first heap over
partial-path lower bounds (``_drive_ranked_heap``), and ``order="hops"``
on the device drains integer hop-bound buckets through K1's hop entry
(``_drive_ranked_buckets``).  Both emit in non-decreasing ``(cost,
lexicographic sequence)`` order, so ``first_n`` returns the top n and a
deadline truncation is a rank-optimal prefix.
"""
from __future__ import annotations

import dataclasses
import heapq
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import clock, rank
from .graph import PAD
from .index import LightweightIndex, check_index_device

DEVICE_AUTO_MAX_K = 8
DEVICE_AUTO_MIN_EDGES = 2048


def resolve_backend(idx: LightweightIndex, backend: Optional[str],
                    constraint=None, order: Optional[str] = None) -> str:
    """Resolve a requested backend to the one that will run (DESIGN.md §9).

    A constrained query runs on the host (its state machines are host
    numpy), and so does ``order="weight"`` (float rank buckets do not
    exist; the device scheduler drains integer hop buckets).  ``auto``
    takes the device for small k and a dense-enough index when the index
    lives on a CUDA device (or ``REPRO_DEVICE_ENUM=force``);
    ``REPRO_DEVICE_ENUM=off|0`` runs every query on the host, explicit
    ``backend="device"`` requests included.
    """
    if backend is not None and backend not in ("host", "device", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    if os.environ.get("REPRO_DEVICE_ENUM", "").lower() in ("off", "0"):
        return "host"
    if backend is None or backend == "host":
        return "host"
    if constraint is not None or order == "weight":
        return "host"
    if backend == "device":
        return "device"
    if idx.k > DEVICE_AUTO_MAX_K:
        return "host"
    if idx.num_index_edges < DEVICE_AUTO_MIN_EDGES:
        return "host"
    if os.environ.get("REPRO_DEVICE_ENUM") == "force":
        return "device"
    return "device" if idx.device.type == "cuda" else "host"


class EngineLimit(RuntimeError):
    """Raised when a configured result/partial budget would be exceeded."""


@dataclasses.dataclass
class EnumStats:
    """The paper's Fig.-6 counters plus the number of chunks popped."""
    edges_accessed: int = 0
    invalid_partials: int = 0
    partials_generated: int = 0
    results: int = 0
    chunks: int = 0

    def merge(self, other: "EnumStats") -> None:
        """Add another run's counters into this one."""
        self.edges_accessed += other.edges_accessed
        self.invalid_partials += other.invalid_partials
        self.partials_generated += other.partials_generated
        self.results += other.results
        self.chunks += other.chunks


@dataclasses.dataclass
class EnumResult:
    """Paths (PAD after the t column), their lengths, the count and
    stats; ``exhausted`` is False when stopped early."""
    paths: np.ndarray          # (r, k+1) int32
    lengths: np.ndarray        # (r,) int32, number of edges
    count: int                 # total results (== r unless count_only)
    stats: EnumStats
    exhausted: bool = True

    def as_tuples(self) -> List[Tuple[int, ...]]:
        """The paths as tuples of vertex ids, in result order."""
        return [tuple(int(x) for x in row[: ln + 1])
                for row, ln in zip(self.paths, self.lengths)]


def _expand_chunk(idx: LightweightIndex, paths: np.ndarray, depth: int,
                  stats: EnumStats):
    """One host hop for every row of ``paths`` (all at one depth).

    Returns None (no candidates) or ``(parent, pos, vnew, emit, cont)``.
    """
    k, t = idx.k, idx.t
    last = paths[:, depth].astype(np.int64)
    b = k - depth - 1
    begin = idx.fwd_begin[last]
    end = idx.fwd_end[last, max(b, 0)] if b >= 0 else begin
    cnt = (end - begin).astype(np.int64)
    total = int(cnt.sum())
    stats.edges_accessed += total
    if total == 0:
        stats.invalid_partials += paths.shape[0]
        return None
    parent = np.repeat(np.arange(paths.shape[0], dtype=np.int64), cnt)
    offs = np.zeros(paths.shape[0], dtype=np.int64)
    np.cumsum(cnt[:-1], out=offs[1:])
    pos = np.arange(total, dtype=np.int64) - offs[parent] + begin[parent]
    vnew = idx.fwd_dst[pos].astype(np.int32)

    prefix = paths[parent, : depth + 1]
    dup = (prefix == vnew[:, None]).any(axis=1)
    is_t = vnew == t
    emit = is_t & ~dup
    cont = ~is_t & ~dup

    stats.partials_generated += total
    stats.invalid_partials += int(dup.sum())
    alive = np.zeros(paths.shape[0], dtype=bool)
    alive[parent[emit | cont]] = True
    stats.invalid_partials += int((~alive).sum())
    return parent, pos, vnew, emit, cont


def enumerate_paths_idx(
    idx: LightweightIndex,
    chunk_size: int = 16384,
    count_only: bool = False,
    first_n: Optional[int] = None,
    max_results: Optional[int] = None,
    constraint=None,
    deadline: Optional[float] = None,
    backend: Optional[str] = None,
    order: Optional[str] = None,
    weights: Optional[np.ndarray] = None,
    device: torch.device | str = "cuda",
) -> EnumResult:
    """Enumerate P(s,t,k,G) from the light-weight index (Algorithm 4).

    ``device`` must be the index's device (the index fixes where its
    kernels run).  ``backend`` is ``"host"``/None (numpy), ``"device"``
    (the frontier kernel) or ``"auto"`` (`resolve_backend`).
    ``deadline`` is an absolute ``clock.now()`` timestamp checked between
    chunks; past it, the results so far return with ``exhausted=False``.
    ``first_n`` stops after exactly n results; ``max_results`` raises
    EngineLimit past the limit.

    ``constraint`` is an Appendix-E object (``core.constraints``) whose
    vectorized per-partial state rides the walk (host only).  ``order``
    switches to ranked enumeration: paths come back in non-decreasing
    hop count or edge-weight sum (``weights``, graph edge order), ties
    broken on the vertex sequence; ``first_n`` is then the top n.
    ``order`` and ``constraint`` together raise ValueError.
    """
    check_index_device(idx, device)
    spec = rank.make_rank_spec(order, weights)
    if spec is not None and constraint is not None:
        raise ValueError("order= cannot be combined with constraint= "
                         "(constrained ranked enumeration is not "
                         "supported; post-filter instead)")
    resolved = resolve_backend(idx, backend, constraint, order=order)
    if spec is None:
        if resolved == "device" and first_n is None \
                and max_results is None \
                and os.environ.get("REPRO_DEVICE_DEQUE", "").lower() \
                not in ("off", "0"):
            # full device walks keep the work deque on the device; anytime
            # contracts need per-chunk host decisions and take the host
            # loop
            return _drive_resident(idx, chunk_size=chunk_size,
                                   count_only=count_only, deadline=deadline)
        step = _device_step(idx) if resolved == "device" \
            else _host_step(idx, constraint)
        return _drive(idx, step, chunk_size=chunk_size,
                      count_only=count_only, first_n=first_n,
                      max_results=max_results, constraint=constraint,
                      deadline=deadline)
    if resolved == "device":
        return _drive_ranked_buckets(idx, _device_step(idx),
                                     chunk_size=chunk_size,
                                     count_only=count_only, first_n=first_n,
                                     max_results=max_results,
                                     deadline=deadline)
    return _drive_ranked_heap(idx, spec, chunk_size=chunk_size,
                              count_only=count_only, first_n=first_n,
                              max_results=max_results, deadline=deadline)


def _drive(idx: LightweightIndex, step, chunk_size: int, count_only: bool,
           first_n: Optional[int], max_results: Optional[int],
           deadline: Optional[float], constraint=None) -> EnumResult:
    """The backend-independent IDX-DFS driver: seeds the root chunk (and
    its constraint state) and runs `_drive_from`.

    ``step(paths, depth, stats, want_cont)`` does one hop for one chunk
    and returns None (chunk dead, stats updated) or ``(emit_rows,
    cont_rows)`` in emission order.  Under a ``constraint`` the step also
    takes the chunk's state, ``step(..., cstate)``, and returns
    ``(emit_rows, cont_rows, cont_state)``."""
    root = np.full((1, idx.k + 1), PAD, dtype=np.int32)
    root[0, 0] = idx.s
    cstate0 = constraint.init(1) if constraint is not None else None
    work: List[Tuple[np.ndarray, int, object]] = [(root, 0, cstate0)]
    return _drive_from(idx, step, work, EnumStats(), [], [], 0,
                       chunk_size=chunk_size, count_only=count_only,
                       first_n=first_n, max_results=max_results,
                       deadline=deadline, constraint=constraint)


def _drive_from(idx: LightweightIndex, step,
                work: List[Tuple[np.ndarray, int, object]],
                stats: EnumStats, out_paths: List[np.ndarray],
                out_lens: List[np.ndarray], count: int, chunk_size: int,
                count_only: bool, first_n: Optional[int],
                max_results: Optional[int], deadline: Optional[float],
                constraint=None) -> EnumResult:
    """`_drive`'s loop, resumable from mid-walk state (the resident
    deque's capacity-stall fallback rebuilds ``work`` and continues
    here).  ``work`` holds ``(paths, depth, constraint_state)`` chunks.
    Owns the LIFO walk, the deadline check, first_n's exact trim,
    max_results and the chunk_size split (a chunk's constraint state
    goes through ``constraint.slice`` with it)."""
    k = idx.k
    while work:
        if deadline is not None and clock.expired(deadline):
            return _finalize(idx, out_paths, out_lens, count, stats,
                             exhausted=False)
        paths, depth, cstate = work.pop()
        stats.chunks += 1
        args = (paths, depth, stats, depth + 1 < k)
        expanded = step(*args) if constraint is None \
            else step(*args, cstate)
        if expanded is None:
            continue
        emit_rows, cont_rows = expanded[:2]

        if emit_rows is not None and emit_rows.shape[0]:
            count += emit_rows.shape[0]
            stats.results += emit_rows.shape[0]
            if not count_only:
                out_paths.append(emit_rows)
                out_lens.append(np.full(emit_rows.shape[0], depth + 1,
                                        np.int32))
            if max_results is not None and count > max_results:
                raise EngineLimit(f"more than {max_results} results")
            if first_n is not None and count >= first_n:
                count = _trim_to_first_n(out_paths, out_lens, count,
                                         first_n, count_only, stats)
                return _finalize(idx, out_paths, out_lens, count, stats,
                                 exhausted=False)

        if cont_rows is not None and cont_rows.shape[0]:
            # split into chunks; push in reverse so earlier rows pop first
            starts = range(0, cont_rows.shape[0], chunk_size)
            for st in reversed(list(starts)):
                sl = slice(st, st + chunk_size)
                piece_cs = constraint.slice(expanded[2], sl) \
                    if constraint is not None else None
                work.append((cont_rows[sl], depth + 1, piece_cs))

    return _finalize(idx, out_paths, out_lens, count, stats, exhausted=True,
                     canonical=True)


def _host_step(idx: LightweightIndex, constraint=None):
    """The numpy expansion step: `_expand_chunk` folded to the driver's
    ``(emit_rows, cont_rows)`` contract, or with a ``constraint`` its
    Appendix-E machinery (extend, accept, gather) folded to
    ``(emit_rows, cont_rows, cont_state)``."""

    def step(paths, depth, stats, want_cont, cstate=None):
        expanded = _expand_chunk(idx, paths, depth, stats)
        if expanded is None:
            return None
        parent, pos, vnew, emit, cont = expanded

        if constraint is not None:
            cstate_new, keep = constraint.extend(cstate, parent,
                                                 idx.fwd_eid[pos], vnew)
            stats.invalid_partials += int(((emit | cont) & ~keep).sum())
            emit = emit & keep
            cont = cont & keep

        def rows_of(sel):
            rows = paths[parent[sel]].copy()
            rows[:, depth + 1] = vnew[sel]
            return rows

        emit_rows = None
        if emit.any():
            sel = np.nonzero(emit)[0]
            if constraint is not None:
                acc = constraint.accept(cstate_new, sel)
                stats.invalid_partials += int((~acc).sum())
                sel = sel[acc]
            if sel.size:
                emit_rows = rows_of(sel)
        cont_rows, cont_state = None, None
        if want_cont and cont.any():
            sel = np.nonzero(cont)[0]
            cont_rows = rows_of(sel)
            if constraint is not None:
                cont_state = constraint.gather(cstate_new, sel)
        if constraint is None:
            return emit_rows, cont_rows
        return emit_rows, cont_rows, cont_state

    return step


# Per-launch candidate-slot budget: a chunk whose rows × padded fan-out
# rectangle exceeds it is cut into contiguous row segments, so one hub
# vertex in a wide chunk cannot inflate the dense slot matrices past
# memory.  Segments concatenate in row order, so emission order holds.
DEVICE_SLOT_BUDGET = 1 << 19


def _fanout_segments(cnt: np.ndarray, budget: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) row segments whose rows × next-pow2(max
    fan-out) rectangles each fit the slot budget (single rows always
    form a valid segment)."""
    whole = 1 << (max(int(cnt.max(initial=0)), 1) - 1).bit_length()
    if cnt.shape[0] * whole <= budget:
        return [(0, cnt.shape[0])]
    segments: List[Tuple[int, int]] = []
    start, seg_max = 0, 1
    for i in range(cnt.shape[0]):
        c = max(int(cnt[i]), 1)
        new_max = max(seg_max, 1 << (c - 1).bit_length())
        if i > start and (i - start + 1) * new_max > budget:
            segments.append((start, i))
            start, seg_max = i, 1 << (c - 1).bit_length()
        else:
            seg_max = new_max
    segments.append((start, cnt.shape[0]))
    return segments


def _device_step(idx: LightweightIndex):
    """The device expansion step: one hop of K1 per fan-out segment of the
    chunk, its Fig.-6 counters and row counts read back in one small copy,
    then its rows (``ops.frontier_expand_readback``).  The host sizes
    segments off the offset arrays (which also shortcuts all-dead chunks
    without a launch)."""
    from ..kernels import ops as kops
    k, t = idx.k, idx.t
    dev = idx.device_arrays()

    def step(paths, depth, stats, want_cont):
        last = paths[:, depth].astype(np.int64)
        b = k - depth - 1
        cnt = (idx.fwd_end[last, b] - idx.fwd_begin[last]) if b >= 0 \
            else np.zeros(paths.shape[0], np.int64)
        if int(cnt.sum()) == 0:
            stats.invalid_partials += paths.shape[0]
            return None
        emit_parts: List[np.ndarray] = []
        cont_parts: List[np.ndarray] = []
        for lo, hi in _fanout_segments(cnt, DEVICE_SLOT_BUDGET):
            emit_rows, cont_rows, (edges, partials, invalid) = \
                kops.frontier_expand_readback(
                    paths[lo:hi], dev.begin, dev.end, dev.dst, depth=depth,
                    t=t, max_deg=max(int(cnt[lo:hi].max()), 1),
                    want_cont=want_cont)
            stats.edges_accessed += edges
            stats.partials_generated += partials
            stats.invalid_partials += invalid
            if emit_rows is not None:
                emit_parts.append(emit_rows)
            if cont_rows is not None:
                cont_parts.append(cont_rows)
        # one array per chunk, like the host step: _trim_to_first_n trims
        # only the driver's last appended block
        emit_out = np.concatenate(emit_parts) if emit_parts else None
        cont_out = np.concatenate(cont_parts) if cont_parts else None
        return emit_out, cont_out

    return step


def _drive_resident(idx: LightweightIndex, chunk_size: int,
                    count_only: bool,
                    deadline: Optional[float]) -> EnumResult:
    """Device-resident deque driver: the LIFO chunk stack lives in a
    device arena and ``ops.frontier_deque_round`` (K2) runs up to
    ``round_pops`` pop → expand → push iterations per host round trip.
    The host syncs once a round to drain the emitted paths, fold the
    counters into ``EnumStats`` and check the deadline.

    Bit-for-bit `_drive` + `_device_step` on every full enumeration.  An
    index whose padded rows × fan-out rectangle exceeds the slot budget
    never enters (the host-looped path segments wide chunks); a capacity
    stall mid-walk rebuilds the host work list from the arena and
    resumes `_drive_from`.
    """
    from ..kernels import ops as kops
    k, s, t = idx.k, idx.s, idx.t
    dev = idx.device_arrays()
    # the largest fan-out, on the index's device: a host scan of the
    # (n, k+1) offsets takes milliseconds at a million vertices
    max_deg = int((dev.end[:, k] - dev.begin).amax()) if idx.n else 0
    cfg = kops.deque_config(k + 1, chunk_size, max_deg)
    if max_deg == 0 or cfg.cap > DEVICE_SLOT_BUDGET \
            or chunk_size > cfg.arena_cap:
        return _drive(idx, _device_step(idx), chunk_size=chunk_size,
                      count_only=count_only, first_n=None, max_results=None,
                      deadline=deadline)

    stats = EnumStats()
    out_paths: List[np.ndarray] = []
    out_lens: List[np.ndarray] = []
    count = 0
    root = np.full((k + 1,), PAD, dtype=np.int32)
    root[0] = s
    arena, m_depth, m_len, top, n_chunks = \
        kops.frontier_deque_init(root, cfg=cfg, device=idx.device)

    while True:
        if deadline is not None and clock.expired(deadline):
            return _finalize(idx, out_paths, out_lens, count, stats,
                             exhausted=False)
        arena, m_depth, m_len, top, n_chunks, emitbuf, emitlen, n_emit, \
            counters, pops = kops.frontier_deque_round(
                arena, m_depth, m_len, top, n_chunks, dev.begin, dev.end,
                dev.dst, t, cfg=cfg)
        edges, partials, invalid, _, npop, ne, nc, ntop = torch.cat(
            [counters, pops.view(1), n_emit.view(1), n_chunks.view(1),
             top.view(1)]).tolist()
        stats.chunks += npop
        stats.edges_accessed += edges
        stats.partials_generated += partials
        stats.invalid_partials += invalid
        if ne:
            count += ne
            stats.results += ne
            if not count_only:
                out_paths.append(emitbuf[:ne].cpu().numpy())
                out_lens.append(emitlen[:ne].cpu().numpy())
        if nc == 0:
            break
        if npop == 0:
            # capacity stall: rebuild the host work list (meta slots
            # bottom → top; list.pop() then takes the top chunk first)
            rows = arena[:ntop].cpu().numpy()
            lens = m_len[:nc].cpu().numpy().astype(np.int64)
            depths = m_depth[:nc].cpu().numpy()
            starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
            work: List[Tuple[np.ndarray, int, object]] = [
                (rows[starts[j]:starts[j] + lens[j]], int(depths[j]), None)
                for j in range(nc)]
            return _drive_from(idx, _device_step(idx), work, stats,
                               out_paths, out_lens, count,
                               chunk_size=chunk_size, count_only=count_only,
                               first_n=None, max_results=None,
                               deadline=deadline)

    return _finalize(idx, out_paths, out_lens, count, stats,
                     exhausted=True, canonical=True)


def _drive_ranked_heap(idx: LightweightIndex, spec: "rank.RankSpec",
                       chunk_size: int, count_only: bool,
                       first_n: Optional[int], max_results: Optional[int],
                       deadline: Optional[float]) -> EnumResult:
    """Best-first host driver for ranked enumeration (DESIGN.md §10).

    Two heaps over the canonical ``(cost, sequence)`` key: *partials*,
    keyed by an admissible lower bound (accumulated cost plus
    ``rank.remaining_lower_bound`` at the frontier vertex), and
    *results*, keyed by exact cost.  The minimum result is emitted only
    once it provably precedes every completion of every live partial:
    for hops an exact tuple compare against the minimum partial, for
    weights a clearance of ``min bound − rank.weight_slack``.  Otherwise
    a batch of equal-depth partials is popped from the heap top and
    expanded through `_expand_chunk`; speculative expansion is safe
    because the gate alone decides emission order.

    ``first_n`` stops after the n-th emission (the top n); a deadline
    returns only the gated emissions, a rank-optimal prefix.
    """
    k, s = idx.k, idx.s
    stats = EnumStats()
    out_paths: List[np.ndarray] = []
    out_lens: List[np.ndarray] = []
    count = 0
    lb = rank.remaining_lower_bound(idx, spec)
    zero = 0.0 if spec.is_weight else 0

    root = np.full(k + 1, PAD, dtype=np.int32)
    root[0] = s
    tick = 0  # heap tiebreak, so comparison never reaches the ndarray
    # entry: (bound-or-cost, sequence tuple, tick, depth, row, acc)
    partials = [(zero + lb[s], (int(s),), tick, 0, root, zero)]
    results: List[Tuple] = []

    def gated(res_key, part_key):
        if spec.is_weight:
            return res_key[0] < part_key[0] - rank.weight_slack(part_key[0])
        return res_key[:2] < part_key[:2]

    while partials or results:
        if deadline is not None and clock.expired(deadline):
            return _finalize(idx, out_paths, out_lens, count, stats,
                             exhausted=False)
        if results and (not partials or gated(results[0], partials[0])):
            _cost, _seq, _tick, depth, row, _acc = heapq.heappop(results)
            if first_n is not None and count >= first_n:
                return _finalize(idx, out_paths, out_lens, count, stats,
                                 exhausted=False)
            count += 1
            stats.results += 1
            if not count_only:
                out_paths.append(row[None, :])
                out_lens.append(np.full(1, depth, np.int32))
            if max_results is not None and count > max_results:
                raise EngineLimit(f"more than {max_results} results")
            if first_n is not None and count >= first_n:
                return _finalize(idx, out_paths, out_lens, count, stats,
                                 exhausted=False)
            continue

        batch = [heapq.heappop(partials)]
        depth = batch[0][3]
        while partials and len(batch) < chunk_size \
                and partials[0][3] == depth:
            batch.append(heapq.heappop(partials))
        rows = np.stack([e[4] for e in batch])
        accs = np.asarray([e[5] for e in batch])
        stats.chunks += 1
        expanded = _expand_chunk(idx, rows, depth, stats)
        if expanded is None:
            continue
        parent, pos, vnew, emit, cont = expanded
        acc_new = accs[parent] + rank.edge_step_costs(idx, spec, pos)

        for i in np.nonzero(emit)[0]:
            p = int(parent[i])
            row = rows[p].copy()
            row[depth + 1] = vnew[i]
            tick += 1
            heapq.heappush(results, (acc_new[i],
                                     batch[p][1] + (int(vnew[i]),),
                                     tick, depth + 1, row, acc_new[i]))
        if depth + 1 < k:
            for i in np.nonzero(cont)[0]:
                p = int(parent[i])
                row = rows[p].copy()
                row[depth + 1] = vnew[i]
                tick += 1
                heapq.heappush(partials,
                               (acc_new[i] + lb[vnew[i]],
                                batch[p][1] + (int(vnew[i]),),
                                tick, depth + 1, row, acc_new[i]))

    return _finalize(idx, out_paths, out_lens, count, stats, exhausted=True)


def _drive_ranked_buckets(idx: LightweightIndex, step, chunk_size: int,
                          count_only: bool, first_n: Optional[int],
                          max_results: Optional[int],
                          deadline: Optional[float]) -> EnumResult:
    """Rank-bucketed device driver for ``order="hops"`` (DESIGN.md §10).

    Hop bounds are integers, so the best-first frontier collapses into
    buckets: a partial row with lower bound ``b = depth + dist_t[last]``
    lives in bucket ``b``.  Buckets drain in ascending order through the
    unchanged expansion ``step`` (K1's hop entry on the card): a child
    either emits (cost exactly ``b``) or re-buckets at ``depth+1 +
    dist_t[child] ≥ b``, so once bucket ``b`` is empty its emissions are
    the complete cost-``b`` stratum.  One lex sort per stratum gives the
    canonical ``(cost, sequence)`` order, bit-identical to the heap.

    ``first_n`` trims inside a sorted stratum; a deadline keeps only
    completed strata (the bucket in progress is discarded), again a
    rank-optimal prefix.
    """
    k, s = idx.k, idx.s
    stats = EnumStats()
    out_paths: List[np.ndarray] = []
    out_lens: List[np.ndarray] = []
    count = 0
    dist_t = idx.dist_t.astype(np.int64)

    root = np.full((1, k + 1), PAD, dtype=np.int32)
    root[0, 0] = s
    bucket_keys = [int(dist_t[s])]
    buckets = {int(dist_t[s]): [(root, 0)]}

    while bucket_keys:
        b = heapq.heappop(bucket_keys)
        pend = buckets.pop(b)
        stratum: List[np.ndarray] = []
        while pend:
            if deadline is not None and clock.expired(deadline):
                return _finalize(idx, out_paths, out_lens, count, stats,
                                 exhausted=False)
            rows, depth = pend.pop()
            stats.chunks += 1
            expanded = step(rows, depth, stats, depth + 1 < k)
            if expanded is None:
                continue
            emit_rows, cont_rows = expanded
            if emit_rows is not None and emit_rows.shape[0]:
                stratum.append(emit_rows)
            if cont_rows is not None and cont_rows.shape[0] \
                    and depth + 1 < k:
                nb = depth + 1 + dist_t[cont_rows[:, depth + 1]]
                for val in np.unique(nb):
                    sel = cont_rows[nb == val]
                    if int(val) == b:
                        dest = pend
                    else:
                        dest = buckets.setdefault(int(val), [])
                        if len(dest) == 0:
                            heapq.heappush(bucket_keys, int(val))
                    for st in range(0, sel.shape[0], chunk_size):
                        dest.append((sel[st:st + chunk_size], depth + 1))
        if not stratum:
            continue
        allr = np.concatenate(stratum, axis=0)
        allr = allr[np.lexsort(tuple(allr[:, j] for j in range(k, -1, -1)))]
        nres = allr.shape[0]
        count += nres
        stats.results += nres
        if not count_only:
            out_paths.append(allr)
            out_lens.append(np.full(nres, b, np.int32))
        if max_results is not None and count > max_results:
            raise EngineLimit(f"more than {max_results} results")
        if first_n is not None and count >= first_n:
            count = _trim_to_first_n(out_paths, out_lens, count, first_n,
                                     count_only, stats)
            return _finalize(idx, out_paths, out_lens, count, stats,
                             exhausted=False)

    return _finalize(idx, out_paths, out_lens, count, stats, exhausted=True)


def _trim_to_first_n(out_paths, out_lens, count, first_n, count_only,
                     stats) -> int:
    """Drop the over-emitted tail of the last chunk so exactly ``first_n``
    results come back.  Under ``order`` the emitters feed it in rank
    order, so the survivors are the top n; with ``order=None`` a
    truncated prefix stays in the plan's emission order."""
    excess = count - first_n
    if excess > 0:
        stats.results -= excess
        if not count_only:
            out_paths[-1] = out_paths[-1][:-excess]
            out_lens[-1] = out_lens[-1][:-excess]
        count = first_n
    return count


def _finalize(idx, out_paths, out_lens, count, stats, exhausted,
              canonical: bool = False) -> EnumResult:
    """Concatenate emitted blocks into an EnumResult.  ``canonical``
    applies the ``(length, sequence)`` sort, requested only for exhausted
    unranked results so every backend and plan returns the same ordered
    list (the ranked drivers emit in their own canonical order)."""
    k = idx.k
    if out_paths:
        paths = np.concatenate(out_paths, axis=0)
        lens = np.concatenate(out_lens, axis=0)
        if canonical and paths.shape[0] > 1:
            perm = rank.canonical_perm(paths, lens.astype(np.int64))
            paths = paths[perm]
            lens = lens[perm]
    else:
        paths = np.zeros((0, k + 1), dtype=np.int32)
        lens = np.zeros((0,), dtype=np.int32)
    return EnumResult(paths=paths, lengths=lens, count=count, stats=stats,
                      exhausted=exhausted)
