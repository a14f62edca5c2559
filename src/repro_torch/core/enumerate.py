"""IDX-DFS as a chunked depth-first frontier walk (Algorithm 4), ported
from ``repro.core.enumerate``.

Partial results are rows of a fixed-width int32 matrix; one hop expands
every row of a chunk, and a LIFO deque of chunks keeps the walk depth
first (DESIGN.md §2).  Two expansion backends share the driver loop
(DESIGN.md §9): ``host`` runs ``_expand_chunk`` in numpy, ``device`` runs
the frontier masks (K1) on the index's device.  Full unconstrained
device walks keep the work deque resident on the device (K2,
``_drive_resident``).  Paths, emission order, ``EnumStats`` and chunk
boundaries are bit-identical across backends and equal ``repro``'s.

Constrained (Appendix-E) and ranked enumeration belong to a later slice
of the port and raise NotImplementedError here.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import clock, rank
from .graph import PAD
from .index import LightweightIndex, check_index_device

DEVICE_AUTO_MAX_K = 8
DEVICE_AUTO_MIN_EDGES = 2048

CONSTRAINTS_LATER = ("constrained enumeration (constraint=) is not ported "
                     "yet; it belongs to the ranked/constrained slice of "
                     "the port (ROADMAP.md queue 1 item 5)")


def resolve_backend(idx: LightweightIndex, backend: Optional[str]) -> str:
    """Resolve a requested backend to the one that will run (DESIGN.md §9).

    ``auto`` takes the device for small k and a dense-enough index when
    the index lives on a CUDA device (or ``REPRO_DEVICE_ENUM=force``);
    ``REPRO_DEVICE_ENUM=off|0`` runs every query on the host, explicit
    ``backend="device"`` requests included.
    """
    if backend is not None and backend not in ("host", "device", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    if os.environ.get("REPRO_DEVICE_ENUM", "").lower() in ("off", "0"):
        return "host"
    if backend is None or backend == "host":
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
    EngineLimit past the limit.  ``constraint`` and ``order`` belong to a
    later slice and raise NotImplementedError.
    """
    check_index_device(idx, device)
    rank.make_rank_spec(order, weights)
    if constraint is not None:
        raise NotImplementedError(CONSTRAINTS_LATER)
    resolved = resolve_backend(idx, backend)
    if resolved == "device" and first_n is None and max_results is None \
            and os.environ.get("REPRO_DEVICE_DEQUE", "").lower() \
            not in ("off", "0"):
        # full device walks keep the work deque on the device; anytime
        # contracts need per-chunk host decisions and take the host loop
        return _drive_resident(idx, chunk_size=chunk_size,
                               count_only=count_only, deadline=deadline)
    step = _device_step(idx) if resolved == "device" else _host_step(idx)
    return _drive(idx, step, chunk_size=chunk_size, count_only=count_only,
                  first_n=first_n, max_results=max_results,
                  deadline=deadline)


def _drive(idx: LightweightIndex, step, chunk_size: int, count_only: bool,
           first_n: Optional[int], max_results: Optional[int],
           deadline: Optional[float]) -> EnumResult:
    """The backend-independent IDX-DFS driver: seeds the root chunk and
    runs `_drive_from`.  ``step(paths, depth, stats, want_cont)`` does one
    hop for one chunk and returns None (chunk dead, stats updated) or
    ``(emit_rows, cont_rows)`` in emission order."""
    root = np.full((1, idx.k + 1), PAD, dtype=np.int32)
    root[0, 0] = idx.s
    work: List[Tuple[np.ndarray, int]] = [(root, 0)]
    return _drive_from(idx, step, work, EnumStats(), [], [], 0,
                       chunk_size=chunk_size, count_only=count_only,
                       first_n=first_n, max_results=max_results,
                       deadline=deadline)


def _drive_from(idx: LightweightIndex, step,
                work: List[Tuple[np.ndarray, int]], stats: EnumStats,
                out_paths: List[np.ndarray], out_lens: List[np.ndarray],
                count: int, chunk_size: int, count_only: bool,
                first_n: Optional[int], max_results: Optional[int],
                deadline: Optional[float]) -> EnumResult:
    """`_drive`'s loop, resumable from mid-walk state (the resident
    deque's capacity-stall fallback rebuilds ``work`` and continues
    here).  Owns the LIFO walk, the deadline check, first_n's exact trim,
    max_results and the chunk_size split."""
    k = idx.k
    while work:
        if deadline is not None and clock.expired(deadline):
            return _finalize(idx, out_paths, out_lens, count, stats,
                             exhausted=False)
        paths, depth = work.pop()
        stats.chunks += 1
        expanded = step(paths, depth, stats, depth + 1 < k)
        if expanded is None:
            continue
        emit_rows, cont_rows = expanded

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
                work.append((cont_rows[st:st + chunk_size], depth + 1))

    return _finalize(idx, out_paths, out_lens, count, stats, exhausted=True,
                     canonical=True)


def _host_step(idx: LightweightIndex):
    """The numpy expansion step: `_expand_chunk` folded to the driver's
    ``(emit_rows, cont_rows)`` contract."""

    def step(paths, depth, stats, want_cont):
        expanded = _expand_chunk(idx, paths, depth, stats)
        if expanded is None:
            return None
        parent, _pos, vnew, emit, cont = expanded

        def rows_of(sel):
            rows = paths[parent[sel]].copy()
            rows[:, depth + 1] = vnew[sel]
            return rows

        emit_rows = rows_of(np.nonzero(emit)[0]) if emit.any() else None
        cont_rows = None
        if want_cont and cont.any():
            cont_rows = rows_of(np.nonzero(cont)[0])
        return emit_rows, cont_rows

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
            work: List[Tuple[np.ndarray, int]] = [
                (rows[starts[j]:starts[j] + lens[j]], int(depths[j]))
                for j in range(nc)]
            return _drive_from(idx, _device_step(idx), work, stats,
                               out_paths, out_lens, count,
                               chunk_size=chunk_size, count_only=count_only,
                               first_n=None, max_results=None,
                               deadline=deadline)

    return _finalize(idx, out_paths, out_lens, count, stats,
                     exhausted=True, canonical=True)


def _trim_to_first_n(out_paths, out_lens, count, first_n, count_only,
                     stats) -> int:
    """Drop the over-emitted tail of the last chunk so exactly ``first_n``
    results come back (the truncated prefix stays in emission order)."""
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
    results so every backend and plan returns the same ordered list."""
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
