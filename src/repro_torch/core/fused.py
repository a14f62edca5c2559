"""Fused multi-query device enumeration (DESIGN.md §9), ported from
``repro.core.fused``.

Every expansion round pops one chunk from each active query's LIFO work
list, tags the rows with the query's member rank and expands them all
through one ``ops.frontier_expand_fused`` dispatch (kernel K5 on a CUDA
device, its plain version on the CPU).  Each member hands the kernel its
own index's device arrays; nothing is concatenated per round.  With the
recorder of ``core.trace`` on, each round is a ``fused.round`` span with
children ``fused.pop``, ``fused.pack``, ``fused.readback`` (the counts'
host read, the two row copies and their split over the members) and
``fused.tail``.

Per-query semantics are `core.enumerate._drive`'s, replicated exactly:

* each query owns its LIFO work list, popped in the order of a solo run,
  so its ``stats.chunks``, emission blocks and ``first_n`` prefix do not
  depend on its co-members;
* the zero-fanout host shortcut, the ``DEVICE_SLOT_BUDGET`` fan-out
  segments (over the packed rows), the reversed ``chunk_size`` pushes,
  the per-member ``first_n`` trim, the canonical sort when exhausted and
  one deadline check per round all match the solo driver;
* the Fig.-6 counters come back as the members' rows of K5's (m, 4)
  counter matrix, equal to each query's solo run.

Constrained, ranked or join-plan queries never reach this module:
``core.batch.BatchPathEnum`` decides which queries fuse.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..kernels import ops as kops
from ..kernels.frontier_expand import fused_member_table
from . import clock, trace
from .enumerate import (DEVICE_SLOT_BUDGET, EnumResult, EnumStats,
                        _fanout_segments, _finalize, _trim_to_first_n)
from .graph import PAD
from .index import LightweightIndex


class _MemberState:
    """One query's private driver state inside a fused run."""
    __slots__ = ("idx", "dev", "table_row", "stats", "out_paths",
                 "out_lens", "count", "work", "result")

    def __init__(self, idx: LightweightIndex) -> None:
        self.idx = idx
        self.dev = idx.device_arrays()
        # this member's row of K5's member table, built once: it holds the
        # arrays' addresses, which stay valid while the index lives
        self.table_row = fused_member_table(
            [self.dev.begin], [self.dev.end], [self.dev.dst],
            k1max=idx.k + 1, device=self.dev.begin.device)[0]
        self.stats = EnumStats()
        self.out_paths: List[np.ndarray] = []
        self.out_lens: List[np.ndarray] = []
        self.count = 0
        root = np.full((1, idx.k + 1), PAD, dtype=np.int32)
        root[0, 0] = idx.s
        self.work: List[Tuple[np.ndarray, int]] = [(root, 0)]
        self.result: Optional[EnumResult] = None

    def finish(self, exhausted: bool, canonical: bool = False) -> None:
        self.result = _finalize(self.idx, self.out_paths, self.out_lens,
                                self.count, self.stats, exhausted=exhausted,
                                canonical=canonical)


def _count_k5_inputs(lo: int, hi: int, members, totals: List[int],
                     packed_cnt: np.ndarray) -> None:
    """Count for the recorder what K5's inputs hold in the packed rows
    ``[lo, hi)``: ``k5.candidate_edges`` (a member's total where the
    rows hold all of its chunk) and ``k5.prefix_bytes`` (each row's
    prefix to its depth, int32)."""
    edges = prefix = start = 0
    for (_st, paths, depth, _cnt), total in zip(members, totals):
        end = start + paths.shape[0]
        a, b = max(lo, start), min(hi, end)
        if b > a:
            prefix += 4 * (b - a) * (depth + 1)
            edges += total if (a, b) == (start, end) \
                else int(packed_cnt[a:b].sum())
        start = end
    trace.count("k5.candidate_edges", edges)
    trace.count("k5.prefix_bytes", prefix)


def enumerate_fused_device(
    indexes: List[LightweightIndex],
    chunk_size: int = 16384,
    count_only: bool = False,
    first_n: Optional[int] = None,
    deadline: Optional[float] = None,
) -> List[EnumResult]:
    """Enumerate many queries' P(s,t,k,G) through fused launches on their
    indexes' device.

    Returns one ``EnumResult`` per index, in input order, each equal
    (paths and order, count, stats with ``chunks``, ``exhausted``) to a
    solo ``enumerate_paths_idx(idx)`` run.  All indexes must come from
    one graph (equal ``n``) and live on one device.  ``first_n`` is per
    query; the ``deadline`` (absolute ``clock.now()``) is checked once a
    round and finishes every unfinished member with ``exhausted=False``.
    """
    if not indexes:
        return []
    n = indexes[0].n
    if any(ix.n != n for ix in indexes):
        raise ValueError("fused launches require one common graph")
    if any(ix.device != indexes[0].device for ix in indexes):
        raise ValueError("fused launches require one common device")
    states = [_MemberState(ix) for ix in indexes]
    k1max = max(ix.k for ix in indexes) + 1

    while True:
        active = [st for st in states if st.result is None]
        if not active:
            break
        if deadline is not None and clock.expired(deadline):
            for st in active:
                st.finish(exhausted=False)
            break

        with trace.span("fused.round"):
            with trace.span("fused.pop"):
                # pop one chunk per active member; the host zero-fanout
                # shortcut (solo: _device_step returns None without a
                # launch) keeps dead chunks out of the dispatch
                members: List[Tuple[_MemberState, np.ndarray, int,
                                    np.ndarray]] = []
                totals: List[int] = []    # each member's candidate edges
                for st in active:
                    paths, depth = st.work.pop()
                    st.stats.chunks += 1
                    k = st.idx.k
                    last = paths[:, depth].astype(np.int64)
                    b = k - depth - 1
                    if b >= 0:
                        cnt = st.idx.fwd_end[last, b] - st.idx.fwd_begin[last]
                    else:
                        cnt = np.zeros(paths.shape[0], np.int64)
                    total = int(cnt.sum())
                    if total == 0:
                        st.stats.invalid_partials += paths.shape[0]
                        if not st.work:
                            st.finish(exhausted=True, canonical=True)
                        continue
                    members.append((st, paths, depth, cnt))
                    totals.append(total)
            if not members:
                continue

            with trace.span("fused.pack"):
                packed, ranks = [], []
                for i, (st, paths, _depth, _cnt) in enumerate(members):
                    if paths.shape[1] < k1max:
                        paths = np.pad(paths,
                                       ((0, 0), (0, k1max - paths.shape[1])),
                                       constant_values=PAD)
                    packed.append(paths)
                    ranks.append(np.full(paths.shape[0], i, np.int32))
                packed_paths = np.concatenate(packed, axis=0)
                rank = np.concatenate(ranks)
                packed_cnt = np.concatenate([cnt for *_, cnt in members])
                tvec = np.array([st.idx.t for st, *_ in members], np.int32)
                depthv = np.array([d for _, _, d, _ in members], np.int32)
                wantc = np.array([d + 1 < st.idx.k
                                  for st, _, d, _ in members])
                begins = [st.dev.begin for st, *_ in members]
                ends = [st.dev.end for st, *_ in members]
                dsts = [st.dev.dst for st, *_ in members]
                table = np.stack([st.table_row for st, *_ in members])

            # the solo path's slot-budget segmentation, over the packed rows:
            # a hub member splits the round into several dispatches exactly
            # as it would have split its own solo chunk
            emit_parts: List[List[np.ndarray]] = [[] for _ in members]
            cont_parts: List[List[np.ndarray]] = [[] for _ in members]
            m = len(members)
            for lo, hi in _fanout_segments(packed_cnt, DEVICE_SLOT_BUDGET):
                if trace.enabled():
                    _count_k5_inputs(lo, hi, members, totals, packed_cnt)
                emit_rows, cont_rows, n_emit_m, n_cont_m, counters = \
                    kops.frontier_expand_fused(
                        packed_paths[lo:hi], rank[lo:hi], tvec, depthv,
                        begins, ends, dsts, wantc,
                        max_deg=max(int(packed_cnt[lo:hi].max()), 1),
                        member_table=table)
                with trace.span("fused.readback"):
                    # one copy for the counts (the three are consecutive
                    # views of the dispatch's (6m,) head), one per row
                    # matrix
                    small = n_emit_m.as_strided((6 * m,), (1,)).cpu() \
                        .numpy().astype(np.int64)
                    ne_m, nc_m = small[:m], small[m:2 * m]
                    ctr = small[2 * m:].reshape(m, 4)
                    e_lo = np.concatenate([[0], np.cumsum(ne_m)])
                    c_lo = np.concatenate([[0], np.cumsum(nc_m)])
                    emit_np = emit_rows[:int(e_lo[-1])].cpu().numpy()
                    cont_np = cont_rows[:int(c_lo[-1])].cpu().numpy()
                    for i, (st, _paths, _depth, _cnt) in enumerate(members):
                        st.stats.edges_accessed += int(ctr[i, 0])
                        st.stats.partials_generated += int(ctr[i, 1])
                        st.stats.invalid_partials += int(ctr[i, 2])
                        w = st.idx.k + 1
                        if ne_m[i]:
                            emit_parts[i].append(
                                emit_np[e_lo[i]:e_lo[i + 1], :w])
                        if nc_m[i]:
                            cont_parts[i].append(
                                cont_np[c_lo[i]:c_lo[i + 1], :w])

            with trace.span("fused.tail"):
                # per-member driver tail: the exact _drive emit/push sequence
                for i, (st, _paths, depth, _cnt) in enumerate(members):
                    if emit_parts[i]:
                        emit_cat = np.concatenate(emit_parts[i], axis=0)
                        st.count += emit_cat.shape[0]
                        st.stats.results += emit_cat.shape[0]
                        if not count_only:
                            st.out_paths.append(emit_cat)
                            st.out_lens.append(np.full(emit_cat.shape[0],
                                                       depth + 1, np.int32))
                        if first_n is not None and st.count >= first_n:
                            st.count = _trim_to_first_n(
                                st.out_paths, st.out_lens, st.count, first_n,
                                count_only, st.stats)
                            st.finish(exhausted=False)
                            continue
                    if cont_parts[i]:
                        cont_cat = np.concatenate(cont_parts[i], axis=0)
                        pieces = range(0, cont_cat.shape[0], chunk_size)
                        for piece in reversed(list(pieces)):
                            rows = cont_cat[piece:piece + chunk_size]
                            st.work.append((rows, depth + 1))
                    if not st.work:
                        st.finish(exhausted=True, canonical=True)

    return [st.result for st in states]  # type: ignore[misc]
