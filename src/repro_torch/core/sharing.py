"""Cross-query structure sharing for BatchPathEnum (DESIGN.md §13), ported
from ``repro.core.sharing``: host numpy, as there, over indexes that
record the engine's device.

The batch engine shares *artifacts* across a batch — result dedup,
the index LRU, the stacked BFS — but every distinct ``(s, t, k)`` query
would still enumerate alone.  Batch HcPE (Yuan et al., arXiv:2312.01424)
shows that on skewed traffic the enumeration work itself is shared:
queries fanning out of one hub vertex walk the same prefixes.  This
module adds that level of sharing in two layers:

  * **Level A — merged group index.**  ``detect_groups`` partitions a
    batch's distinct keys by shared source (and, for construction
    sharing, shared target) under the same ``(graph_id, graph_version,
    edge_mask_hash)``.  ``build_member_indexes`` refactors Algorithm 3
    so the batch's per-query distance pruning becomes per-member
    *masks* over one shared edge arena (each member's
    ``LightweightIndex`` is still byte-identical to ``build_index``).
    ``MergedGroupIndex`` is the enumeration-time form: the union of
    the members' index edges sorted by ``(src, kmax - slack)`` so one
    offset lookup yields every edge *some* member could still use at a
    given depth, plus the per-member boolean masks.

  * **Level B — shared-prefix enumeration.**  ``run_shared_groups``
    walks the merged index's prefix tree *once* per shared-s group
    (``_walk_group``), capturing per-member candidate counts,
    dup-prune counts and emission/continuation edges.  Each DFS-plan
    member then *replays* the capture (``_replay_dfs``) — an exact
    re-enactment of the ``_drive`` chunk loop over tree node ids, so
    results, ``EnumStats`` and chunk boundaries are byte-identical to
    a solo run — and each join-plan member derives its R_a relation
    from the same capture (``_derive_join_ra``) and finishes through
    the unchanged sort-merge join.

Sharing is semantics-free by contract: ``sharing="off"`` (or the
``REPRO_SHARING=off`` escape hatch) must be byte-identical to sharing
on, and tests/test_torch_sharing.py holds every plan × grouping shape
to that and to ``repro``.  When a group is unprofitable or unsafe —
join members with ``first_n``, a walk past
``SHARING_MAX_NODES``, a deadline expiring mid-walk — the group falls
back to per-member enumeration (``SharingFallback``), never to an
approximation.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import clock
from .device import resolve_device
from .enumerate import EnumResult, EnumStats, EngineLimit, _finalize, \
    _trim_to_first_n
from .graph import Graph, PAD
from .index import LightweightIndex, _offsets_from_sorted
from .join import enumerate_paths_join

#: Union-walk node budget: a shared prefix tree larger than this falls
#: back to per-member enumeration (the capture's (N, M) count matrices
#: stop paying for themselves long before memory becomes a concern).
SHARING_MAX_NODES = 1 << 18

#: Largest member count one merged group serves; bigger buckets are
#: chunked so the (N, M) capture matrices and the per-chunk member loop
#: stay narrow.
GROUP_MAX_MEMBERS = 32


class SharingFallback(Exception):
    """Raised inside a shared walk to abandon the group and fall back to
    per-member enumeration (node budget exceeded, deadline expired).
    Never escapes ``run_shared_groups``."""


def resolve_sharing(value: Optional[str]) -> str:
    """Resolve a sharing knob to ``"auto"`` or ``"off"``.

    ``None`` means "engine default" and resolves like ``"auto"``.  The
    ``REPRO_SHARING`` environment variable is the operational escape
    hatch (DESIGN.md §13): ``off``/``0`` forces sharing off process-wide
    regardless of what the caller asked for — mirroring how
    ``REPRO_DEVICE_ENUM`` steers the backend fallback matrix.
    """
    if value is not None and value not in ("auto", "off"):
        raise ValueError(f"unknown sharing mode {value!r}")
    if os.environ.get("REPRO_SHARING", "").lower() in ("off", "0"):
        return "off"
    return "auto" if value is None else value


@dataclasses.dataclass
class QueryGroup:
    """One batch overlap group: member ``QueryKey``s sharing ``kind``
    (``"s"`` or ``"t"``) anchored at vertex ``anchor``."""
    kind: str
    anchor: int
    keys: List[tuple]


def detect_groups(keys: Sequence[tuple], kinds: Tuple[str, ...] = ("s", "t"),
                  min_size: int = 2,
                  max_size: int = GROUP_MAX_MEMBERS) -> List[QueryGroup]:
    """The grouping pass (DESIGN.md §13): partition distinct query keys
    into overlap groups.

    Keys are ``(graph_id, s, t, k, edge_mask_hash, graph_version)``
    tuples of one batch, so graph identity / mask / version already
    agree.  Shared-s buckets are formed first (they share the walk
    root), then shared-t buckets over the leftovers; buckets smaller
    than ``min_size`` stay solo and buckets larger than ``max_size``
    are chunked.  Deterministic: buckets and members keep first-seen
    order.
    """
    out: List[QueryGroup] = []
    remaining = list(keys)
    for kind, col in (("s", 1), ("t", 2)):
        if kind not in kinds:
            continue
        buckets: "collections.OrderedDict[int, List[tuple]]" = \
            collections.OrderedDict()
        for key in remaining:
            buckets.setdefault(int(key[col]), []).append(key)
        leftover: List[tuple] = []
        for anchor, members in buckets.items():
            if len(members) < min_size:
                leftover.extend(members)
                continue
            for lo in range(0, len(members), max_size):
                chunk = members[lo:lo + max_size]
                if len(chunk) >= min_size:
                    out.append(QueryGroup(kind=kind, anchor=anchor,
                                          keys=chunk))
                else:
                    leftover.extend(chunk)
        remaining = leftover
    return out


# ---------------------------------------------------------------------------
# Level A: shared construction — per-member masks over one edge arena
# ---------------------------------------------------------------------------

def _member_index_from_selection(n: int, k: int, s: int, t: int,
                                 dist_s: np.ndarray, dist_t: np.ndarray,
                                 u_sel: np.ndarray, v_sel: np.ndarray,
                                 orig_sel: np.ndarray,
                                 device: torch.device) -> LightweightIndex:
    """Assemble one member's ``LightweightIndex`` from its selected
    (u, v, original-edge-id) triples — the tail of Algorithm 3 with the
    keep-filter already applied.  The explicit ``orig`` tiebreak in both
    lexsorts reproduces ``build_index``'s stable sort over ascending
    edge ids, so the output is byte-identical no matter what order the
    selection arrives in."""
    order_f = np.lexsort((orig_sel, dist_t[v_sel], u_sel))
    fu_s, fv_s = u_sel[order_f], v_sel[order_f]
    fwd_eid = orig_sel[order_f]
    fwd_begin, fwd_end = _offsets_from_sorted(fu_s, dist_t[fv_s], n, k)

    order_r = np.lexsort((orig_sel, dist_s[u_sel], v_sel))
    ru_s, rv_s = u_sel[order_r], v_sel[order_r]
    rev_begin, rev_end = _offsets_from_sorted(rv_s, dist_s[ru_s], n, k)

    ii = np.arange(k + 1)
    lvl = (dist_s[None, :] <= ii[:, None]) \
        & (dist_t[None, :] <= (k - ii)[:, None])
    level_count = lvl.sum(axis=1).astype(np.int64)
    gamma = np.zeros(k, dtype=np.float64)
    for j in range(k):
        cj = np.nonzero(lvl[j])[0]
        if cj.size:
            b = k - j - 1
            cnts = fwd_end[cj, b] - fwd_begin[cj]
            gamma[j] = float(cnts.mean())

    return LightweightIndex(
        n=n, k=k, s=s, t=t, dist_s=dist_s, dist_t=dist_t,
        fwd_dst=fv_s.astype(np.int32), fwd_eid=fwd_eid.astype(np.int64),
        fwd_begin=fwd_begin, fwd_end=fwd_end,
        rev_src=ru_s.astype(np.int32), rev_begin=rev_begin, rev_end=rev_end,
        level_count=level_count, gamma=gamma, device=device)


def build_member_indexes(
        graph: Graph, triples: Sequence[Tuple[int, int, int]],
        dists: Sequence[Tuple[np.ndarray, np.ndarray]],
        device: torch.device | str = "cuda"
) -> List[LightweightIndex]:
    """Algorithm 3 refactored for a group (DESIGN.md §13): build every
    member's index over one shared edge arena.

    The per-query build filters the whole edge list per query; here the
    edge arrays are read once, each member's Prop-4.3 keep rule becomes
    a boolean *mask*, and the union of the masks defines a shared arena
    the per-member sorts select from.  Each returned index is
    byte-identical to ``build_index(graph, s, t, k, dist_fn=...)`` with
    the same injected distances (tests/test_torch_sharing.py checks
    this), so callers can mix grouped and solo construction freely.
    The indexes' device stages run on ``device``.
    """
    dev = resolve_device(device)
    g = graph
    u, v = g.esrc.astype(np.int64), g.edst.astype(np.int64)
    keeps: List[np.ndarray] = []
    union = np.zeros(u.shape[0], dtype=bool)
    for (s, t, k), (d_s, d_t) in zip(triples, dists):
        d_s = np.asarray(d_s, dtype=np.int32)
        d_t = np.asarray(d_t, dtype=np.int32)
        keep = ((d_s[u] + 1 + d_t[v]) <= k) & (v != s) & (u != t)
        keeps.append(keep)
        union |= keep
    arena_ids = np.nonzero(union)[0]          # ascending original edge ids
    u_a, v_a = u[arena_ids], v[arena_ids]

    out: List[LightweightIndex] = []
    for (s, t, k), (d_s, d_t), keep in zip(triples, dists, keeps):
        d_s = np.asarray(d_s, dtype=np.int32)
        d_t = np.asarray(d_t, dtype=np.int32)
        mask = keep[arena_ids]
        out.append(_member_index_from_selection(
            g.n, k, s, t, d_s, d_t, u_a[mask], v_a[mask], arena_ids[mask],
            dev))
    return out


@dataclasses.dataclass
class MergedGroupIndex:
    """One index serving a *set* of (s, t) pairs (DESIGN.md §13).

    The arena is the union of the member indexes' edges, addressed like
    a ``LightweightIndex`` but with the per-edge *slack* replacing the
    per-query distance: ``slack(e) = max_j (k_j - dist_t_j[dst(e)])``
    over the members keeping ``e``.  Sorting by ``(src, kmax - slack,
    edge id)`` makes ``a_begin[v] .. a_end[v, kmax - d - 1]`` the exact
    set of arena edges *some* member could still traverse at depth
    ``d`` — every member's budgeted candidate slice is a sub-sequence
    of it, selected by that member's boolean ``member_mask`` row plus
    its own ``dist_t`` budget check.
    """
    kind: str                      # "s" | "t"
    anchor: int                    # the shared vertex
    n: int
    kmax: int
    a_src: np.ndarray              # (A,) int64 arena edge sources
    a_dst: np.ndarray              # (A,) int32 arena edge destinations
    a_orig: np.ndarray             # (A,) int64 original edge ids
    a_begin: np.ndarray            # (n,) int64
    a_end: np.ndarray              # (n, kmax+1) int64 — end at slack budget
    member_mask: np.ndarray        # (M, A) bool — member keeps arena edge
    members: List[LightweightIndex]

    @classmethod
    def from_members(cls, members: Sequence[LightweightIndex], kind: str,
                     anchor: int) -> "MergedGroupIndex":
        """Merge member indexes into one arena.  Per-member edges are
        recovered from the forward index arrays (source ids re-expanded
        from the offset matrix), unioned by original edge id, and the
        slack-sorted offsets rebuilt with the same histogram+cumsum
        scheme as Algorithm 3."""
        n = members[0].n
        kmax = max(m.k for m in members)
        us, vs, es, sl = [], [], [], []
        for m in members:
            per_u = (m.fwd_end[:, m.k] - m.fwd_begin).astype(np.int64)
            mu = np.repeat(np.arange(n, dtype=np.int64), per_u)
            us.append(mu)
            vs.append(m.fwd_dst.astype(np.int64))
            es.append(m.fwd_eid.astype(np.int64))
            sl.append(m.k - m.dist_t[m.fwd_dst].astype(np.int64))
        all_u = np.concatenate(us) if us else np.zeros(0, np.int64)
        all_v = np.concatenate(vs) if vs else np.zeros(0, np.int64)
        all_e = np.concatenate(es) if es else np.zeros(0, np.int64)
        all_s = np.concatenate(sl) if sl else np.zeros(0, np.int64)
        if all_e.size:
            order = np.argsort(all_e, kind="stable")
            all_u, all_v, all_e, all_s = (all_u[order], all_v[order],
                                          all_e[order], all_s[order])
            first = np.ones(all_e.shape[0], dtype=bool)
            first[1:] = all_e[1:] != all_e[:-1]
            starts = np.nonzero(first)[0]
            arena_e = all_e[starts]
            arena_u = all_u[starts]
            arena_v = all_v[starts]
            slack = np.maximum.reduceat(all_s, starts)
        else:
            arena_e = arena_u = arena_v = np.zeros(0, np.int64)
            slack = np.zeros(0, np.int64)
        pseudo = kmax - slack                        # in [0, kmax - 1]
        order2 = np.lexsort((arena_e, pseudo, arena_u))
        a_src, a_dst, a_orig = (arena_u[order2], arena_v[order2],
                                arena_e[order2])
        a_begin, a_end = _offsets_from_sorted(a_src, pseudo[order2], n, kmax)
        mask = np.stack([np.isin(a_orig, m.fwd_eid) for m in members]) \
            if members else np.zeros((0, 0), bool)
        return cls(kind=kind, anchor=anchor, n=n, kmax=kmax,
                   a_src=a_src, a_dst=a_dst.astype(np.int32), a_orig=a_orig,
                   a_begin=a_begin, a_end=a_end, member_mask=mask,
                   members=list(members))

    @property
    def union_edge_ids(self) -> np.ndarray:
        """Sorted original edge ids of the arena — by construction the
        union of the members' ``fwd_eid`` sets (property-tested)."""
        return np.sort(self.a_orig)

    def member_view(self, j: int) -> LightweightIndex:
        """Re-derive member ``j``'s full ``LightweightIndex`` from the
        arena and its mask row.  This is the no-over-/under-pruning
        contract of the merged layout: the view must be byte-identical
        to the member's own ``build_index`` output (property-tested in
        tests/test_torch_sharing.py)."""
        m = self.members[j]
        sel = self.member_mask[j]
        return _member_index_from_selection(
            self.n, m.k, m.s, m.t, m.dist_s, m.dist_t,
            self.a_src[sel], self.a_dst[sel].astype(np.int64),
            self.a_orig[sel], m.device)


class GroupIndexCache:
    """Small LRU over ``MergedGroupIndex`` keyed on ``(graph_id, kind,
    anchor, member QueryKeys)`` (DESIGN.md §13).  Member keys embed
    ``edge_mask_hash`` and ``graph_version``, so a registry mutation
    makes stale merged indexes unreachable by construction — the
    eager ``drop_tenant`` purge (wired through
    ``GraphRegistry._drop_from_engines``) only frees their memory."""

    def __init__(self, capacity: int = 64) -> None:
        self.capacity = capacity
        self._entries: "collections.OrderedDict[tuple, MergedGroupIndex]" \
            = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def get(self, key: tuple) -> Optional[MergedGroupIndex]:
        """Look one group key up; a hit refreshes its LRU position."""
        hit = self._entries.get(key)
        if hit is not None:
            self._entries.move_to_end(key)
        return hit

    def put(self, key: tuple, value: MergedGroupIndex) -> None:
        """Insert one entry, evicting the LRU past ``capacity``."""
        if self.capacity <= 0:
            return
        self._entries[key] = value
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def drop_tenant(self, graph_id: str) -> int:
        """Drop every merged index belonging to one tenant (the group
        half of ``GraphRegistry.retire``/``mutate``'s engine purge).
        Returns the number of entries dropped."""
        doomed = [k for k in self._entries if k[0] == graph_id]
        for k in doomed:
            del self._entries[k]
        return len(doomed)

    def clear(self) -> None:
        """Drop all entries."""
        self._entries.clear()


# ---------------------------------------------------------------------------
# Level B: the shared-prefix walk and its per-member replays
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _MemberSpec:
    """Per-member walk parameters: ``node_limit`` is the deepest tree
    node the member may own (k-1 for DFS continuations, the cut for a
    join half), ``expand_limit`` the deepest node it needs expanded."""
    slot: int
    idx: LightweightIndex
    k: int
    t: int
    dist_t: np.ndarray
    node_limit: int
    expand_limit: int


@dataclasses.dataclass
class _GroupCapture:
    """The walk's output: the union prefix tree (``parent``/``vertex``/
    ``depth`` per node id) plus, per member slot, the node-level Fig.-6
    ingredients (candidate count, dup count, validity) and the
    emission/continuation edges sorted by parent id for segment
    lookups.  Path rows are *not* stored — replays materialize them by
    chasing ``parent`` chains, so capture memory is O(nodes · members),
    not O(nodes · k)."""
    parent: np.ndarray            # (N,) int64
    vertex: np.ndarray            # (N,) int32
    depth: np.ndarray             # (N,) int32
    valid: np.ndarray             # (N, M) bool
    cnt: np.ndarray               # (N, M) int64 — member candidates of node
    dup: np.ndarray               # (N, M) int64 — member dup-pruned of node
    emit_par: List[np.ndarray]    # per member: parent node ids (sorted)
    emit_v: List[np.ndarray]      # per member: emitted vertex (== t_j)
    cont_par: List[np.ndarray]    # per member: parent node ids (sorted)
    cont_child: List[np.ndarray]  # per member: child node ids


def _segment_take(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Flatten per-query [left, right) segment slices into one gather
    index array, segments concatenated in query order."""
    cnt = (right - left).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    par = np.repeat(np.arange(cnt.shape[0], dtype=np.int64), cnt)
    offs = np.zeros(cnt.shape[0], dtype=np.int64)
    np.cumsum(cnt[:-1], out=offs[1:])
    return np.arange(total, dtype=np.int64) - offs[par] + left[par]


def _materialize_rows(cap: _GroupCapture, parents: np.ndarray,
                      vnew: np.ndarray, depth: int,
                      width: int) -> np.ndarray:
    """Path rows for emissions: each row is the parent node's vertex
    chain (positions 0..depth) plus ``vnew`` at depth+1, PAD after."""
    rows = np.full((parents.shape[0], width), PAD, dtype=np.int32)
    rows[:, depth + 1] = vnew
    p = parents
    for d in range(depth, -1, -1):
        rows[:, d] = cap.vertex[p]
        p = cap.parent[p]
    return rows


def _walk_group(merged: MergedGroupIndex, specs: Sequence[_MemberSpec],
                chunk_size: int, deadline: Optional[float],
                max_nodes: Optional[int]) -> _GroupCapture:
    """Walk the merged index's prefix tree once, capturing per-member
    candidate/dup counts and emission/continuation edges.

    The LIFO chunk discipline mirrors `_drive` exactly — one pop per
    union chunk, candidates gathered through the arena offsets, one
    vectorized prefix compare — and the per-candidate classification is
    a single (total, M) matrix pass: per-member mask and distance
    budget fold into one static int8 arena table (``maxdep[e, j]`` =
    deepest depth member j may still take arena edge ``e``; -1 when
    masked out), so a chunk costs one fancy-index gather plus boolean
    matrix algebra — no per-member gathers or sorts in the hot loop.
    Emissions and continuations are captured unsorted with a static
    per-member *rank* (the member's own ``(dist_t_j, edge id)`` order
    within a source block, precomputed once per group) and sorted once
    per member at finalize, so replays still reproduce solo emission
    order bit-for-bit.  Raises ``SharingFallback`` past ``max_nodes``
    or the deadline.
    """
    M = len(specs)
    kmax = merged.kmax
    s = merged.anchor
    arena = merged.a_dst.shape[0]
    # static per-member tables over the arena: the walk's entire
    # member-specific state, amortized across every chunk
    maxdep = np.full((arena, M), -1, np.int8)
    rank_of: List[np.ndarray] = []
    a_dst64 = merged.a_dst.astype(np.int64)
    for j, spec in enumerate(specs):
        dist = spec.dist_t[a_dst64]
        md = np.clip(spec.k - 1 - dist, -1, 127).astype(np.int8)
        maxdep[:, j] = np.where(merged.member_mask[spec.slot], md,
                                np.int8(-1))
        order_j = np.lexsort((merged.a_orig, dist, merged.a_src))
        r = np.empty(arena, np.int32)
        r[order_j] = np.arange(arena, dtype=np.int32)
        rank_of.append(r)
    t_vec = np.array([spec.t for spec in specs], np.int32)
    node_limits = np.array([spec.node_limit for spec in specs], np.int64)
    expand_limits = np.array([spec.expand_limit for spec in specs],
                             np.int64)
    node_parent = [np.zeros(1, np.int64)]
    node_vertex = [np.full(1, s, np.int32)]
    node_depth = [np.zeros(1, np.int32)]
    valid_blocks: List[Tuple[np.ndarray, np.ndarray]] = \
        [(np.zeros(1, np.int64), np.ones((1, M), bool))]
    stat_blocks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    emit_par: List[List[np.ndarray]] = [[] for _ in range(M)]
    emit_v: List[List[np.ndarray]] = [[] for _ in range(M)]
    emit_rank: List[List[np.ndarray]] = [[] for _ in range(M)]
    cont_par: List[List[np.ndarray]] = [[] for _ in range(M)]
    cont_child: List[List[np.ndarray]] = [[] for _ in range(M)]
    cont_rank: List[List[np.ndarray]] = [[] for _ in range(M)]
    n_nodes = 1

    root_rows = np.full((1, kmax + 1), PAD, np.int32)
    root_rows[0, 0] = s
    work: List[Tuple[np.ndarray, np.ndarray, np.ndarray, int]] = \
        [(np.zeros(1, np.int64), root_rows, np.ones((1, M), bool), 0)]

    while work:
        if deadline is not None and clock.expired(deadline):
            raise SharingFallback("deadline expired during shared walk")
        ids, rows, vmat, depth = work.pop()
        last = rows[:, depth].astype(np.int64)
        ub = kmax - depth - 1
        begin = merged.a_begin[last]
        end = merged.a_end[last, ub] if ub >= 0 else begin
        cnt_u = (end - begin).astype(np.int64)
        total = int(cnt_u.sum())
        if total == 0:
            continue
        ppos = np.repeat(np.arange(ids.shape[0], dtype=np.int64), cnt_u)
        offs = np.zeros(ids.shape[0], np.int64)
        np.cumsum(cnt_u[:-1], out=offs[1:])
        apos = np.arange(total, dtype=np.int64) - offs[ppos] + begin[ppos]
        vnew = merged.a_dst[apos]
        prefix = rows[ppos, : depth + 1]
        dup = (prefix == vnew[:, None]).any(axis=1)
        par_ids = ids[ppos]

        # one (total, M) classification pass: gather the static table,
        # everything else is boolean matrix algebra
        ok = (maxdep[apos] >= depth) & vmat[ppos]
        live = ok & ~dup[:, None]
        is_t = vnew[:, None] == t_vec[None, :]
        em_mat = live & is_t
        cm_mat = live & ~is_t & (depth + 1 <= node_limits)[None, :]

        # per-parent per-member counts as cumsum differences over the
        # candidate axis (axis-0 reduceat on a wide bool matrix walks
        # strided memory; two contiguous cumsums don't)
        cnt_mat = np.zeros((ids.shape[0], M), np.int64)
        dup_mat = np.zeros((ids.shape[0], M), np.int64)
        nonempty = np.nonzero(cnt_u > 0)[0]
        starts = offs[nonempty]
        ends = (offs + cnt_u)[nonempty]
        csum = np.cumsum(ok, axis=0, dtype=np.int64)
        dsum = np.cumsum(ok & dup[:, None], axis=0, dtype=np.int64)
        top_c, top_d = csum[ends - 1], dsum[ends - 1]
        has_prev = starts > 0
        bot_c = np.zeros_like(top_c)
        bot_d = np.zeros_like(top_d)
        bot_c[has_prev] = csum[starts[has_prev] - 1]
        bot_d[has_prev] = dsum[starts[has_prev] - 1]
        cnt_mat[nonempty] = top_c - bot_c
        dup_mat[nonempty] = top_d - bot_d
        stat_blocks.append((ids, cnt_mat, dup_mat))

        if em_mat.any():
            nz_m, nz_c = np.nonzero(em_mat.T)       # member-major
            ecnt = np.bincount(nz_m, minlength=M)
            eoff = np.zeros(M + 1, np.int64)
            np.cumsum(ecnt, out=eoff[1:])
            for j in range(M):
                sel = nz_c[eoff[j]:eoff[j + 1]]
                if sel.size:
                    emit_par[j].append(par_ids[sel])
                    emit_v[j].append(vnew[sel])
                    emit_rank[j].append(rank_of[j][apos[sel]])

        union_cont = cm_mat.any(axis=1)
        sel_u = np.nonzero(union_cont)[0]
        if sel_u.size == 0:
            continue
        child_ids = np.arange(n_nodes, n_nodes + sel_u.size, dtype=np.int64)
        n_nodes += sel_u.size
        if max_nodes is not None and n_nodes > max_nodes:
            raise SharingFallback(f"union tree exceeded {max_nodes} nodes")
        node_parent.append(par_ids[sel_u])
        node_vertex.append(vnew[sel_u])
        node_depth.append(np.full(sel_u.size, depth + 1, np.int32))
        vchild = cm_mat[sel_u]
        valid_blocks.append((child_ids, vchild))
        cand2node = np.full(total, -1, np.int64)
        cand2node[sel_u] = child_ids

        nz_m, nz_c = np.nonzero(cm_mat.T)           # member-major
        ccnt = np.bincount(nz_m, minlength=M)
        coff = np.zeros(M + 1, np.int64)
        np.cumsum(ccnt, out=coff[1:])
        for j in range(M):
            sel = nz_c[coff[j]:coff[j + 1]]
            if sel.size:
                cont_par[j].append(par_ids[sel])
                cont_child[j].append(cand2node[sel])
                cont_rank[j].append(rank_of[j][apos[sel]])

        want = (vchild & (depth + 1 <= expand_limits)[None, :]).any(axis=1)
        selx = np.nonzero(want)[0]
        if selx.size:
            gpos = sel_u[selx]
            rows_new = rows[ppos[gpos]].copy()
            rows_new[:, depth + 1] = vnew[gpos]
            xids = child_ids[selx]
            xval = vchild[selx]
            for st in reversed(range(0, selx.size, chunk_size)):
                work.append((xids[st:st + chunk_size],
                             rows_new[st:st + chunk_size],
                             xval[st:st + chunk_size], depth + 1))

    parent = np.concatenate(node_parent)
    vertex = np.concatenate(node_vertex)
    dep = np.concatenate(node_depth)
    valid = np.zeros((n_nodes, M), bool)
    for ids_b, v_b in valid_blocks:
        valid[ids_b] = v_b
    cnt = np.zeros((n_nodes, M), np.int64)
    dupm = np.zeros((n_nodes, M), np.int64)
    for ids_b, c_b, d_b in stat_blocks:
        cnt[ids_b] = c_b
        dupm[ids_b] = d_b

    def _cat_sorted(pars: List[np.ndarray], vals: List[np.ndarray],
                    ranks: List[np.ndarray],
                    vdtype) -> Tuple[np.ndarray, np.ndarray]:
        """Concatenate captures and establish per-parent segments in the
        member's own candidate order — one sort per member total, in
        place of a sort per member per chunk."""
        if not pars:
            return np.zeros(0, np.int64), np.zeros(0, vdtype)
        p = np.concatenate(pars)
        x = np.concatenate(vals)
        r = np.concatenate(ranks)
        order = np.lexsort((r, p))
        return p[order], x[order]

    e_par, e_v, c_par, c_ch = [], [], [], []
    for j in range(M):
        p, x = _cat_sorted(emit_par[j], emit_v[j], emit_rank[j], np.int32)
        e_par.append(p)
        e_v.append(x)
        p, x = _cat_sorted(cont_par[j], cont_child[j], cont_rank[j],
                           np.int64)
        c_par.append(p)
        c_ch.append(x)
    return _GroupCapture(parent=parent, vertex=vertex, depth=dep,
                         valid=valid, cnt=cnt, dup=dupm,
                         emit_par=e_par, emit_v=e_v,
                         cont_par=c_par, cont_child=c_ch)


def _replay_dfs(cap: _GroupCapture, slot: int, idx: LightweightIndex,
                chunk_size: int, count_only: bool, first_n: Optional[int],
                deadline: Optional[float]) -> EnumResult:
    """Replay one member's IDX-DFS run off the capture — a line-for-line
    re-enactment of `_drive` over tree node ids instead of path rows:
    same LIFO pops, same chunk splits, same deadline / first_n exits,
    same Fig.-6 counter order.  Byte-identical to the solo run by
    construction (the parity suite asserts it, stats included)."""
    k = idx.k
    stats = EnumStats()
    out_paths: List[np.ndarray] = []
    out_lens: List[np.ndarray] = []
    count = 0
    ep, ev = cap.emit_par[slot], cap.emit_v[slot]
    cp, cc = cap.cont_par[slot], cap.cont_child[slot]
    work: List[Tuple[np.ndarray, int]] = [(np.zeros(1, np.int64), 0)]

    while work:
        if deadline is not None and clock.expired(deadline):
            return _finalize(idx, out_paths, out_lens, count, stats,
                             exhausted=False)
        ids, depth = work.pop()
        stats.chunks += 1
        cnts = cap.cnt[ids, slot]
        total = int(cnts.sum())
        stats.edges_accessed += total
        if total == 0:
            stats.invalid_partials += int(ids.shape[0])
            continue
        dups = cap.dup[ids, slot]
        stats.partials_generated += total
        stats.invalid_partials += int(dups.sum())
        stats.invalid_partials += int(np.count_nonzero(cnts == dups))

        el = np.searchsorted(ep, ids, side="left")
        er = np.searchsorted(ep, ids, side="right")
        ne = int((er - el).sum())
        if ne:
            count += ne
            stats.results += ne
            if not count_only:
                take = _segment_take(el, er)
                out_paths.append(_materialize_rows(cap, ep[take], ev[take],
                                                   depth, k + 1))
                out_lens.append(np.full(ne, depth + 1, np.int32))
            if first_n is not None and count >= first_n:
                count = _trim_to_first_n(out_paths, out_lens, count,
                                         first_n, count_only, stats)
                return _finalize(idx, out_paths, out_lens, count, stats,
                                 exhausted=False)

        if depth + 1 < k:
            cl = np.searchsorted(cp, ids, side="left")
            cr = np.searchsorted(cp, ids, side="right")
            take = _segment_take(cl, cr)
            if take.size:
                childs = cc[take]
                for st in reversed(range(0, childs.shape[0], chunk_size)):
                    work.append((childs[st:st + chunk_size], depth + 1))

    return _finalize(idx, out_paths, out_lens, count, stats, exhausted=True,
                     canonical=True)


def _derive_join_ra(cap: _GroupCapture, slot: int, idx: LightweightIndex,
                    cut: int, stats: EnumStats,
                    max_partials: Optional[int]) -> np.ndarray:
    """Derive one join member's R_a relation from the capture — the
    shared stand-in for `_expand_to_width(idx, [s], 0, cut+1, ...)`.

    The per-depth accounting re-enacts the solo expansion exactly:
    finished (t-reaching) rows persist as width-1 pads contributing to
    ``partials_generated`` but not ``edges_accessed``, the
    ``max_partials`` limit trips at the same step with the same
    message, and an all-dead step returns the same empty relation.  Row
    *order* is deterministic but not the solo order — irrelevant
    downstream: join keys come from ``np.unique``, the sort-merge sort
    is stable per key group, and exhausted outputs canonicalize.
    """
    t = idx.t
    valid_ids = np.nonzero(cap.valid[:, slot])[0]
    vdep = cap.depth[valid_ids]
    epar, ev = cap.emit_par[slot], cap.emit_v[slot]
    edep = (cap.depth[epar] + 1).astype(np.int64) if epar.size \
        else np.zeros(0, np.int64)
    e_hist = np.bincount(edep, minlength=cut + 2) if edep.size \
        else np.zeros(cut + 2, np.int64)
    finished = 0
    for d in range(cut):
        nd = valid_ids[vdep == d]
        cnt_d = int(cap.cnt[nd, slot].sum())
        stats.edges_accessed += cnt_d
        total = cnt_d + finished
        if total == 0:
            return np.zeros((0, cut + 1), np.int32)
        if max_partials is not None and total > max_partials:
            raise EngineLimit(f"join half exceeded {max_partials} partials")
        stats.partials_generated += total
        stats.invalid_partials += int(cap.dup[nd, slot].sum())
        finished += int(e_hist[d + 1])

    leaves = valid_ids[vdep == cut]
    rows_leaf = np.zeros((leaves.shape[0], cut + 1), np.int32)
    p = leaves
    for d in range(cut, -1, -1):
        rows_leaf[:, d] = cap.vertex[p]
        p = cap.parent[p]

    sel = np.nonzero(edep <= cut)[0]
    rows_emit = np.full((sel.shape[0], cut + 1), t, np.int32)
    sdep = edep[sel]
    for dd in np.unique(sdep):
        m = sdep == dd
        p = epar[sel[m]]
        for d in range(int(dd) - 1, -1, -1):
            rows_emit[m, d] = cap.vertex[p]
            p = cap.parent[p]
    return np.concatenate([rows_leaf, rows_emit], axis=0)


def run_shared_groups(engine, resolved: Dict[tuple, tuple],
                      plans: Dict[tuple, object], *, count_only: bool,
                      first_n: Optional[int], deadline: Optional[float],
                      graph_id: str):
    """Execute every shareable group of a batch (DESIGN.md §13).

    ``plans`` maps the batch's distinct keys (first-occurrence order) to
    their per-query plans; ``resolved`` maps them to built indexes.
    Shared-s groups with at least two *eligible* members — DFS plans
    always, join plans only without ``first_n`` (the join's first-n
    contract trims mid-emission, which a shared R_a cannot reproduce
    mid-group) — get one merged index (LRU-cached on the engine), one
    prefix walk, and per-member replays.  Any ``SharingFallback`` quietly
    returns the group to the caller's per-query path.  Returns
    ``(results, latencies, n_groups)`` where ``latencies`` charge each
    member its replay plus an equal share of the walk.
    """
    results: Dict[tuple, EnumResult] = {}
    latencies: Dict[tuple, float] = {}
    n_groups = 0
    for grp in detect_groups(list(plans.keys()), kinds=("s",)):
        eligible: List[Tuple[tuple, str, Optional[int]]] = []
        for key in grp.keys:
            plan = plans[key]
            if plan.method == "dfs":
                eligible.append((key, "dfs", None))
            elif plan.method == "join" and first_n is None and plan.cut:
                eligible.append((key, "join", int(plan.cut)))
        if len(eligible) < 2:
            continue
        eligible.sort(key=lambda e: e[0])
        member_keys = tuple(key for key, _, _ in eligible)
        gkey = (graph_id, grp.kind, grp.anchor, member_keys)
        merged = engine.group_cache.get(gkey)
        if merged is None:
            merged = MergedGroupIndex.from_members(
                [resolved[key][0] for key, _, _ in eligible],
                kind=grp.kind, anchor=grp.anchor)
            engine.group_cache.put(gkey, merged)
        specs: List[_MemberSpec] = []
        for slot, (key, meth, cut) in enumerate(eligible):
            idx = resolved[key][0]
            if meth == "dfs":
                specs.append(_MemberSpec(slot=slot, idx=idx, k=idx.k,
                                         t=idx.t, dist_t=idx.dist_t,
                                         node_limit=idx.k - 1,
                                         expand_limit=idx.k - 1))
            else:
                specs.append(_MemberSpec(slot=slot, idx=idx, k=idx.k,
                                         t=idx.t, dist_t=idx.dist_t,
                                         node_limit=int(cut),
                                         expand_limit=int(cut) - 1))
        t_w0 = time.perf_counter()
        try:
            cap = _walk_group(merged, specs, engine.engine.chunk_size,
                              deadline, SHARING_MAX_NODES)
        except SharingFallback:
            continue
        walk_share = (time.perf_counter() - t_w0) / len(specs)
        n_groups += 1
        for slot, (key, meth, cut) in enumerate(eligible):
            idx = resolved[key][0]
            t0 = time.perf_counter()
            if meth == "dfs":
                res = _replay_dfs(cap, slot, idx, engine.engine.chunk_size,
                                  count_only, first_n, deadline)
            else:
                def _ra(stats, max_partials, _slot=slot, _idx=idx,
                        _cut=int(cut)):
                    return _derive_join_ra(cap, _slot, _idx, _cut, stats,
                                           max_partials)
                res = enumerate_paths_join(
                    idx, cut=int(cut), count_only=count_only, first_n=None,
                    max_partials=engine.engine.max_partials,
                    deadline=deadline, _shared_ra=_ra)
            results[key] = res
            latencies[key] = (time.perf_counter() - t0) + walk_share
    return results, latencies, n_groups
