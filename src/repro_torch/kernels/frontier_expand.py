"""K1 and K5: the IDX-DFS frontier hop, single-query and fused, as CUDA
kernels and their plain versions.

One hop of Algorithm 4 over a fixed-width ``(C, k+1)`` int32 chunk of
partial paths, all at one depth (DESIGN.md §9): gather each row's
candidates from the light-weight index, drop those already on the row's
prefix, and split the survivors into emit (the candidate is t) and
continue.  The counterpart of ``repro``'s Pallas kernel
``kernels/frontier_expand._frontier_kernel``; the CUDA source is
``csrc/frontier.cu`` and says what bounds it on the card.

Layout (the JAX package's, so both can be held against each other):

* ``paths`` (C, k+1) int32: rows at one depth, PAD past it; whole PAD
  rows are inert (no candidates, no counter contributions).
* ``begin`` (n,) and ``end`` (n, k+1) int32 offsets, ``dst`` (mf,) int32
  (``LightweightIndex.device_arrays``).  The kernel reads the budget
  column ``b = k - depth - 1`` of ``end`` itself, so no per-hop column
  copy is made.
* ``meta`` (2,) int32 ``[depth, t]`` on the same device as the rest, so a
  caller that holds the depth on the card (the resident deque) launches
  without a host round trip.
* Outputs: ``vnew``/``emit``/``cont`` (C, max_deg) int32 and the Fig.-6
  counters (4,) int32 ``[edges, edges, invalid, 0]``.

``frontier_masks`` launches the kernel for CUDA tensors and runs
``frontier_masks_plain`` for CPU tensors; nothing routes a CUDA tensor
to the plain version.

``frontier_hop`` is K1's hop entry: the same per-row work with the
compaction in the kernel, so the (C, max_deg) masks never reach device
memory.  It returns the children in the flat row-major order of a
prefix-sum compaction (``compact`` + ``children``), ``emit_rows`` and
``cont_rows`` (C·max_deg, k+1) int32 with the first ``n_emit`` /
``n_cont`` rows defined, and ``head`` (8,) int32 ``[edges, edges,
invalid, 0, n_emit, n_cont, 0, 0]`` for the host to read in one copy.
Its plain version, ``frontier_hop_plain``, is the masks' plain version
and that compaction.  ``launches`` counts every launch of K1 (either
entry), ``hop_launches`` those of the hop entry.

K5, ``frontier_fused_masks``, is K1 for ``m`` queries in one launch
(``repro``'s ``_frontier_fused_kernel``; source ``csrc/frontier_fused.cu``):
the rows of one (C, k1max) matrix pack one chunk per member in ascending
member rank, ``rank`` (C,) tags each row, ``tvec`` / ``depthv`` (m,) hold
each member's target and chunk depth, and each member brings its own
``begin`` (n,), ``end`` (n, k+1) and ``dst`` (mf,).  The kernel reads the
members' arrays through an (m, 5) int64 table of pointers on the device
(``fused_member_table``); the plain version builds ``repro``'s flattened
``(m·n,)`` / ``(m·mfm,)`` layout from them (``fused_flat_tables``).
Counters come out per member, ``(m, 4)``.  ``frontier_fused_masks_table``
launches the kernel on a table the caller already holds on the card;
``frontier_fused_masks`` takes the members' arrays, as the tests and the
plain version do.

``frontier_fused_hop`` is K5's hop entry, K1's hop for many queries: the
same per-row work with the compaction, the child rows and the per-member
counts in the kernel (a count and a write launch), on a member table
already on the card (the fused expand copies it in with the packed rows,
so a launch waits on no copy).  ``wantc`` (m,) int32 is 0 for a member on
its last hop, which gets no continue rows and ``n_cont`` 0; its counters
still come from the full continue mask.  It returns ``emit_rows`` and
``cont_rows`` (rows·max_deg, k1max) int32, the children in flat row-major
order with the first ``sum(n_emit)`` / ``sum(n_cont)`` rows defined, so
each member's rows form one segment in member order, and ``head`` (6m,)
int32 ``[n_emit (m) | n_cont (m) | counters (m×4)]`` for the host to
read in one copy.  Its plain version, ``frontier_fused_hop_plain``, takes
the members' arrays: the masks' plain version, ``compact`` and
``children`` over the flat masks and per-member sums.
``fused_launches`` counts every launch of K5 (either entry),
``fused_hop_launches`` those of the hop entry.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

PAD = -1

# kernel launches since process start (chip_smoke.py resets and reads them)
launches: int = 0
hop_launches: int = 0
fused_launches: int = 0
fused_hop_launches: int = 0

# int32 slots of K1's hop's head, and the block totals a hop's scratch
# holds (kHead and kMaxGrid in csrc/frontier.cu; kMaxGrid in
# csrc/frontier_fused.cu)
HOP_HEAD = 8
HOP_MAX_GRID = 1024


def frontier_masks_plain(paths: torch.Tensor, begin: torch.Tensor,
                         end: torch.Tensor, dst: torch.Tensor,
                         meta: torch.Tensor, *, max_deg: int
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """The frontier masks in plain PyTorch (any device): the semantics the
    CUDA kernel is held to, written after ``repro``'s
    ``ref.frontier_masks_ref``."""
    C, k1 = paths.shape
    mf = dst.shape[0]
    depth = meta[0].long()
    t = meta[1]
    b = torch.clamp(k1 - 2 - depth, 0, k1 - 1)
    last = paths.index_select(1, depth.view(1)).view(C)
    valid = last != PAD
    lastc = torch.where(valid, last, 0).long()
    bsel = begin.index_select(0, lastc)
    esel = end.index_select(0, lastc).index_select(1, b.view(1)).view(C)
    cnt = torch.where(valid, esel - bsel, 0)
    slot = torch.arange(max_deg, device=paths.device)[None, :]
    in_range = slot < cnt[:, None]
    pos = torch.clamp(bsel[:, None].long() + slot, 0, mf - 1)
    vnew = dst[pos]
    on_prefix = torch.arange(k1, device=paths.device) <= depth
    dup = ((paths[:, :, None] == vnew[:, None, :])
           & on_prefix[None, :, None]).any(dim=1)
    is_t = vnew == t
    emit = in_range & ~dup & is_t
    cont = in_range & ~dup & ~is_t
    alive = (emit | cont).any(dim=1)
    dead = valid & ~alive
    edges = cnt.sum()
    invalid = (dup & in_range).sum() + dead.sum()
    counters = torch.stack([edges, edges, invalid,
                            torch.zeros_like(edges)]).to(torch.int32)
    return (torch.where(emit | cont, vnew, PAD).to(torch.int32),
            emit.to(torch.int32), cont.to(torch.int32), counters)


def compact(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Positions of the set entries of a flat mask, in order, padded with
    0 to the mask's length (``jnp.nonzero(size=cap, fill_value=0)``), and
    their count as a 0-d tensor.  A prefix sum ranks the set entries and
    a scatter places them; unset entries land in a scratch tail."""
    cap = mask.shape[0]
    slots = torch.arange(cap, device=mask.device)
    rank = torch.cumsum(mask, dim=0) - 1
    dest = torch.where(mask, rank, cap + slots)
    out = torch.zeros(2 * cap, dtype=torch.int64, device=mask.device)
    out[dest] = slots
    return out[:cap], mask.sum()


def children(paths: torch.Tensor, vflat: torch.Tensor, idxs: torch.Tensor,
             depth_rows: torch.Tensor, max_deg: int) -> torch.Tensor:
    """Child rows of the candidates at flat positions ``idxs``: the parent
    row with the candidate written at column depth+1, where ``depth_rows``
    holds each parent row's depth (a fused launch mixes members whose
    chunks sit at different depths)."""
    parents = idxs // max_deg
    rows = paths.index_select(0, parents)
    col = torch.arange(paths.shape[1], device=paths.device)
    dsel = depth_rows.index_select(0, parents)
    return torch.where(col[None, :] == dsel[:, None] + 1,
                       vflat.index_select(0, idxs)[:, None], rows)


def frontier_hop_plain(paths: torch.Tensor, begin: torch.Tensor,
                       end: torch.Tensor, dst: torch.Tensor,
                       meta: torch.Tensor, *, max_deg: int,
                       want_cont: bool = True
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hop in plain PyTorch (any device): ``frontier_masks_plain``,
    then ``compact`` and ``children`` over the flat masks, as ``repro``'s
    ``ops._frontier_expand_jit``.  Returns ``(emit_rows, cont_rows,
    head)``; with ``want_cont=False`` ``cont_rows`` has no rows and
    n_cont is 0."""
    C, k1 = paths.shape
    vnew, emit, cont, counters = frontier_masks_plain(
        paths, begin, end, dst, meta, max_deg=max_deg)
    vflat = vnew.view(-1)
    depth_rows = meta[0].long().expand(C)
    eidx, n_emit = compact(emit.view(-1) != 0)
    emit_rows = children(paths, vflat, eidx, depth_rows, max_deg)
    if want_cont:
        cidx, n_cont = compact(cont.view(-1) != 0)
        cont_rows = children(paths, vflat, cidx, depth_rows, max_deg)
    else:
        cont_rows = paths[:0]
        n_cont = torch.zeros((), dtype=torch.int64, device=paths.device)
    head = torch.cat([counters, torch.stack([n_emit, n_cont]).to(
        torch.int32), counters.new_zeros(2)])
    return emit_rows, cont_rows, head


def _lib() -> ctypes.CDLL:
    lib = _build.load("frontier")
    fn = lib.frontier_masks_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        hop = lib.frontier_hop_launch
        hop.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        hop.restype = ctypes.c_int
    return lib


def _check_args(paths: torch.Tensor, begin: torch.Tensor,
                end: torch.Tensor, dst: torch.Tensor,
                meta: torch.Tensor, max_deg: int) -> None:
    dev = paths.device
    for name, x in (("paths", paths), ("begin", begin), ("end", end),
                    ("dst", dst), ("meta", meta)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, paths on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    C, k1 = paths.shape
    if end.dim() != 2 or end.shape != (begin.shape[0], k1):
        raise ValueError(f"end must be (n, k+1) = ({begin.shape[0]}, {k1}),"
                         f" got {tuple(end.shape)}")
    if meta.shape != (2,):
        raise ValueError("meta must be (2,) = [depth, t]")
    if dst.shape[0] < 1 or max_deg < 1:
        raise ValueError("dst needs at least one element and max_deg >= 1")


def frontier_masks(paths: torch.Tensor, begin: torch.Tensor,
                   end: torch.Tensor, dst: torch.Tensor, meta: torch.Tensor,
                   *, max_deg: int) -> tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor, torch.Tensor]:
    """One frontier hop: ``(vnew, emit, cont, counters)`` for a chunk.

    CUDA tensors launch the kernel of ``csrc/frontier.cu`` on the current
    stream (and raise if the launch fails), which zeroes the counters
    itself; the three masks and the counters are views of one allocation.
    CPU tensors take ``frontier_masks_plain``.
    """
    global launches
    _check_args(paths, begin, end, dst, meta, max_deg)
    if not paths.is_cuda:
        return frontier_masks_plain(paths, begin, end, dst, meta,
                                    max_deg=max_deg)
    C, k1 = paths.shape
    slots = C * max_deg
    buf = torch.empty(3 * slots + 4, dtype=torch.int32, device=paths.device)
    vnew, emit, cont = buf[:3 * slots].view(3, C, max_deg)
    counters = buf[3 * slots:]
    status = _lib().frontier_masks_launch(
        paths.data_ptr(), begin.data_ptr(), end.data_ptr(), dst.data_ptr(),
        meta.data_ptr(), vnew.data_ptr(), emit.data_ptr(), cont.data_ptr(),
        counters.data_ptr(), C, k1, max_deg, dst.shape[0],
        _build.stream(paths.device))
    _build.check(status, "frontier_masks")
    launches += 1
    return vnew, emit, cont, counters


def frontier_hop(paths: torch.Tensor, begin: torch.Tensor,
                 end: torch.Tensor, dst: torch.Tensor, meta: torch.Tensor,
                 *, max_deg: int, want_cont: bool = True
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One frontier hop with its compaction: ``(emit_rows, cont_rows,
    head)`` for a chunk (see the module docstring).

    CUDA tensors launch the hop of ``csrc/frontier.cu`` (a count and a
    write launch) on the current stream and raise if it fails; the head,
    the kernel's scratch and both row blocks are views of one allocation,
    and rows past ``n_emit`` / ``n_cont`` are left unwritten.  CPU tensors
    take ``frontier_hop_plain``.
    """
    global launches, hop_launches
    _check_args(paths, begin, end, dst, meta, max_deg)
    if not paths.is_cuda:
        return frontier_hop_plain(paths, begin, end, dst, meta,
                                  max_deg=max_deg, want_cont=want_cont)
    C, k1 = paths.shape
    cap = C * max_deg
    ccap = cap if want_cont else 0
    scratch = 4 * HOP_MAX_GRID
    buf = torch.empty(HOP_HEAD + scratch + (cap + ccap) * k1,
                      dtype=torch.int32, device=paths.device)
    head = buf[:HOP_HEAD]
    rows = buf[HOP_HEAD + scratch:]
    emit_rows = rows[:cap * k1].view(cap, k1)
    cont_rows = rows[cap * k1:].view(ccap, k1)
    status = _lib().frontier_hop_launch(
        paths.data_ptr(), begin.data_ptr(), end.data_ptr(), dst.data_ptr(),
        meta.data_ptr(), head.data_ptr(), buf[HOP_HEAD:].data_ptr(),
        emit_rows.data_ptr(), cont_rows.data_ptr(), C, k1, max_deg,
        dst.shape[0], int(want_cont), _build.stream(paths.device))
    _build.check(status, "frontier_hop")
    launches += 1
    hop_launches += 1
    return emit_rows, cont_rows, head


# ---------------------------------------------------------------------------
# K5: the fused multi-query frontier masks
# ---------------------------------------------------------------------------

def fused_flat_tables(depthv: torch.Tensor, begins, ends, dsts
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``repro``'s flattened per-member tables from per-member arrays:
    ``begin`` (m·n,), ``endb`` (m·n,) holding each member's budget column
    ``k - depth - 1`` of ``end``, and ``dst`` (m·mfm,) with each member's
    array padded with PAD to the longest ``mfm``."""
    mfm = max(int(d.shape[0]) for d in dsts)
    endb = []
    for depth, end in zip(depthv.tolist(), ends):
        k1 = end.shape[1]
        endb.append(end[:, min(max(k1 - 2 - depth, 0), k1 - 1)])
    dst = [torch.nn.functional.pad(d, (0, mfm - d.shape[0]), value=PAD)
           for d in dsts]
    return torch.cat(list(begins)), torch.cat(endb), torch.cat(dst)


def frontier_fused_masks_plain(paths: torch.Tensor, rank: torch.Tensor,
                               tvec: torch.Tensor, depthv: torch.Tensor,
                               begins, ends, dsts, *, max_deg: int
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor, torch.Tensor]:
    """The fused frontier masks in plain PyTorch (any device): the
    semantics the CUDA kernel is held to, written after ``repro``'s
    ``ref.frontier_fused_masks_ref`` over the flattened tables."""
    begin, endb, dst = fused_flat_tables(depthv, begins, ends, dsts)
    C, k1 = paths.shape
    m = tvec.shape[0]
    n = begin.shape[0] // m
    mfm = dst.shape[0] // m
    rk = rank.long()
    depth = depthv.long().index_select(0, rk)
    t = tvec.index_select(0, rk)
    last = paths.gather(1, depth[:, None]).view(C)
    valid = last != PAD
    flat = rk * n + torch.where(valid, last, 0).long()     # 64-bit offsets
    bsel = begin.index_select(0, flat)
    esel = endb.index_select(0, flat)
    cnt = torch.where(valid, esel - bsel, 0)
    slot = torch.arange(max_deg, device=paths.device)[None, :]
    in_range = slot < cnt[:, None]
    pos = (torch.clamp(bsel[:, None].long() + slot, 0, mfm - 1)
           + rk[:, None] * mfm)
    vnew = dst[pos]
    on_prefix = (torch.arange(k1, device=paths.device)[None, :]
                 <= depth[:, None])
    dup = ((paths[:, :, None] == vnew[:, None, :])
           & on_prefix[:, :, None]).any(dim=1)
    is_t = vnew == t[:, None]
    emit = in_range & ~dup & is_t
    cont = in_range & ~dup & ~is_t
    alive = (emit | cont).any(dim=1)
    dead = valid & ~alive
    invalid_row = (dup & in_range).sum(dim=1) + dead.long()
    edges_m = torch.zeros(m, dtype=torch.int64, device=paths.device)
    edges_m.index_add_(0, rk, cnt.long())
    invalid_m = torch.zeros_like(edges_m).index_add_(0, rk, invalid_row)
    counters = torch.stack([edges_m, edges_m, invalid_m,
                            torch.zeros_like(edges_m)], dim=1)
    return (torch.where(emit | cont, vnew, PAD).to(torch.int32),
            emit.to(torch.int32), cont.to(torch.int32),
            counters.to(torch.int32))


def frontier_fused_hop_plain(paths: torch.Tensor, rank: torch.Tensor,
                             tvec: torch.Tensor, depthv: torch.Tensor,
                             wantc: torch.Tensor, begins, ends, dsts, *,
                             max_deg: int
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """K5's hop in plain PyTorch (any device): ``frontier_fused_masks_plain``,
    then ``compact`` and ``children`` over the flat masks (the continue
    mask cleared on the rows of members whose ``wantc`` is 0) and each
    member's children summed, as ``repro``'s ``ops.frontier_expand_fused``.
    Returns ``(emit_rows, cont_rows, head)``, ``head`` (6m,) int32
    ``[n_emit (m) | n_cont (m) | counters (m×4)]``."""
    m = tvec.shape[0]
    vnew, emit, cont, counters = frontier_fused_masks_plain(
        paths, rank, tvec, depthv, begins, ends, dsts, max_deg=max_deg)
    rk = rank.long()
    rankflat = rk.repeat_interleave(max_deg)
    depth_rows = depthv.long().index_select(0, rk)
    flat_emit = emit.view(-1) != 0
    flat_cont = (cont.view(-1) != 0) & (wantc != 0).index_select(0,
                                                                 rankflat)
    out, per_member = [], []
    for flat in (flat_emit, flat_cont):
        idx, _ = compact(flat)
        out.append(children(paths, vnew.view(-1), idx, depth_rows, max_deg))
        per_member.append(torch.zeros(m, dtype=torch.int32,
                                      device=paths.device).scatter_add_(
            0, rankflat, flat.to(torch.int32)))
    head = torch.cat([*per_member, counters.view(-1)])
    return out[0], out[1], head


def _fused_lib() -> ctypes.CDLL:
    lib = _build.load("frontier_fused")
    fn = lib.frontier_fused_masks_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        hop = lib.frontier_fused_hop_launch
        hop.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        hop.restype = ctypes.c_int
    return lib


def _check_rows(paths: torch.Tensor, rank: torch.Tensor,
                tvec: torch.Tensor, depthv: torch.Tensor, m: int,
                max_deg: int) -> None:
    """Raise unless the packed rows and per-member vectors are int32,
    contiguous, on one device and shaped for ``m`` members."""
    if paths.dim() != 2 or rank.shape != (paths.shape[0],):
        raise ValueError("paths must be (C, k1) and rank (C,)")
    if tvec.shape != (m,) or depthv.shape != (m,):
        raise ValueError(f"tvec and depthv must be ({m},)")
    for name, x in (("paths", paths), ("rank", rank), ("tvec", tvec),
                    ("depthv", depthv)):
        if x.device != paths.device:
            raise ValueError(f"{name} is on {x.device}, paths on "
                             f"{paths.device}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if max_deg < 1:
        raise ValueError("max_deg must be >= 1")


def fused_member_table(begins, ends, dsts, *, k1max: int, device
                       ) -> np.ndarray:
    """The kernel's (m, 5) int64 member table ``[begin pointer, end
    pointer, dst pointer, mf, k+1]``, on the host, after checking each
    member's arrays: int32, contiguous, on ``device``, ``begin`` (n,) and
    ``end`` (n, k+1) with one n for all and ``2 <= k+1 <= k1max``, ``dst``
    non-empty."""
    m = len(begins)
    if m < 1 or len(ends) != m or len(dsts) != m:
        raise ValueError("begins, ends and dsts need one entry per member "
                         "(at least one)")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    n = begins[0].shape[0]
    table = np.empty((m, 5), np.int64)
    for i, (b, e, d) in enumerate(zip(begins, ends, dsts)):
        if b.shape != (n,) or e.dim() != 2 or e.shape[0] != n \
                or not 2 <= e.shape[1] <= k1max:
            raise ValueError(f"member {i}: begin must be (n,) and end "
                             f"(n, k+1) with n = {n} and k+1 <= {k1max}")
        if d.dim() != 1 or d.shape[0] < 1:
            raise ValueError(f"member {i}: dst needs at least one element")
        for name, x in (("begins", b), ("ends", e), ("dsts", d)):
            if x.device != device:
                raise ValueError(f"{name}[{i}] is on {x.device}, paths on "
                                 f"{device}")
            if x.dtype != torch.int32:
                raise TypeError(f"{name}[{i}] must be int32, got {x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{name}[{i}] must be contiguous")
        table[i] = (b.data_ptr(), e.data_ptr(), d.data_ptr(), d.shape[0],
                    e.shape[1])
    return table


def _check_table(entry: str, paths: torch.Tensor,
                 table: torch.Tensor) -> int:
    """Raise unless ``paths`` is on the card and ``table`` is a contiguous
    (m, 5) int64 member table beside it (64-bit device pointers, as
    ``fused_member_table`` builds it); returns m."""
    if not paths.is_cuda:
        raise ValueError(f"{entry} runs on the card; CPU tensors take "
                         f"frontier_fused_masks or ops.frontier_expand_fused")
    if table.dim() != 2 or table.shape[1] != 5 \
            or table.dtype != torch.int64 \
            or table.device != paths.device or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (m, 5) int64 tensor on "
                         f"{paths.device}")
    return table.shape[0]


# no CPU branch in the two table entries: only the kernels read a table of
# device pointers, and CPU callers take frontier_fused_masks or the fused
# expand, whose plain versions need none
def frontier_fused_masks_table(  # repro-torch-lint: disable=kernel-contract
        paths: torch.Tensor, rank: torch.Tensor, tvec: torch.Tensor,
        depthv: torch.Tensor, table: torch.Tensor, *, max_deg: int
        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused frontier hop's masks on the card, on a member table
    already there: ``table`` (m, 5) int64 on the rows' CUDA device, as
    ``fused_member_table`` builds it (its arrays must outlive the launch).
    Launches the masks kernel of ``csrc/frontier_fused.cu`` on the current
    stream, which zeroes the counters itself, and raises if the launch
    fails.  No plain version reads a table of device pointers: CPU callers
    take ``frontier_fused_masks``."""
    global fused_launches
    m = _check_table("frontier_fused_masks_table", paths, table)
    _check_rows(paths, rank, tvec, depthv, m, max_deg)
    C, k1 = paths.shape
    # one allocation for the three masks: each tensor op costs host time
    vnew, emit, cont = torch.empty((3, C, max_deg), dtype=torch.int32,
                                   device=paths.device)
    counters = torch.empty((m, 4), dtype=torch.int32, device=paths.device)
    status = _fused_lib().frontier_fused_masks_launch(
        paths.data_ptr(), rank.data_ptr(), tvec.data_ptr(),
        depthv.data_ptr(), table.data_ptr(), vnew.data_ptr(),
        emit.data_ptr(), cont.data_ptr(), counters.data_ptr(), C, k1,
        max_deg, m, _build.stream(paths.device))
    _build.check(status, "frontier_fused_masks")
    fused_launches += 1
    return vnew, emit, cont, counters


def frontier_fused_hop(  # repro-torch-lint: disable=kernel-contract
        paths: torch.Tensor, rank: torch.Tensor, tvec: torch.Tensor,
        depthv: torch.Tensor, wantc: torch.Tensor, table: torch.Tensor, *,
        max_deg: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused frontier hop with its compaction on the card:
    ``(emit_rows, cont_rows, head)`` (see the module docstring), on a
    member table already there, as ``frontier_fused_masks_table`` takes
    it.

    Launches the hop of ``csrc/frontier_fused.cu`` (a count and a write
    launch, the head zeroed on the stream before them) on the current
    stream and raises if it fails; the head, the kernels' scratch and both
    row blocks are views of one allocation, and rows past the children are
    left unwritten.  CPU callers take ``frontier_fused_hop_plain``.
    """
    global fused_launches, fused_hop_launches
    m = _check_table("frontier_fused_hop", paths, table)
    _check_rows(paths, rank, tvec, depthv, m, max_deg)
    if wantc.shape != (m,) or wantc.dtype != torch.int32 \
            or wantc.device != paths.device or not wantc.is_contiguous():
        raise ValueError(f"wantc must be a contiguous ({m},) int32 tensor on "
                         f"{paths.device}")
    C, k1 = paths.shape
    cap = C * max_deg
    # the int4 block totals first (16-byte aligned), then the head
    scratch = 4 * HOP_MAX_GRID
    buf = torch.empty(scratch + 6 * m + 2 * cap * k1, dtype=torch.int32,
                      device=paths.device)
    head = buf[scratch:scratch + 6 * m]
    rows = buf[scratch + 6 * m:]
    emit_rows = rows[:cap * k1].view(cap, k1)
    cont_rows = rows[cap * k1:].view(cap, k1)
    status = _fused_lib().frontier_fused_hop_launch(
        paths.data_ptr(), rank.data_ptr(), tvec.data_ptr(),
        depthv.data_ptr(), wantc.data_ptr(), table.data_ptr(),
        head.data_ptr(), buf.data_ptr(), emit_rows.data_ptr(),
        cont_rows.data_ptr(), C, k1, max_deg, m, _build.stream(paths.device))
    _build.check(status, "frontier_fused_hop")
    fused_launches += 1
    fused_hop_launches += 1
    return emit_rows, cont_rows, head


def frontier_fused_masks(paths: torch.Tensor, rank: torch.Tensor,
                         tvec: torch.Tensor, depthv: torch.Tensor, begins,
                         ends, dsts, *, max_deg: int
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """One fused frontier hop: ``(vnew, emit, cont, counters)`` for rows
    packed from many members, counters ``(m, 4)``.

    CUDA tensors build the member table, copy it to the card and launch
    the kernel through ``frontier_fused_masks_table``; CPU tensors take
    ``frontier_fused_masks_plain``.
    """
    _check_rows(paths, rank, tvec, depthv, len(begins), max_deg)
    table = fused_member_table(begins, ends, dsts, k1max=paths.shape[1],
                               device=paths.device)
    if not paths.is_cuda:
        return frontier_fused_masks_plain(paths, rank, tvec, depthv, begins,
                                          ends, dsts, max_deg=max_deg)
    # pinned, so the copy neither syncs the stream nor needs the host
    # buffer after it (the pinned block is not reused before it is done)
    table = torch.from_numpy(table).pin_memory().to(paths.device,
                                                    non_blocking=True)
    return frontier_fused_masks_table(paths, rank, tvec, depthv, table,
                                      max_deg=max_deg)
