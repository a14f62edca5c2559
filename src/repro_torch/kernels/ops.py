"""The device paths around the kernels: frontier compaction, the resident
work deque (K2) and the dense BFS (DESIGN.md §9).

* ``frontier_expand`` — one IDX-DFS hop for a host chunk: the emit and
  continue candidates compacted into child rows in row-major order by a
  prefix sum (no atomics choose positions), so emission order, and with
  it every ``first_n`` prefix, is the host driver's.  On the card K1's
  hop entry does the masks and the compaction in the kernel, on one
  pinned copy in; on the CPU the rows are padded to a power of two and
  take the plain masks and compaction.  ``frontier_expand_readback``
  brings the results to the host in one small copy of the counts and
  one copy per block of rows.
* ``frontier_expand_fused`` — one fused hop for chunks of many queries
  (K5), the counterpart of ``repro``'s ``ops.frontier_expand_fused``:
  the flat compaction with per-row depths, so each member's emit and
  continue rows come out as one contiguous segment in its solo emission
  order.  On the card K5's hop entry does the masks, the compaction and
  the per-member counts in the kernel, on one pinned copy in; on the CPU
  the rows are padded to a power of two, as ``repro`` pads them, and take
  the plain hop.
* ``frontier_deque_round`` — K2, the counterpart of ``repro``'s
  ``ops._deque_round_jit``: up to ``round_pops`` in-arena pop → K1 →
  compact → push iterations over a device arena, with one host sync per
  round (the caller's).  On the card it is one launch of the persistent
  kernel of ``csrc/deque_round.cu``, which runs ``repro``'s while-loop
  itself and leaves it when the loop condition fails; on the CPU it is
  the plain version, ``frontier_deque_round_plain``: a torch loop of
  ``round_pops`` iterations, each of which computes the loop condition
  and masks its own effects once it fails.  Both update ``arena``,
  ``meta_depth`` and ``meta_len`` in place (the arena is the largest
  buffer of a query; ``repro`` copies it).  The geometry, the pop
  sequence and the regions the host reads back (``DequeConfig``) equal
  ``repro``'s; the plain version also equals it array for array.
* ``bfs_dense`` — k min-plus relaxations (K4) from one source, forward
  or over the transpose; one launch on the card (defined beside K4 in
  ``semiring_spmm`` and re-exported here, ``repro``'s place for it).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import trace
from . import _build
from .frontier_expand import (PAD, children, compact, frontier_fused_hop,
                              frontier_fused_hop_plain, frontier_hop,
                              frontier_masks_plain, fused_member_table)
from .semiring_spmm import bfs_dense  # noqa: F401  (re-exported)

# launches of the deque-round kernel since process start (one per round
# on a CUDA device, as ``repro`` counts one dispatch per round)
deque_rounds: int = 0

# the last CUDA round's scalars ([top, n_chunks, n_emit, pops, counters,
# loop iterations]); read by ``last_round_iterations``
_last_scalars: Optional[torch.Tensor] = None

# frontier-expansion dispatches on any device since process start
_dispatch_count: int = 0


def device_dispatch_count() -> int:
    """Calls of ``frontier_expand``, ``frontier_expand_fused`` and
    ``frontier_deque_round`` since process start, on any device
    (``repro``'s ``ops.device_dispatch_count``): the tests assert
    "one dispatch per expansion round" on its deltas.  The per-kernel
    counts of ``kernels.launch_counts()`` count CUDA launches only."""
    return _dispatch_count


def _next_pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length() if x > 1 else 1


def frontier_expand(paths: np.ndarray, begin: torch.Tensor,
                    end: torch.Tensor, dst: torch.Tensor, *, depth: int,
                    t: int, max_deg: int, want_cont: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """One IDX-DFS hop for a whole host chunk on ``begin``'s device.

    ``paths`` is the (rows, k+1) int32 chunk at ``depth``; ``begin`` /
    ``end`` / ``dst`` are the index's int32 device arrays; ``max_deg`` is
    the chunk's largest fan-out (>= 1).  Returns ``(emit_rows, cont_rows,
    n_emit, n_cont, counters)`` on the device, as ``repro``'s
    ``ops.frontier_expand`` does: the first ``n_emit`` rows of
    ``emit_rows`` are the completed paths in host emission order, the
    first ``n_cont`` rows of ``cont_rows`` the surviving partials, and
    ``counters`` the (4,) int32 Fig.-6 deltas; ``n_emit``, ``n_cont`` and
    ``counters`` are views of the hop's ``head``.  ``want_cont=False``
    (the last hop) skips the continue rows; counters are unaffected.
    """
    emit_rows, cont_rows, head = _expand(paths, begin, end, dst,
                                         depth=depth, t=t, max_deg=max_deg,
                                         want_cont=want_cont)
    return emit_rows, cont_rows, head[4], head[5], head[:4]


def frontier_expand_readback(paths: np.ndarray, begin: torch.Tensor,
                             end: torch.Tensor, dst: torch.Tensor, *,
                             depth: int, t: int, max_deg: int,
                             want_cont: bool = True
                             ) -> tuple[Optional[np.ndarray],
                                        Optional[np.ndarray], list]:
    """``frontier_expand`` with its results on the host, as the host-looped
    driver reads them: ``(emit_rows, cont_rows, [edges, partials,
    invalid])``, each row block a numpy array of exactly its rows or None
    when empty.  The head comes back in one small copy, then each block
    of rows that has any."""
    emit_rows, cont_rows, head = _expand(paths, begin, end, dst,
                                         depth=depth, t=t, max_deg=max_deg,
                                         want_cont=want_cont)
    edges, partials, invalid, _, ne, nc = head[:6].tolist()
    emit = emit_rows[:ne].cpu().numpy() if ne else None
    cont = cont_rows[:nc].cpu().numpy() if want_cont and nc else None
    return emit, cont, [edges, partials, invalid]


def _expand(paths: np.ndarray, begin: torch.Tensor, end: torch.Tensor,
            dst: torch.Tensor, *, depth: int, t: int, max_deg: int,
            want_cont: bool
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hop of ``frontier_expand``: ``(emit_rows, cont_rows, head)``.

    On the card the chunk and ``[depth, t]`` go to the device in one copy
    from pinned memory that does not sync the stream, and K1's hop entry
    compacts in the kernel.  On the CPU the chunk is padded with PAD rows
    to a power of two, as ``repro`` buckets it, and takes the plain hop
    (the masks, then the flat compaction)."""
    global _dispatch_count
    paths = np.asarray(paths, dtype=np.int32)
    rows, k1 = paths.shape
    if depth + 2 > k1:
        raise ValueError(f"depth {depth} leaves no column for the hop")
    if max_deg < 1:
        raise ValueError("zero-fanout chunks never reach the device")
    dev = begin.device
    md = _next_pow2(max_deg)
    if dev.type == "cuda":
        # the pinned block is not reused before the copy is done
        host = torch.empty(2 + rows * k1, dtype=torch.int32, pin_memory=True)
        buf = host.numpy()
        buf[:2] = (depth, t)
        buf[2:] = paths.reshape(-1)
        d = host.to(dev, non_blocking=True)
        p, meta = d[2:].view(rows, k1), d[:2]
    else:
        C = _next_pow2(max(rows, 8))
        padded = np.full((C, k1), PAD, dtype=np.int32)
        padded[:rows] = paths
        p = torch.from_numpy(padded)
        meta = torch.tensor([depth, t], dtype=torch.int32)
    out = frontier_hop(p, begin, end, dst, meta, max_deg=md,
                       want_cont=want_cont)
    _dispatch_count += 1
    return out


def frontier_expand_fused(paths: np.ndarray, rank: np.ndarray,
                          tvec: np.ndarray, depthv: np.ndarray, begins,
                          ends, dsts, wantc: np.ndarray, *, max_deg: int,
                          member_table: Optional[np.ndarray] = None
                          ) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One fused IDX-DFS hop for chunks of many queries on the members'
    device (``repro``'s ``ops.frontier_expand_fused``).

    ``paths`` (rows, k1max) int32 packs one chunk per member, rows in
    ascending member order, each member's rows at its own depth (columns
    past a member's own k+1 stay PAD); ``rank`` (rows,) tags each row's
    member; ``tvec`` / ``depthv`` / ``wantc`` (m,) are each member's
    target, chunk depth and ``want_cont`` (False on its last hop); each
    member brings its index's device ``begin`` / ``end`` / ``dst``.  On
    the CPU the rows pad to a power of two (at least 8) with PAD rows of
    rank 0.  ``member_table`` is the members' (m, 5) table of K5 as
    ``fused_member_table`` builds it, where the caller keeps one (each
    member's row stays valid while its arrays live); without it the table
    is built here.  The CPU route does not read it.

    Returns ``(emit_rows, cont_rows, n_emit_m, n_cont_m, counters)`` on
    the device: the compacted emit and continue rows in flat (row-major)
    order, so member i's rows form one segment that starts at the
    exclusive cumsum of ``n_emit_m`` / ``n_cont_m``, and the (m, 4)
    per-member Fig.-6 counters.  ``n_emit_m``, ``n_cont_m`` and
    ``counters`` are consecutive views of one (6m,) int32 head, so one
    copy brings all three back.  The ``wantc`` suppression clears only
    the continue rows: the counters come from the full continue mask, so
    they equal the single-query kernel's.

    With the recorder of ``core.trace`` on, the call is a
    ``k5.dispatch`` span with children ``k5.stage`` (the host buffer and
    the copy in) and ``k5.launch`` (the hop: on the card a memset and
    K5's count and write launches), and it counts ``k5.dispatches``,
    ``k5.rows`` and ``k5.members``.
    """
    global _dispatch_count
    with trace.span("k5.dispatch"):
        paths = np.asarray(paths, dtype=np.int32)
        rows, k1 = paths.shape
        m = len(begins)
        if max_deg < 1:
            raise ValueError("zero-fanout chunks never reach the device")
        if member_table is not None and member_table.shape != (m, 5):
            raise ValueError(f"member_table must be ({m}, 5), got "
                             f"{member_table.shape}")
        trace.count("k5.dispatches")
        trace.count("k5.rows", rows)
        trace.count("k5.members", m)
        dev = begins[0].device
        on_card = dev.type == "cuda"
        C = rows if on_card else _next_pow2(max(rows, 8))
        with trace.span("k5.stage"):
            # one host buffer, one copy: on the card the int64 member
            # table of K5 first, then the int32 [paths | rank | tvec |
            # depthv | wantc], from pinned memory without a stream sync
            n_tab = 5 * m if on_card else 0
            n32 = C * k1 + C + 3 * m
            host = torch.empty(n_tab + (n32 + 1) // 2, dtype=torch.int64,
                               pin_memory=on_card)
            if on_card:
                if member_table is None:
                    member_table = fused_member_table(begins, ends, dsts,
                                                      k1max=k1, device=dev)
                host.numpy()[:n_tab] = member_table.reshape(-1)
            buf = host.numpy()[n_tab:].view(np.int32)
            buf[:rows * k1] = paths.reshape(-1)
            buf[rows * k1:C * k1] = PAD
            o = C * k1
            buf[o:o + rows] = rank
            buf[o + rows:o + C] = 0
            o += C
            buf[o:o + m] = tvec
            buf[o + m:o + 2 * m] = depthv
            buf[o + 2 * m:o + 3 * m] = np.asarray(wantc, dtype=bool)
            dbuf = host.to(dev, non_blocking=True)
        with trace.span("k5.launch"):
            d32 = dbuf[n_tab:].view(torch.int32)
            p = d32[:C * k1].view(C, k1)
            rk = d32[C * k1:o]
            tv = d32[o:o + m]
            dv = d32[o + m:o + 2 * m]
            wc = d32[o + 2 * m:o + 3 * m]
            md = _next_pow2(max_deg)
            if on_card:
                emit_rows, cont_rows, head = frontier_fused_hop(
                    p, rk, tv, dv, wc, dbuf[:n_tab].view(m, 5), max_deg=md)
            else:
                emit_rows, cont_rows, head = frontier_fused_hop_plain(
                    p, rk, tv, dv, wc, begins, ends, dsts, max_deg=md)
        _dispatch_count += 1
        return (emit_rows, cont_rows, head[:m], head[m:2 * m],
                head[2 * m:].view(m, 4))


# ---------------------------------------------------------------------------
# Device-resident work deque (K2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DequeConfig:
    """Static geometry of the device-resident work deque (``repro``'s).

    The arena is a row stack: live chunk rows occupy ``[0, top)`` and
    chunk ``j`` (meta slot ``j``, bottom to top) spans the rows between
    the cumulative lengths of its predecessors; pops read from the top,
    pushes scatter continue pieces back so the host driver's reversed
    piece order is kept (piece 0 topmost).  Rows past ``arena_cap`` and
    meta slots past ``max_chunks`` are scratch targets of masked
    scatters and are never read back.  The CUDA round writes only what
    the host reads back: ``arena[:arena_cap]``, meta slots below
    ``max_chunks``, ``emitbuf[:n_emit]`` / ``emitlen[:n_emit]`` and the
    scalars; the scratch regions hold whatever they held.
    """
    k1: int              # path width k + 1
    chunk_size: int      # the driver's chunk split (cs)
    block_rows: int      # B: pow2 row height of one pop (>= chunk_size)
    max_deg: int         # pow2 fan-out bound of the whole index
    cap: int             # block_rows * max_deg candidate slots
    arena_cap: int       # live arena rows (stack region)
    arena_rows: int      # arena_cap + cap (scratch tail)
    emit_cap: int        # emitted rows one round may buffer
    max_chunks: int      # live meta slots
    max_pieces: int      # bound on pieces one push can create
    round_pops: int      # pops per host round trip


def deque_config(k1: int, chunk_size: int, max_deg: int,
                 round_pops: int = 64) -> DequeConfig:
    """Size a ``DequeConfig`` for one index and driver (``repro``'s
    formulas)."""
    B = _next_pow2(max(chunk_size, 8))
    md = _next_pow2(max(max_deg, 1))
    cap = B * md
    arena_cap = max(8 * cap, 4 * B)
    emit_cap = max(4 * cap, 4 * B)
    maxp = cap // max(chunk_size, 1) + 2
    maxc = max(4096, 8 * maxp)
    return DequeConfig(k1=k1, chunk_size=chunk_size, block_rows=B,
                       max_deg=md, cap=cap, arena_cap=arena_cap,
                       arena_rows=arena_cap + cap, emit_cap=emit_cap,
                       max_chunks=maxc, max_pieces=maxp,
                       round_pops=round_pops)


def frontier_deque_init(root: np.ndarray, *, cfg: DequeConfig,
                        device: torch.device | str
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor, torch.Tensor]:
    """Fresh deque state on ``device`` holding one root chunk (the (k+1,)
    root row): ``(arena, meta_depth, meta_len, top, n_chunks)``."""
    arena = torch.full((cfg.arena_rows, cfg.k1), PAD, dtype=torch.int32,
                       device=device)
    arena[0] = torch.as_tensor(np.asarray(root, np.int32)).to(device)
    meta_depth = torch.zeros(cfg.max_chunks + cfg.max_pieces,
                             dtype=torch.int32, device=device)
    meta_len = meta_depth.clone()
    meta_len[0] = 1
    one = torch.ones((), dtype=torch.int32, device=device)
    return arena, meta_depth, meta_len, one, one.clone()


def _deque_round(arena: torch.Tensor, meta_depth: torch.Tensor,
                 meta_len: torch.Tensor, top: torch.Tensor,
                 n_chunks: torch.Tensor, begin: torch.Tensor,
                 end: torch.Tensor, dst: torch.Tensor, t: int, *,
                 cfg: DequeConfig) -> tuple[torch.Tensor, ...]:
    """``round_pops`` masked pop → masks → compact → push iterations."""
    dev = arena.device
    cs, cap, B, k1 = cfg.chunk_size, cfg.cap, cfg.block_rows, cfg.k1

    def i32(x: int) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.int32).to(dev)

    rowid = torch.arange(B, device=dev)
    slots = torch.arange(cap, device=dev)
    pj = torch.arange(cfg.max_pieces, device=dev)
    arena_scratch = cfg.arena_cap + slots
    meta_scratch = cfg.max_chunks + pj
    t_dev = i32(t)
    emitbuf = torch.full((cfg.emit_cap + cap, k1), PAD, dtype=torch.int32,
                         device=dev)
    emitlen = torch.zeros(cfg.emit_cap + cap, dtype=torch.int32, device=dev)
    top = top.to(torch.int64)
    nc = n_chunks.to(torch.int64)
    ne = torch.zeros((), dtype=torch.int64, device=dev)
    ctr = torch.zeros(4, dtype=torch.int32, device=dev)
    pops = torch.zeros((), dtype=torch.int64, device=dev)

    for _ in range(cfg.round_pops):
        active = ((nc > 0) & (pops < cfg.round_pops)
                  & (top + cap <= cfg.arena_cap)
                  & (ne + cap <= cfg.emit_cap)
                  & (nc + cfg.max_pieces <= cfg.max_chunks))
        # pop the top chunk: gathers at a device offset (indexing with a
        # 0-d tensor would read it on the host and stall the stream)
        cidx = torch.clamp(nc - 1, min=0).view(1)
        clen = meta_len.index_select(0, cidx).to(torch.int64).view(())
        cdepth = meta_depth.index_select(0, cidx).view(())
        cstart = top - clen
        block = arena.index_select(
            0, torch.clamp(cstart + rowid, 0, cfg.arena_rows - 1))
        paths = torch.where(((rowid < clen) & active)[:, None], block, PAD)
        depth_rows = cdepth.expand(paths.shape[0])
        meta = torch.stack([cdepth, t_dev])
        vnew, emit, cont, ctr1 = frontier_masks_plain(
            paths, begin, end, dst, meta, max_deg=cfg.max_deg)
        ctr = ctr + ctr1                       # all-PAD rows add zeros
        vflat = vnew.view(-1)

        # completed paths: the compacted emit children land at n_emit
        flat_emit = emit.view(-1) != 0
        eidx, ne_new = compact(flat_emit)
        echild = children(paths, vflat, eidx, depth_rows, cfg.max_deg)
        wpos = ne + slots
        emitbuf[wpos] = torch.where(active, echild, emitbuf[wpos])
        emitlen[wpos] = torch.where(active, (cdepth + 1).to(torch.int32),
                                    emitlen[wpos])
        ne = ne + ne_new

        # push: scatter cont children so piece 0 lands on top (the host
        # driver pushes pieces reversed) with intra-piece order intact
        s_top = torch.where(active, cstart, top)
        s_nc = torch.where(active, nc - 1, nc)
        wantc = cdepth + 1 < k1 - 1
        flat_cont = (cont.view(-1) != 0) & wantc
        n_cont = flat_cont.sum()
        crank = torch.cumsum(flat_cont, dim=0) - 1
        piece = torch.div(crank, cs, rounding_mode="floor")
        np_pieces = torch.div(n_cont + cs - 1, cs, rounding_mode="floor")
        dest = (s_top + n_cont - torch.minimum((piece + 1) * cs, n_cont)
                + (crank - piece * cs))
        dest = torch.where(flat_cont, dest, arena_scratch)
        child_rows = children(paths, vflat, slots, depth_rows, cfg.max_deg)
        arena[dest] = torch.where(active, child_rows, arena[dest])
        slot = torch.where(pj < np_pieces, s_nc + np_pieces - 1 - pj,
                           meta_scratch)
        meta_depth[slot] = torch.where(active, (cdepth + 1).to(torch.int32),
                                       meta_depth[slot])
        piece_len = torch.clamp(n_cont - pj * cs, 0, cs).to(torch.int32)
        meta_len[slot] = torch.where(active, piece_len, meta_len[slot])
        top = s_top + n_cont
        nc = s_nc + np_pieces
        pops = pops + active.to(torch.int64)

    return (arena, meta_depth, meta_len, top.to(torch.int32),
            nc.to(torch.int32), emitbuf, emitlen, ne.to(torch.int32), ctr,
            pops.to(torch.int32))


def _deque_lib() -> ctypes.CDLL:
    lib = _build.load("deque_round")
    fn = lib.deque_round_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_deque_args(arena, meta_depth, meta_len, top, n_chunks, begin,
                      end, dst, cfg: DequeConfig) -> None:
    dev = arena.device
    named = (("arena", arena), ("meta_depth", meta_depth),
             ("meta_len", meta_len), ("top", top), ("n_chunks", n_chunks),
             ("begin", begin), ("end", end), ("dst", dst))
    for name, x in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, arena on {dev}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if arena.shape != (cfg.arena_rows, cfg.k1):
        raise ValueError(f"arena must be ({cfg.arena_rows}, {cfg.k1}), got "
                         f"{tuple(arena.shape)}")
    slots = cfg.max_chunks + cfg.max_pieces
    if meta_depth.shape != (slots,) or meta_len.shape != (slots,):
        raise ValueError(f"meta_depth and meta_len must be ({slots},)")
    if top.numel() != 1 or n_chunks.numel() != 1:
        raise ValueError("top and n_chunks must hold one value each")
    if end.dim() != 2 or end.shape != (begin.shape[0], cfg.k1):
        raise ValueError(f"end must be (n, k+1) = ({begin.shape[0]}, "
                         f"{cfg.k1}), got {tuple(end.shape)}")
    if dst.dim() != 1 or dst.shape[0] < 1:
        raise ValueError("dst needs at least one element")


def _deque_round_cuda(arena: torch.Tensor, meta_depth: torch.Tensor,
                      meta_len: torch.Tensor, top: torch.Tensor,
                      n_chunks: torch.Tensor, begin: torch.Tensor,
                      end: torch.Tensor, dst: torch.Tensor, t: int,
                      cfg: DequeConfig) -> tuple[torch.Tensor, ...]:
    """One launch of the persistent round kernel (``csrc/deque_round.cu``).
    The emit buffers are left uninitialised: the kernel writes their first
    ``n_emit`` rows, the only ones read."""
    global deque_rounds, _last_scalars
    dev = arena.device
    # one block per SM, resident for the whole round
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = cfg.emit_cap + cfg.cap
    emitbuf = torch.empty((rows, cfg.k1), dtype=torch.int32, device=dev)
    emitlen = torch.empty(rows, dtype=torch.int32, device=dev)
    # [16 scalars | row counts (B, 2) | block totals (blocks, 2) | row
    # copies (B, k1)]
    B = cfg.block_rows
    buf = torch.empty(16 + 2 * B + 2 * blocks + B * cfg.k1,
                      dtype=torch.int32, device=dev)
    scal = buf[:16]
    status = _deque_lib().deque_round_launch(
        arena.data_ptr(), meta_depth.data_ptr(), meta_len.data_ptr(),
        top.data_ptr(), n_chunks.data_ptr(), begin.data_ptr(),
        end.data_ptr(), dst.data_ptr(), dst.shape[0], t, emitbuf.data_ptr(),
        emitlen.data_ptr(), scal.data_ptr(), buf[16:].data_ptr(), blocks,
        cfg.k1, cfg.chunk_size, B, cfg.max_deg, cfg.cap, cfg.arena_cap,
        cfg.emit_cap, cfg.max_chunks, cfg.max_pieces, cfg.round_pops,
        _build.stream(dev))
    _build.check(status, "frontier_deque_round")
    deque_rounds += 1
    _last_scalars = scal
    return (arena, meta_depth, meta_len, scal[0], scal[1], emitbuf, emitlen,
            scal[2], scal[4:8], scal[3])


def last_round_iterations() -> int:
    """Loop iterations of the last CUDA round: its pops plus the last,
    failing evaluation of the loop condition (reads the card; for the
    tests and chip_smoke.py)."""
    if _last_scalars is None:
        raise RuntimeError("no deque round has run on a CUDA device")
    return int(_last_scalars[8].item())


def frontier_deque_round(arena: torch.Tensor, meta_depth: torch.Tensor,
                         meta_len: torch.Tensor, top: torch.Tensor,
                         n_chunks: torch.Tensor, begin: torch.Tensor,
                         end: torch.Tensor, dst: torch.Tensor, t: int, *,
                         cfg: DequeConfig) -> tuple[torch.Tensor, ...]:
    """One host round trip of the device-resident deque.

    Runs up to ``cfg.round_pops`` pop → expand → push iterations on the
    state's device and returns ``(arena, meta_depth, meta_len, top,
    n_chunks, emitbuf, emitlen, n_emit, counters, pops)`` as ``repro``'s
    ``ops.frontier_deque_round`` does.  The first ``n_emit`` rows of
    ``emitbuf`` are the paths completed this round (``emitlen`` their hop
    counts), ``counters`` the summed (4,) Fig.-6 vector and ``pops`` the
    chunks consumed.  ``pops == 0`` with ``n_chunks > 0`` is a capacity
    stall: the caller rebuilds its host work list from ``arena[:top]`` and
    the bottom ``n_chunks`` meta slots.  The input state is updated in
    place.

    CUDA tensors launch the persistent kernel of ``csrc/deque_round.cu``
    once (and raise if the launch fails); CPU tensors take
    ``frontier_deque_round_plain``.  On the card only the regions
    ``DequeConfig`` names are written.
    """
    global _dispatch_count
    _check_deque_args(arena, meta_depth, meta_len, top, n_chunks, begin,
                      end, dst, cfg)
    _dispatch_count += 1
    if not arena.is_cuda:
        return frontier_deque_round_plain(arena, meta_depth, meta_len, top,
                                          n_chunks, begin, end, dst, t,
                                          cfg=cfg)
    return _deque_round_cuda(arena, meta_depth, meta_len, top, n_chunks,
                             begin, end, dst, t, cfg)


def frontier_deque_round_plain(arena: torch.Tensor, meta_depth: torch.Tensor,
                               meta_len: torch.Tensor, top: torch.Tensor,
                               n_chunks: torch.Tensor, begin: torch.Tensor,
                               end: torch.Tensor, dst: torch.Tensor, t: int,
                               *, cfg: DequeConfig
                               ) -> tuple[torch.Tensor, ...]:
    """``frontier_deque_round`` in plain PyTorch on any device: a loop of
    ``round_pops`` masked iterations around the plain frontier masks, every
    returned array equal to ``repro``'s.  The CUDA round is held to it on
    the card, on the regions the host reads back."""
    return _deque_round(arena, meta_depth, meta_len, top, n_chunks, begin,
                        end, dst, t, cfg=cfg)
