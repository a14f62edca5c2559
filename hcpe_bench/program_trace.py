"""The program's own spans and counters (``repro_torch.core.trace``) read
beside the device trace of a ``--trace 1`` run.

``harness.run_cell`` switches the program's recorder on for a traced
run and puts in the run's context what the metric readers read:

* ``program_setup``: the spans and counters of the set-up (the warm-up
  included), drained when the window starts;
* ``program``: the window's, drained when it closes;
* ``program_device``: ``read_device`` over the profiler's events and
  the window's spans.

What is read:

* self time of a span: its duration less the union of its children;
* each idle gap of the window labelled by the innermost program span at
  its midpoint, or ``OUTSIDE``;
* each device operation tied to the innermost program span that holds
  the host start of the runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) with the operation's correlation id, and
  each device copy's bytes.

A new per-layer metric over a program span is a ``metrics/<name>.py``
whose ``read(ctx)`` calls these functions; the harness needs no edit.
Each metric function takes the run's context and returns a number, or
None when the run gave it nothing to read (no program spans, or no
device operation on a CPU run).
"""
from __future__ import annotations

import collections
import heapq
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .tracing import WINDOW_SPAN

OUTSIDE = "outside the program's spans"
# the program spans whose subtrees are the fused driver's and K5's
FUSED_SPAN = "enumeration.fused"
K5_SPAN = "k5.dispatch"
# the span of the fused enumeration's copies back of each dispatch's head
# and child rows
READBACK_SPAN = "fused.readback"
# the bytes K5's hop reads a member of a dispatch: its target, depth and
# wantc (int32 each) and its row of the member table (five int64)
MEMBER_BYTES = 12 + 40


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _union_ns(ivs: Sequence[Tuple[int, int]]) -> int:
    total, cur = 0, None
    for a, b in sorted(ivs):
        if cur is None or a > cur[1]:
            if cur is not None:
                total += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        total += cur[1] - cur[0]
    return total


def self_seconds(spans) -> Dict[str, float]:
    """Seconds by span name of each span's duration less the union of
    its children's intervals (clipped to it)."""
    kids: Dict[int, List[Tuple[int, int]]] = collections.defaultdict(list)
    for s in spans:
        if s.parent:
            kids[s.parent].append((s.start_ns, s.end_ns))
    out: Dict[str, float] = collections.defaultdict(float)
    for s in spans:
        clipped = [(max(a, s.start_ns), min(b, s.end_ns))
                   for a, b in kids.get(s.id, ()) if b > s.start_ns
                   and a < s.end_ns]
        out[s.name] += (s.end_ns - s.start_ns - _union_ns(clipped)) / 1e9
    return dict(out)


def innermost(spans, points: Sequence[int]) -> List[Optional[int]]:
    """For each point, the id of the latest-starting span that holds
    it, or None."""
    order = sorted(spans, key=lambda s: s.start_ns)
    out: List[Optional[int]] = [None] * len(points)
    heap: List[Tuple[int, int, int]] = []
    i = 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        p = points[j]
        while i < len(order) and order[i].start_ns <= p:
            s = order[i]
            heapq.heappush(heap, (-s.start_ns, s.end_ns, s.id))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out[j] = heap[0][2] if heap else None
    return out


def under(spans, name: str) -> set:
    """The ids of the spans called ``name`` and of all their
    descendants."""
    kids: Dict[int, List[int]] = collections.defaultdict(list)
    for s in spans:
        kids[s.parent].append(s.id)
    todo = [s.id for s in spans if s.name == name]
    found = set(todo)
    while todo:
        for k in kids.get(todo.pop(), ()):
            if k not in found:
                found.add(k)
                todo.append(k)
    return found


# ---------------------------------------------------------------------------
# the device trace
# ---------------------------------------------------------------------------

def _ns(ev, what: str) -> int:
    get = getattr(ev, f"{what}_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(ev, f"{what}_us")() * 1000)


def copy_bytes(prof) -> Dict[int, int]:
    """Bytes of each device copy by its correlation id.  The profiler's
    events carry no byte counts; its exported trace does, so the trace
    is written to a temporary file, read and removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    out = {}
    for ev in events:
        args = ev.get("args") or {}
        if ev.get("cat") == "gpu_memcpy" and "bytes" in args:
            out[int(args["correlation"])] = int(args["bytes"])
    return out


def read_device(prof, spans, nbytes: Optional[Dict[int, int]] = None,
                top: int = 10) -> Optional[dict]:
    """The window's device operations against the program's spans:

    * ``window_s``: the ``bench.window`` range;
    * ``busy_s``: the union of device-operation intervals inside it;
    * ``kernel_s``: device seconds by operation name, and
      ``device_ops``, the ``top`` largest of them;
    * ``idle_s``: idle seconds by the id of the innermost span at each
      gap's midpoint, None for none;
    * ``device_s``: device seconds, clipped to the window, by the id of
      the span that holds the operation's runtime call, None for none;
    * ``copy_bytes``: the bytes of the device copies (``nbytes``, by
      correlation id) by the id of the span that holds their call.

    None when the trace holds no window span."""
    nbytes = nbytes or {}
    win = None
    ops: List[Tuple[int, int, int, str]] = []
    calls: Dict[int, int] = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if name == WINDOW_SPAN:
            # a record_function range has a device-side twin in the
            # trace; only the host side is the window
            if not on_device:
                start = _ns(ev, "start")
                win = (start, start + _ns(ev, "duration"))
            continue
        if on_device:
            start = _ns(ev, "start")
            ops.append((start, start + _ns(ev, "duration"),
                        ev.correlation_id(), name))
        elif name.startswith("cu") and ev.correlation_id() > 0:
            calls[ev.correlation_id()] = _ns(ev, "start")
    if win is None:
        return None
    lo, hi = win
    clipped = [(max(a, lo), min(b, hi), c, n) for a, b, c, n in ops]
    clipped = [op for op in clipped if op[1] > op[0]]
    by_name: Dict[str, float] = collections.defaultdict(float)
    gaps, cur, busy = [], lo, 0
    for a, b, _c, name in sorted(clipped):
        by_name[name] += (b - a) / 1e9
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    idle: Dict[Optional[int], float] = collections.defaultdict(float)
    for (a, b), sid in zip(gaps, innermost(spans,
                                           [(a + b) // 2 for a, b in gaps])):
        idle[sid] += (b - a) / 1e9
    device: Dict[Optional[int], float] = collections.defaultdict(float)
    copied: Dict[Optional[int], int] = collections.defaultdict(int)
    # an operation with no runtime call in the trace is owned by none
    owners = innermost(spans, [calls.get(c, -1) for _a, _b, c, _n
                               in clipped])
    for (a, b, c, _n), sid in zip(clipped, owners):
        device[sid] += (b - a) / 1e9
        if c in nbytes:
            copied[sid] += nbytes[c]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernel_s": dict(by_name),
            "device_ops": [[n, s] for n, s in ranked[:top]],
            "idle_s": dict(idle), "device_s": dict(device),
            "copy_bytes": dict(copied)}


# ---------------------------------------------------------------------------
# what a run's context gives
# ---------------------------------------------------------------------------

def _window(ctx: dict):
    got = ctx.get("program")
    return got if got is not None and got.spans else None


def program_idle_gaps(ctx: dict) -> Optional[List[list]]:
    """The window's idle seconds by the innermost program span's name
    (``OUTSIDE`` for none), largest first; they sum to the window's
    idle seconds."""
    got, dev = _window(ctx), ctx.get("program_device")
    if got is None or dev is None:
        return None
    names = {s.id: s.name for s in got.spans}
    idle: Dict[str, float] = collections.defaultdict(float)
    for sid, sec in dev["idle_s"].items():
        idle[names[sid] if sid is not None else OUTSIDE] += sec
    return [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])]


def device_tied_pct(ctx: dict) -> Optional[float]:
    """Device seconds of the window whose runtime call lies inside a
    program span, over all device seconds of the window."""
    dev = ctx.get("program_device")
    total = sum(dev["device_s"].values()) if dev else 0.0
    if total <= 0:
        return None
    return 100.0 * (total - dev["device_s"].get(None, 0.0)) / total


def _dispatches(got) -> int:
    return got.counters.get("k5.dispatches", 0) if got is not None else 0


def k5_device_ms_per_dispatch(ctx: dict) -> Optional[float]:
    """Device milliseconds of the operations launched inside
    ``k5.dispatch`` spans, a dispatch."""
    got, dev = _window(ctx), ctx.get("program_device")
    n = _dispatches(got)
    if not n or dev is None or dev["busy_s"] <= 0:
        return None
    ids = under(got.spans, K5_SPAN)
    return 1e3 * sum(s for sid, s in dev["device_s"].items()
                     if sid in ids) / n


def fused_rows_per_dispatch(ctx: dict) -> Optional[float]:
    """Rows handed to K5, a dispatch (the program's counters)."""
    got = _window(ctx)
    n = _dispatches(got)
    return got.counters.get("k5.rows", 0) / n if n else None


def fused_idle_ms_per_dispatch(ctx: dict) -> Optional[float]:
    """Idle milliseconds of the window whose innermost program span is
    ``enumeration.fused`` or below it, a dispatch."""
    got, dev = _window(ctx), ctx.get("program_device")
    n = _dispatches(got)
    if not n or dev is None or dev["busy_s"] <= 0:
        return None
    ids = under(got.spans, FUSED_SPAN)
    return 1e3 * sum(s for sid, s in dev["idle_s"].items()
                     if sid in ids) / n


def serve_host_ms_per_query(ctx: dict) -> Optional[float]:
    """Self milliseconds of ``serve`` spans, a request served."""
    got = _window(ctx)
    if got is None:
        return None
    served = sum(len(s.attrs["uids"]) for s in got.spans
                 if s.name == "serve")
    if not served:
        return None
    return 1e3 * self_seconds(got.spans).get("serve", 0.0) / served


def index_ms_per_miss(ctx: dict) -> Optional[float]:
    """Milliseconds of the set-up's ``index.resolve`` spans, an index
    miss."""
    got = ctx.get("program_setup")
    misses = got.counters.get("index.misses", 0) if got is not None else 0
    if not misses:
        return None
    return 1e3 * sum((s.end_ns - s.start_ns) / 1e9 for s in got.spans
                     if s.name == "index.resolve") / misses


def k5_input_bytes(ctx: dict) -> Optional[int]:
    """The bytes K5's hop reads in the window, each once, from the
    program's counters: every row's prefix up to its depth
    (``k5.prefix_bytes``), its member rank and its ``begin`` and ``end``
    entries (int32 each), one ``dst`` entry a candidate edge (int32),
    and a member of a dispatch its target, depth and ``wantc`` (int32
    each) and its row of the member table (five int64)."""
    got = _window(ctx)
    if not _dispatches(got):
        return None
    c = got.counters
    return (c.get("k5.prefix_bytes", 0) + 12 * c.get("k5.rows", 0)
            + 4 * c.get("k5.candidate_edges", 0)
            + MEMBER_BYTES * c.get("k5.members", 0))


def k5_output_bytes(ctx: dict) -> Optional[int]:
    """The bytes K5's hop wrote in the window, each once: what the
    device copied back inside ``fused.readback`` spans, which is all
    the hop writes: each dispatch's head (24 bytes a member), then
    its emit and continue rows (``4 * k1`` bytes a child row at the
    packed width ``k1``).  None without a device copy there."""
    got, dev = _window(ctx), ctx.get("program_device")
    if not _dispatches(got) or dev is None:
        return None
    ids = under(got.spans, READBACK_SPAN)
    copied = sum(b for sid, b in dev["copy_bytes"].items() if sid in ids)
    return copied if copied > 0 else None


# ---------------------------------------------------------------------------
# the recorder's own cost
# ---------------------------------------------------------------------------

def _per_call_ns(fn, n: int) -> float:
    t0 = time.perf_counter_ns()
    fn(n)
    return (time.perf_counter_ns() - t0) / n


def recorder_cost(spans: int, dispatches: int, rows: int,
                  members: int) -> dict:
    """The program recorder's host cost, off and on, in ns a call,
    measured in this process, and its cost on for the window's
    ``spans`` and ``dispatches`` (a dispatch's counters at ``rows`` rows
    over ``members`` members).  Leaves the recorder off and empty."""
    from repro_torch.core import fused, trace as rec
    n = 20000
    m = max(members, 1)
    cut = [int(c) for c in np.linspace(0, max(rows, 1), m + 1)]
    held = [(None, np.zeros((b - a, 4), np.int32), 1, None)
            for a, b in zip(cut[:-1], cut[1:])]
    totals = [3 * (b - a) for a, b in zip(cut[:-1], cut[1:])]
    cnt = np.full(max(rows, 1), 3, np.int64)

    def empty(k):
        for _ in range(k):
            pass

    def spans_(k):
        for _ in range(k):
            with rec.span("k5.stage"):
                pass

    def counts(k):
        for _ in range(k):
            rec.count("k5.rows", 3)

    def k5_counters(k):
        # a dispatch's counters: the fused driver's, then the kernel
        # entry's
        for _ in range(k):
            if rec.enabled():
                fused._count_k5_inputs(0, cut[-1], held, totals, cnt)
            rec.count("k5.dispatches")
            rec.count("k5.rows", rows)
            rec.count("k5.members", m)

    rec.disable()
    base = _per_call_ns(empty, n)
    off = {"span_off_ns": _per_call_ns(spans_, n) - base,
           "count_off_ns": _per_call_ns(counts, n) - base}
    rec.enable()
    try:
        on = {"span_on_ns": _per_call_ns(spans_, n) - base,
              "count_on_ns": _per_call_ns(counts, n) - base,
              "k5_counters_on_ns": _per_call_ns(k5_counters, n // 10) - base}
    finally:
        rec.disable()
        rec.drain()
    cost_s = (spans * on["span_on_ns"]
              + dispatches * on["k5_counters_on_ns"]) / 1e9
    return {**off, **on, "spans": spans, "dispatches": dispatches,
            "cost_s": cost_s}


def program_block(ctx: dict) -> dict:
    """What the result line of a traced run carries beside its metrics:
    the window's counters and self seconds by span name, the bytes K5's
    hop read and wrote, the share of device seconds tied to program spans,
    and the recorder's cost (its share of the window in ``cost_pct``)."""
    got = _window(ctx)
    counters = got.counters if got is not None else {}
    n = counters.get("k5.dispatches", 0)
    cost = recorder_cost(
        len(got.spans) if got is not None else 0, n,
        counters.get("k5.rows", 0) // max(n, 1),
        counters.get("k5.members", 0) // max(n, 1))
    window_s = (ctx.get("program_device") or {}).get("window_s")
    if window_s:
        cost["cost_pct"] = 100.0 * cost["cost_s"] / window_s
    return {"counters": counters,
            "k5_input_bytes": k5_input_bytes(ctx),
            "k5_output_bytes": k5_output_bytes(ctx),
            "device_tied_pct": device_tied_pct(ctx),
            "self_s": self_seconds(got.spans) if got is not None else {},
            "recorder": cost}
