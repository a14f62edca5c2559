"""The program's own spans and counters (``repro_torch.core.trace``) read
beside the device trace of a ``--trace 1`` run.

``harness.run_cell`` does not switch the program's recorder on.  Until it
does, ``run_cell`` here drives one traced run through it with the
recorder on from the warm-up: it drains the recorder once when the
window's loop starts (the set-up's spans, ``ctx["program_setup"]``) and
once when the harness reads the device trace (the window's,
``ctx["program"]``), and reads the profiler's events beside the
window's spans (``read_device``, ``ctx["program_device"]``).  It
returns the harness's result line with ``program_idle_gaps``, the five
metrics of ``METRICS`` and a ``program`` block added:

    python3 -m hcpe_bench.program_trace --workload <cell> --seed <n> \
        --seconds <s>

What is read:

* self time of a span: its duration less the union of its children;
* each idle gap of the window labelled by the innermost program span at
  its midpoint, or ``OUTSIDE``;
* each device operation tied to the innermost program span that holds
  the host start of the runtime call (``cudaLaunchKernel``,
  ``cudaMemcpyAsync``, ...) with the operation's correlation id.

Each metric function takes the run's context and returns a number, or
None when the run gave it nothing to read (no program spans, or no
device operation on a CPU run).
"""
from __future__ import annotations

import argparse
import collections
import heapq
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import harness, loops, tracing

OUTSIDE = "outside the program's spans"
# the program spans whose subtrees are the fused driver's and K5's
FUSED_SPAN = "enumeration.fused"
K5_SPAN = "k5.dispatch"


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

def read_device(prof, spans) -> Optional[dict]:
    """The window's device operations and idle gaps against the
    program's spans: ``window_s`` and ``busy_s`` as
    ``tracing.read_trace`` has them, ``idle_s`` (idle seconds by the id
    of the innermost span at each gap's midpoint, None for none) and
    ``device_s`` (device seconds, clipped to the window, by the id of
    the span that holds the operation's runtime call, None for none).
    None when the trace holds no window span."""
    win = None
    ops: List[Tuple[int, int, int]] = []
    calls: Dict[int, int] = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if name in tracing.SPAN_NAMES or name == tracing.WINDOW_SPAN:
            if not on_device and name == tracing.WINDOW_SPAN:
                start = tracing._ns(ev, "start")
                win = (start, start + tracing._ns(ev, "duration"))
            continue
        if on_device:
            start = tracing._ns(ev, "start")
            ops.append((start, start + tracing._ns(ev, "duration"),
                        ev.correlation_id()))
        elif name.startswith("cu") and ev.correlation_id() > 0:
            calls[ev.correlation_id()] = tracing._ns(ev, "start")
    if win is None:
        return None
    lo, hi = win
    clipped = [(max(a, lo), min(b, hi), c) for a, b, c in ops]
    clipped = [(a, b, c) for a, b, c in clipped if b > a]
    gaps, cur, busy = [], lo, 0
    for a, b, _c in sorted(clipped):
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
    # an operation with no runtime call in the trace is owned by none
    owners = innermost(spans, [calls.get(c, -1) for _a, _b, c in clipped])
    for (a, b, _c), sid in zip(clipped, owners):
        device[sid] += (b - a) / 1e9
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "idle_s": dict(idle), "device_s": dict(device)}


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


def k5_program_bytes(ctx: dict) -> Optional[int]:
    """The bytes K5's inputs need, from the program's counters, counted
    as ``tracing.K5Recorder.needed_bytes`` counts them."""
    got = _window(ctx)
    if not _dispatches(got):
        return None
    c = got.counters
    return (c.get("k5.prefix_bytes", 0) + 8 * c.get("k5.rows", 0)
            + 8 * c.get("k5.candidate_edges", 0)
            + 24 * c.get("k5.members", 0))


# name -> (unit, reader)
METRICS = {
    "k5_device_ms_per_dispatch.batch": ("ms", k5_device_ms_per_dispatch),
    "fused_rows_per_dispatch.batch": ("rows", fused_rows_per_dispatch),
    "fused_idle_ms_per_dispatch.batch": ("ms", fused_idle_ms_per_dispatch),
    "serve_host_ms_per_query.batch": ("ms", serve_host_ms_per_query),
    "index_ms_per_miss.setup": ("ms", index_ms_per_miss),
}


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


# ---------------------------------------------------------------------------
# one traced run with the recorder on
# ---------------------------------------------------------------------------

class _Hooks:
    """Installs, for one ``harness.run_cell``, the drains around the
    window and the device read beside ``tracing.read_trace``."""

    def __init__(self, rec) -> None:
        self.rec = rec
        self.ctx: dict = {}
        self._undo: List[Tuple[object, str, object]] = []
        for name in ("closed_loop", "open_loop"):
            self._patch(loops, name, self._window_start(getattr(loops,
                                                                name)))
        read_trace = tracing.read_trace

        def read(prof, spans, *a, **kw):
            self.rec.disable()
            got = self.rec.drain()
            self.ctx["program"] = got
            self.ctx["program_device"] = read_device(prof, got.spans)
            return read_trace(prof, spans, *a, **kw)
        self._patch(tracing, "read_trace", read)
        needed = tracing.K5Recorder.needed_bytes

        def needed_bytes(recorder):
            self.ctx["k5_bytes"] = needed(recorder)
            return self.ctx["k5_bytes"]
        self._patch(tracing.K5Recorder, "needed_bytes", needed_bytes)

    def _window_start(self, loop):
        def hooked(*args, **kw):
            if args[-1] > 0:  # the window, not the warm-up batch
                self.ctx["program_setup"] = self.rec.drain()
            return loop(*args, **kw)
        return hooked

    def _patch(self, owner, attr: str, value) -> None:
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def remove(self) -> None:
        for owner, attr, old in reversed(self._undo):
            setattr(owner, attr, old)
        self._undo.clear()


def run_cell(name: str, seed: int, seconds: float, device: str = "cuda",
             started: Optional[float] = None, spec: Optional[dict] = None,
             base: Path = harness.HERE, log=None) -> dict:
    """One ``--trace 1`` run of ``harness.run_cell`` with the program's
    recorder on from the warm-up; its result line with
    ``program_idle_gaps``, ``METRICS`` and a ``program`` block (the K5
    bytes from the program's counters and from ``K5Recorder``, the
    device seconds tied to program spans, the recorder's cost)."""
    from repro_torch.core import trace as rec
    rec.drain()
    rec.enable()
    hooks = _Hooks(rec)
    try:
        result = harness.run_cell(name, seed, seconds, True, device=device,
                                  started=started, spec=spec, base=base,
                                  log=log)
    finally:
        hooks.remove()
        rec.disable()
    ctx = hooks.ctx
    for metric, (unit, read) in METRICS.items():
        value = read(ctx)
        if value is not None:
            result["metrics"][metric] = {"value": value, "unit": unit}
    result["program_idle_gaps"] = program_idle_gaps(ctx)
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
    result["program"] = {"k5_bytes": k5_program_bytes(ctx),
                         "recorder_k5_bytes": ctx.get("k5_bytes"),
                         "device_tied_pct": device_tied_pct(ctx),
                         "counters": counters,
                         "self_s": self_seconds(got.spans) if got else {},
                         "recorder": cost}
    return result


def main(argv=None) -> int:
    started = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    cache = harness.REPO / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs on the card only",
              file=sys.stderr)
        return 2
    harness.use_checkout_program()

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      started=started, log=log)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
