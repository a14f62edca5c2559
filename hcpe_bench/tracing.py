"""Spans, counters and the device trace of a ``--trace 1`` run.

Nothing here changes the program: ``Spans`` wraps the entries of each
layer from the benchmark's side (module attributes the port looks up at
call time, and the engine's ``run`` on the one engine instance) in a
``torch.profiler.record_function`` and a host-clock total, and keeps
each engine batch's plain counters.  ``K5Recorder`` keeps, for every
fused dispatch, what the K5 kernel's inputs need: the rows, each row's
depth and member, and the member's index arrays, so that the bytes are
counted after the window.  ``read_trace`` reduces the profiler's events
to the device's busy time within the window, the time of each device
operation, and the idle gaps labelled by the innermost span the host
was in.
"""
from __future__ import annotations

import collections
import heapq
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW_SPAN = "bench.window"
# the spans the benchmark records around the port's layers
SPAN_NAMES = frozenset({"engine.run",
                        "index.resolve", "planner.plan",
                        "enumeration.shared", "enumeration.fused",
                        "enumeration.join", "enumeration.dfs",
                        "kernels.k5_dispatch"})


def batch_counters(out) -> dict:
    """One engine ``BatchOutput`` as plain numbers: its timing split,
    cache delta, distinct queries and the plans of its distinct
    queries."""
    plans: Dict[str, int] = collections.Counter(
        it.plan.method for it in out.items if not it.deduplicated)
    tm = out.timing
    return {"queries": len(out.items), "distinct": out.distinct_queries,
            "distance_s": tm.distance_seconds, "index_s": tm.index_seconds,
            "optimize_s": tm.optimize_seconds,
            "enumerate_s": tm.enumerate_seconds, "total_s": tm.total_seconds,
            "hits": out.cache_stats.hits, "misses": out.cache_stats.misses,
            "plans": dict(plans), "fused_queries": out.fused_queries,
            "fused_dispatches": out.fused_dispatches,
            "shared_queries": out.shared_queries}


class Spans:
    """Wraps the port's layer entries while installed; ``totals`` holds
    host seconds by span name and ``batches`` each engine batch's
    ``batch_counters``."""

    def __init__(self, engine, modules: dict) -> None:
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.batches: List[dict] = []
        self.intervals: List[Tuple[int, int, str]] = []
        self.recording = False
        self._undo: List[Tuple[object, str, object]] = []
        targets = [
            (modules["batch"].BatchPathEnum, "_indexes_for", "index.resolve"),
            (modules["planner"], "plan_query", "planner.plan"),
            (modules["sharing"], "run_shared_groups", "enumeration.shared"),
            (modules["fused"], "enumerate_fused_device", "enumeration.fused"),
            (modules["batch"], "enumerate_paths_join", "enumeration.join"),
            (modules["batch"], "enumerate_paths_idx", "enumeration.dfs"),
        ]
        for owner, attr, name in targets:
            self._patch(owner, attr, self._wrap(name, getattr(owner, attr)))
        run = self._wrap("engine.run", engine.run)

        def engine_run(*args, **kw):
            out = run(*args, **kw)
            if self.recording:
                self.batches.append(batch_counters(out))
            return out
        self._patch(engine, "run", engine_run)

    def _wrap(self, name: str, fn: Callable) -> Callable:
        """``fn`` inside a span: a ``record_function`` for the profiler's
        table, and, while recording, a host interval on the trace's
        clock (the epoch in ns) kept here, from whichever thread."""
        def wrapped(*args, **kw):
            if not self.recording:
                return fn(*args, **kw)
            t0 = time.perf_counter()
            start = time.time_ns()
            try:
                with torch.profiler.record_function(name):
                    return fn(*args, **kw)
            finally:
                self.intervals.append((start, time.time_ns(), name))
                self.totals[name] += time.perf_counter() - t0
        return wrapped

    def _patch(self, owner, attr: str, value) -> None:
        # None: the attribute came from the class (the engine's ``run``)
        self._undo.append((owner, attr, owner.__dict__.get(attr)))
        setattr(owner, attr, value)

    def remove(self) -> None:
        """Put every wrapped entry back."""
        for owner, attr, old in reversed(self._undo):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._undo.clear()


class K5Recorder:
    """Wraps ``ops.frontier_expand_fused`` (the fused driver looks it up
    at call time); while ``recording``, keeps per member of each
    dispatch the last vertex of each of its rows and the column of
    ``end`` the kernel reads for them."""

    def __init__(self, ops, intervals: List[Tuple[int, int, str]]) -> None:
        self.ops = ops
        self.orig = ops.frontier_expand_fused
        self.recording = False
        self.dispatches = 0
        self.rows = 0
        self.prefix_bytes = 0
        self.members = 0
        # data_ptr of begin -> (begin, end, [(lasts, column)])
        self.by_member: Dict[int, Tuple[torch.Tensor, torch.Tensor,
                                        List[Tuple[np.ndarray, int]]]] = {}
        orig = self.orig

        def wrapped(paths, rank, tvec, depthv, begins, ends, dsts, wantc, *,
                    max_deg, member_table=None):
            if not self.recording:
                return orig(paths, rank, tvec, depthv, begins, ends, dsts,
                            wantc, max_deg=max_deg, member_table=member_table)
            self._record(paths, rank, depthv, begins, ends)
            start = time.time_ns()
            try:
                with torch.profiler.record_function("kernels.k5_dispatch"):
                    return orig(paths, rank, tvec, depthv, begins, ends,
                                dsts, wantc, max_deg=max_deg,
                                member_table=member_table)
            finally:
                intervals.append((start, time.time_ns(),
                                  "kernels.k5_dispatch"))
        ops.frontier_expand_fused = wrapped

    def _record(self, paths, rank, depthv, begins, ends) -> None:
        paths = np.asarray(paths)
        rank = np.asarray(rank)
        depth = np.asarray(depthv)[rank].astype(np.int64)
        last = paths[np.arange(paths.shape[0]), depth].astype(np.int64)
        self.dispatches += 1
        self.rows += paths.shape[0]
        self.members += len(begins)
        self.prefix_bytes += int(((depth + 1) * 4).sum())
        for j, (b, e) in enumerate(zip(begins, ends)):
            sel = last[rank == j]
            if sel.size == 0:
                continue
            k1 = e.shape[1]
            col = min(max(k1 - 2 - int(depthv[j]), 0), k1 - 1)
            entry = self.by_member.setdefault(b.data_ptr(), (b, e, []))
            entry[2].append((sel, col))

    def remove(self) -> None:
        """Put the fused entry back."""
        self.ops.frontier_expand_fused = self.orig

    def needed_bytes(self) -> Optional[int]:
        """Bytes the recorded dispatches' inputs need, counted once each:
        every row's prefix up to its depth (int32) and its ``begin`` and
        ``end`` entries (int32 each), one ``dst`` read (int32) and one
        int32 output per candidate edge, and per member of a dispatch
        its target, depth and four counters (int32 each).  None when no
        dispatch was recorded."""
        if self.dispatches == 0:
            return None
        edges = 0
        for begin, end, parts in self.by_member.values():
            for col in {c for _, c in parts}:
                lasts = np.concatenate([x for x, c in parts if c == col])
                v = torch.from_numpy(lasts).to(begin.device)
                edges += int((end[v, col].long() - begin[v].long()).sum())
        return (self.prefix_bytes + 8 * self.rows + 8 * edges
                + 24 * self.members)


def _ns(ev, what: str) -> int:
    get = getattr(ev, f"{what}_ns", None)
    if get is not None:
        return int(get())
    return int(getattr(ev, f"{what}_us")() * 1000)


def _innermost(spans: List[Tuple[int, int, str]], points: List[int]
               ) -> List[str]:
    """For each point (ascending), the name of the latest-starting span
    that contains it, or a fixed label when none does."""
    spans = sorted(spans)
    heap: List[Tuple[int, int, str]] = []
    out, i = [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            heapq.heappush(heap, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while heap and heap[0][1] < p:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else "host outside the spans")
    return out


def read_trace(prof, spans: List[Tuple[int, int, str]], top: int = 10
               ) -> dict:
    """The traced window's numbers: ``window_s`` (the ``bench.window``
    span), ``busy_s`` (union of device-operation intervals inside it),
    ``device_ops`` (seconds by operation name, largest first),
    ``kernel_s`` (seconds by name, all of them) and ``idle_gaps``
    (idle seconds summed by the innermost of ``spans``, host intervals
    on the trace's clock, that the host was in)."""
    win = None
    device = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
        if name in SPAN_NAMES or name == WINDOW_SPAN:
            # a record_function range has a device-side twin in the
            # trace; only the host side is a span
            if not on_device and name == WINDOW_SPAN:
                start = _ns(ev, "start")
                win = (start, start + _ns(ev, "duration"))
            continue
        if on_device:
            start = _ns(ev, "start")
            device.append((start, start + _ns(ev, "duration"), name))
    if win is None:
        raise RuntimeError("the trace holds no window span")
    lo, hi = win
    ops: Dict[str, float] = collections.defaultdict(float)
    ivs = []
    for a, b, name in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            ivs.append((a, b))
            ops[name] += (b - a) / 1e9
    ivs.sort()
    busy = 0
    gaps = []
    cur = lo
    for a, b in ivs:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))
    idle: Dict[str, float] = collections.defaultdict(float)
    labels = _innermost(spans, [(a + b) // 2 for a, b in gaps])
    for (a, b), label in zip(gaps, labels):
        idle[label] += (b - a) / 1e9
    ranked = sorted(ops.items(), key=lambda kv: -kv[1])
    return {"window_s": (hi - lo) / 1e9, "busy_s": busy / 1e9,
            "kernel_s": dict(ops),
            "device_ops": [[n, s] for n, s in ranked[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}
