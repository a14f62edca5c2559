"""The port's own spans and counters: one in-process recorder, off by
default.

An operator (or a benchmark) switches it on around a stretch of serving
and drains it afterwards::

    from repro_torch.core import trace
    trace.enable()
    responses, report = server.serve(requests)
    trace.disable()
    got = trace.drain()       # Trace(spans=[Span, ...], counters={...})

Off, ``span`` returns one shared no-op context manager after a single
test of a module-level boolean, and ``count`` returns after the same
test: nothing is allocated and no clock is read.  Call sites whose
attrs or counts cost something to compute test ``enabled()`` first.

On, each span keeps one tuple in memory (nothing is written out while
work runs): its name, its start and end in ns on ``time.time_ns()``, its
own id, its parent's id and the id of the ``serve`` or ``engine.run``
call it belongs to (0 outside any), and its attrs.  ``time.time_ns()``
is the clock that ``torch.profiler``'s events carry, so the spans line
up with a device trace taken beside them.  The parent stack is per
thread, so a server's worker thread nests its own spans.  The spans are
plain host intervals, not ``torch.profiler.record_function`` ranges: a
range has a twin on the device's timeline in a trace, which a reader of
the trace would take for device work.

``drain`` hands over what was kept and starts afresh; call it when no
traced work is in flight.  README.md lists the spans and counters.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

# the spans whose calls give their descendants a ``root``
ROOTS = frozenset({"serve", "engine.run"})

_on = False
_spans: List[tuple] = []
_counters: Dict[str, int] = {}
_counter_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


class Span(NamedTuple):
    """One finished span; ids are positive, 0 means none."""
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    root: int
    attrs: Optional[dict]


class Trace(NamedTuple):
    """What ``drain`` hands over: the finished spans in the order they
    ended, and the counters by name."""
    spans: List[Span]
    counters: Dict[str, int]


class _Off:
    """The shared no-op span of a recorder that is off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


class _Open:
    """A span being recorded."""
    __slots__ = ("name", "attrs", "id", "parent", "root", "start", "stack")

    def __init__(self, name: str, attrs: Optional[dict]) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> None:
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else 0
        if top is not None and top.root:
            self.root = top.root
        else:
            self.root = self.id if self.name in ROOTS else 0
        self.stack = stack
        stack.append(self)
        self.start = time.time_ns()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.stack.pop()
        _spans.append((self.name, self.start, end, self.id, self.parent,
                       self.root, self.attrs))


def span(name: str, attrs: Optional[dict] = None):
    """A context manager that records ``name`` over its body while the
    recorder is on (``attrs`` kept as given; the dict may be filled
    until the span ends), and the shared no-op otherwise."""
    if not _on:
        return OFF
    return _Open(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the recorder is on."""
    if not _on:
        return
    with _counter_lock:
        _counters[name] = _counters.get(name, 0) + n


def enabled() -> bool:
    """Whether the recorder is on."""
    return _on


def enable() -> None:
    """Switch the recorder on (it keeps what it held)."""
    global _on
    _on = True


def disable() -> None:
    """Switch the recorder off (it keeps what it held; spans open now
    still end in it)."""
    global _on
    _on = False


def drain() -> Trace:
    """Hand over the spans and counters kept so far and keep none."""
    global _spans, _counters
    with _counter_lock:
        spans, counters = _spans, _counters
        _spans, _counters = [], {}
    return Trace([Span._make(s) for s in spans], counters)
