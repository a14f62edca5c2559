"""Arithmetic over a window's requests: rates and latency percentiles.

Every statistic is taken over all requests of the window and all of its
time.  A request that got no answer, or an answer other than ``ok``,
counts as missing: its latency is ``MISSING_MS``, longer than any run,
so it lands in the tail instead of leaving it.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence

import numpy as np

# the latency a missing answer counts with: 1000 s, past any run's end
MISSING_MS = 1.0e6


@dataclasses.dataclass
class Record:
    """One request of the window, in the benchmark's host clock
    (``time.perf_counter`` seconds)."""
    uid: int
    pair: int                     # index into the query pool
    due: float                    # when it was due to be sent
    sent: float                   # when the generator sent it
    done: Optional[float] = None  # when its answer arrived
    response: object = None       # the program's response, if any

    @property
    def ok(self) -> bool:
        """An answer arrived and says ``ok``."""
        return self.response is not None and \
            getattr(self.response, "status", None) == "ok"

    @property
    def latency_ms(self) -> float:
        """Due-to-answer milliseconds, ``MISSING_MS`` when not ok."""
        if not self.ok or self.done is None:
            return MISSING_MS
        return (self.done - self.due) * 1e3


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (linear interpolation between order
    statistics, numpy's default) of all ``values``; None when empty."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def latency_percentile(records: Iterable[Record], q: float
                       ) -> Optional[float]:
    """The ``q``-th percentile of every request's due-to-answer time,
    missing answers included as ``MISSING_MS``."""
    return percentile([r.latency_ms for r in records], q)


def rate(records: Sequence[Record], window_s: float) -> Optional[float]:
    """Requests answered ok over the window's seconds."""
    if window_s <= 0:
        return None
    return sum(1 for r in records if r.ok) / window_s


def count_failed(records: List[Record]) -> int:
    """Requests of the window that were not answered ok."""
    return sum(1 for r in records if not r.ok)
