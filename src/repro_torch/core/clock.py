"""The single monotonic deadline clock (the port of ``repro.core.clock``).

Deadlines cross layers: a caller mints an absolute deadline and the
enumeration drivers compare against it between chunks (DESIGN.md §7).
Both sides must read the same clock, so every deadline is minted by
:func:`deadline_in` / :func:`now` and every check goes through
:func:`expired`, all reading one patchable ``_source``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

# The one time source.  Monotonic by contract; tests monkeypatch this to
# skew or freeze the clock for producers and consumers at once.
_source: Callable[[], float] = time.perf_counter


def now() -> float:
    """Current time on the deadline clock (absolute, monotonic)."""
    return _source()


def deadline_in(budget_seconds: Optional[float]) -> Optional[float]:
    """Absolute deadline ``budget_seconds`` from now (None = no deadline)."""
    if budget_seconds is None:
        return None
    return _source() + budget_seconds


def expired(deadline: Optional[float]) -> bool:
    """Has ``deadline`` (absolute, from this clock) passed?  None never
    expires."""
    return deadline is not None and _source() >= deadline
