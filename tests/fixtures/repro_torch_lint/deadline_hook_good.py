"""Known-good driver shapes for the deadline-hook rule."""
import time


def drive_host(work, stats, deadline=None):
    out = []
    while work:
        if deadline is not None and time.monotonic() >= deadline:
            break
        chunk = work.pop()
        stats.chunks += 1
        for row in chunk:  # the inner loop rides the outer check
            stats.results += 1
            out.append(row)
    return out


def drive_rounds(rounds, stats, deadline=None):
    def _expired():
        return deadline is not None and time.monotonic() >= deadline

    for r in rounds:
        if _expired():
            break
        stats.pairs += r
    return stats


def no_deadline(work, stats):
    for chunk in work:  # no deadline parameter: out of scope
        stats.chunks += 1
    return stats
