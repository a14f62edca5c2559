"""The comparison that decides ``correct``.

After the window has closed, the plain reference (``reference/``)
works out again, from the edge list the benchmark made, each pool
pair's distances and its count of paths (at most ``first_n`` of them
where the traffic asks for a prefix).  Then every request of the window
is judged by what its answer says:

* ``missing`` — requests that got no answer at all (an engine error
  included) and, in a closed loop, answers that are not ``ok``: the
  synchronous server admits every request, so a rejection there is an
  answer left out;
* ``count_mismatch`` — ok answers whose count differs from the
  reference's (the count, or ``min(first_n, count)``), or whose rows
  differ in number from their count;
* ``bad_paths`` — returned rows that are not s-t paths of at most k
  edges in the graph, or repeat a row of the same answer;
* ``dist_mismatch`` — pool pairs whose index, as the engine holds it
  after the window, has other distances than the reference's.

Every limit is 0: the answers are exact.  In an open loop a rejected
answer is the admission control's and not wrong: it counts as failed
and as missing its latency.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .reference import paths as ref

LIMITS = {"missing": 0, "count_mismatch": 0, "bad_paths": 0,
          "dist_mismatch": 0}


def reference_answers(n: int, src: torch.Tensor, dst: torch.Tensor,
                      pool: Sequence[Tuple[int, int]], k: int,
                      first_n: Optional[int]
                      ) -> Tuple[List[int], List[Tuple[np.ndarray,
                                                       np.ndarray]]]:
    """Each pool pair's expected count and its ``(dist_s, dist_t)``."""
    counts, dists = [], []
    for s, t in pool:
        d = ref.query_dists(n, src, dst, s, t, k)
        c = ref.count_paths(n, src, dst, s, t, k, limit=first_n, dists=d)
        counts.append(min(c, first_n) if first_n is not None else c)
        dists.append((d[0].cpu().numpy(), d[1].cpu().numpy()))
    return counts, dists


def compare(records, pool: Sequence[Tuple[int, int]], k: int,
            first_n: Optional[int], expected: Sequence[int],
            ref_dists: Sequence[Tuple[np.ndarray, np.ndarray]],
            engine_dists: Optional[Sequence[Optional[Tuple[np.ndarray,
                                                           np.ndarray]]]],
            keys: Optional[torch.Tensor], n: int,
            admits_all: bool = True) -> Dict[str, int]:
    """The numbers compared, by name (see the module's docstring).
    ``engine_dists`` None skips ``dist_mismatch``; ``keys`` (sorted edge
    keys) None skips ``bad_paths``; ``admits_all`` (a closed loop)
    counts every answer that is not ok as missing."""
    out = {"missing": 0, "count_mismatch": 0}
    rows, row_s, row_t, row_g = [], [], [], []
    for g, rec in enumerate(records):
        resp = rec.response
        if resp is None:
            out["missing"] += 1
            continue
        if resp.status != "ok":
            out["missing"] += int(admits_all)
            continue
        want = expected[rec.pair]
        paths = getattr(resp, "paths", None)
        got_rows = None if paths is None else int(np.shape(paths)[0])
        if int(resp.count) != want or (
                keys is not None and got_rows != int(resp.count)):
            out["count_mismatch"] += 1
        if keys is not None and got_rows:
            s, t = pool[rec.pair]
            rows.append(np.asarray(paths))
            row_s.append(np.full(got_rows, s, np.int64))
            row_t.append(np.full(got_rows, t, np.int64))
            row_g.append(np.full(got_rows, g, np.int64))
    if keys is not None:
        out["bad_paths"] = 0
        if rows:
            dev = keys.device
            widths = {r.shape[1] for r in rows}
            if widths != {k + 1}:
                out["bad_paths"] = sum(r.shape[0] for r in rows)
            else:
                def put(parts):
                    return torch.from_numpy(np.concatenate(parts)).to(dev)
                invalid, repeated = ref.path_faults(
                    n, keys, put(rows), put(row_s), put(row_t), put(row_g),
                    k)
                out["bad_paths"] = invalid + repeated
    if engine_dists is not None:
        out["dist_mismatch"] = sum(
            1 for want, got in zip(ref_dists, engine_dists)
            if got is None or not (np.array_equal(want[0], got[0])
                                   and np.array_equal(want[1], got[1])))
    return out


def verdict(numbers: Dict[str, int]) -> bool:
    """True when every number is within its limit."""
    return all(v <= LIMITS[name] for name, v in numbers.items())
