"""Plain PyTorch reference for hop-constrained s-t path queries.

Independent of the program under test: it imports nothing of it and
reads only the edge list that the benchmark made.  A query q(s, t, k)
asks for the simple paths from s to t with at most k edges (no vertex
twice; t only at the end).

* ``bounded_dist`` — hop distances from a root, capped at k + 1, where
  one excluded vertex may be reached but relays nothing: the distances
  ``S(s, v | G - {t})`` and ``S(v, t | G - {s})`` that a query's index
  rests on.
* ``count_paths`` — the number of such paths, by a chunked walk over
  partial paths: a partial path ending at v with d edges grows along
  v's out-edges to w when d + 1 + dist(w, t) <= k, w is not on it yet
  and w != s.  Reaching t ends a path.  Memory stays bounded by
  ``budget`` candidate edges a step.
* ``path_faults`` — how many returned rows are not such paths, or
  repeat an earlier row.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

PAD = -1


def bounded_dist(n: int, src: torch.Tensor, dst: torch.Tensor, root: int,
                 excluded: int, k: int) -> torch.Tensor:
    """(n,) int32 hop distance from ``root`` along ``src -> dst``, values
    past ``k`` as ``k + 1``; ``excluded`` relays nothing."""
    dist = torch.full((n,), k + 1, dtype=torch.int32, device=src.device)
    dist[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=src.device)
    frontier[root] = True
    for d in range(1, k + 1):
        frontier[excluded] = False
        reached = torch.zeros_like(frontier)
        reached[dst[frontier.index_select(0, src)]] = True
        frontier = reached & (dist > k)
        if not bool(frontier.any()):
            break
        dist[frontier] = d
    return dist


def query_dists(n: int, src: torch.Tensor, dst: torch.Tensor, s: int,
                t: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dist_s, dist_t)``: from s in G - {t}, to t in G - {s}."""
    return (bounded_dist(n, src, dst, s, t, k),
            bounded_dist(n, dst, src, t, s, k))


def _csr(n: int, src: torch.Tensor, dst: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    order = torch.argsort(src * n + dst)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=src.device)
    indptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return indptr, dst.index_select(0, order)


def _row_splits(deg: torch.Tensor, budget: int) -> List[Tuple[int, int]]:
    """Row ranges whose summed degree passes ``budget`` by at most one
    row's degree."""
    cum = torch.cumsum(deg, 0)
    total = int(cum[-1]) if cum.numel() else 0
    if total <= budget:
        return [(0, deg.shape[0])]
    marks = torch.arange(budget, total, budget, device=deg.device)
    cuts = torch.searchsorted(cum, marks, right=True).tolist()
    bounds = sorted({0, deg.shape[0], *cuts})
    return list(zip(bounds[:-1], bounds[1:]))


def count_paths(n: int, src: torch.Tensor, dst: torch.Tensor, s: int,
                t: int, k: int, limit: Optional[int] = None,
                budget: int = 1 << 24,
                dists: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                rows_out: Optional[List[torch.Tensor]] = None) -> int:
    """The number of s-t paths with at most ``k`` edges; stops early once
    ``limit`` are counted and returns at least ``limit`` then.
    ``rows_out`` receives the counted rows, PAD after t, as (r, k+1)
    blocks."""
    dist_s, dist_t = dists if dists is not None else \
        query_dists(n, src, dst, s, t, k)
    # edges on some s-t walk of at most k edges; none into s, none out of t
    keep = ((dist_s.index_select(0, src) + 1
             + dist_t.index_select(0, dst) <= k) & (dst != s) & (src != t))
    indptr, adj = _csr(n, src[keep], dst[keep])
    dev = src.device
    count = 0
    stack = [torch.tensor([[s]], dtype=torch.int64, device=dev)]
    while stack:
        rows = stack.pop()
        depth = rows.shape[1] - 1
        last = rows[:, -1]
        lo = indptr.index_select(0, last)
        deg = indptr.index_select(0, last + 1) - lo
        for a, b in _row_splits(deg, budget):
            part_deg = deg[a:b]
            total = int(part_deg.sum())
            if total == 0:
                continue
            row = torch.repeat_interleave(
                torch.arange(a, b, device=dev), part_deg)
            start = torch.cumsum(part_deg, 0) - part_deg
            off = (torch.arange(total, device=dev)
                   - torch.repeat_interleave(start, part_deg))
            w = adj.index_select(0, lo.index_select(0, row) + off)
            ok = depth + 1 + dist_t.index_select(0, w).long() <= k
            ok &= ~(rows.index_select(0, row) == w[:, None]).any(1)
            hit = ok & (w == t)
            count += int(hit.sum())
            if rows_out is not None and bool(hit.any()):
                done = torch.cat([rows.index_select(0, row[hit]),
                                  w[hit, None]], 1)
                rows_out.append(torch.nn.functional.pad(
                    done, (0, k - depth - 1), value=PAD))
            if limit is not None and count >= limit:
                return count
            if depth + 1 < k:
                cont = ok & (w != t)
                if bool(cont.any()):
                    stack.append(torch.cat(
                        [rows.index_select(0, row[cont]), w[cont, None]],
                        1))
    return count


def edge_keys(n: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Sorted ``src * n + dst`` keys, for ``path_faults``."""
    return torch.sort(src * n + dst).values


def path_faults(n: int, keys: torch.Tensor, paths: torch.Tensor,
                s: torch.Tensor, t: torch.Tensor, group: torch.Tensor,
                k: int) -> Tuple[int, int]:
    """``(invalid, repeated)`` rows of ``paths`` ((r, k+1), PAD after
    the last vertex), row i asked of ``s[i]`` and ``t[i]``: a row is
    invalid unless it starts at s, ends at t after 1 to k edges, has no
    PAD inside, takes only edges of the graph (``keys``) and repeats no
    vertex; a valid row is repeated if an earlier row of the same
    ``group`` (one answer) is the same."""
    if paths.shape[0] == 0:
        return 0, 0
    p = paths.long()
    real = p != PAD
    length = real.sum(1)
    cols = torch.arange(k + 1, device=p.device)[None, :]
    ok = (length >= 2) & (p[:, 0] == s)
    # PAD only as a tail: the real entries are exactly the first `length`
    ok &= (real == (cols < length[:, None])).all(1)
    end = p.gather(1, (length - 1).clamp(min=0)[:, None]).view(-1)
    ok &= end == t
    key = p[:, :-1].clamp(min=0) * n + p[:, 1:].clamp(min=0)
    pos = torch.searchsorted(keys, key).clamp(max=keys.shape[0] - 1)
    ok &= (~real[:, 1:] | (keys[pos] == key)).all(1)
    srt = torch.sort(torch.where(real, p, n + cols), 1).values
    ok &= (srt[:, 1:] != srt[:, :-1]).all(1)
    invalid = int((~ok).sum())
    valid = torch.cat([group[ok, None], p[ok]], 1)
    repeated = valid.shape[0] - torch.unique(valid, dim=0).shape[0]
    return invalid, int(repeated)
