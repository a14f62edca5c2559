"""Motivation example 2 of the paper: e-commerce fraud cycles, ranked.

    PYTHONPATH=src python -m repro_torch.examples.fraud_detection [--device cpu]

New edge (v, v') triggers cycle detection = q(v', v, k-1) plus the edge.
Edges carry transaction amounts; an investigator wants the
**highest-value** cycles first, so this example uses ranked enumeration
(``order="weight"``, DESIGN.md §10): ``first_n`` returns exactly the
top n in deterministic best-first order without enumerating the rest.

``order="weight"`` ranks cheapest-first, so to surface the *largest*
cycles it ranks by headroom (max_amount - amount per edge): the paths
whose total headroom is smallest are the ones that moved the most money.
Weight-ranked walks run on the host heap, as in ``repro``: no kernel
launches.
"""
from __future__ import annotations

import numpy as np

from ..core import PathEnum, erdos_renyi
from . import device_from


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns the values it printed."""
    dev = device_from(argv, __doc__)
    rng = np.random.default_rng(3)
    g = erdos_renyi(300, 8.0, seed=3)
    engine = PathEnum(device=dev)

    # transaction amounts as edge weights; rank cycles by total value
    amounts = rng.uniform(10.0, 5000.0, size=g.m)
    headroom = amounts.max() - amounts      # cheapest headroom = most money

    new_edges = []
    for _ in range(200):
        u = int(rng.integers(0, g.n))
        nb = g.neighbors(u)
        if len(nb):
            new_edges.append((u, int(nb[rng.integers(0, len(nb))])))
        if len(new_edges) >= 10:
            break

    k = 5
    amap = {(int(a), int(b)): float(w)
            for a, b, w in zip(g.esrc, g.edst, amounts)}
    flagged = 0
    cycles = []
    for (v, v2) in new_edges:
        # cycles through the new edge = paths v2 -> v of length <= k-1,
        # best (highest-value) three first — no threshold to tune
        try:
            out = engine.query(g, v2, v, k - 1, mode="dfs", order="weight",
                               weights=headroom, first_n=3)
        except ValueError:
            continue  # v2 == v (self-loop edge)
        if out.result.count:
            flagged += 1
            top = out.result.as_tuples()[0]
            value = sum(amap[e] for e in zip(top, top[1:]))
            cycles.append(((v, v2), value, top))
            print(f"edge ({v}->{v2}): top cycle moves {value:,.0f} "
                  f"across {len(top) - 1} hops: {top}")
    print(f"flagged {flagged}/{len(new_edges)} new edges")
    return {"cycles": cycles, "flagged": flagged,
            "new_edges": len(new_edges)}


if __name__ == "__main__":
    main()
