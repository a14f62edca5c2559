"""Quickstart: the paper's pipeline end to end on a small graph.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from ..core import PathEnum, layered_dag, oracle
from . import device_from


def main(argv: list[str] | None = None) -> dict:
    """Run the example; returns the values it printed, times left out."""
    dev = device_from(argv, __doc__)

    # 1. build a workload graph and a query q(s, t, k)
    g = layered_dag(layers=4, width=8, fanout=3.0, seed=7)
    s, t, k = g.n - 2, g.n - 1, 5

    # 2. run PathEnum (index -> optimize -> enumerate)
    engine = PathEnum(tau=100, device=dev)   # low tau: the full optimizer
    out = engine.query(g, s, t, k)
    index_bytes = out.index.memory_bytes()

    print(f"query q(s={s}, t={t}, k={k}) on |V|={g.n} |E|={g.m}")
    print(f"  plan: {out.plan.method} (cut={out.plan.cut}, "
          f"T_dfs={out.plan.t_dfs}, T_join={out.plan.t_join})")
    print(f"  results: {out.result.count} paths")
    print(f"  index: {out.index.num_index_edges} edges "
          f"({index_bytes/1024:.1f} KiB), "
          f"built in {out.timing.index_seconds*1e3:.2f} ms")
    print(f"  enumerate: {out.timing.enumerate_seconds*1e3:.2f} ms")

    # 3. cross-check against the reference oracle
    want = oracle.enumerate_paths(g, s, t, k)
    got = sorted(out.result.as_tuples())
    assert got == want, "engine must match the oracle exactly"
    print(f"  oracle check: OK ({len(want)} paths)")

    # 4. first-n response-time mode (the paper's response metric)
    resp = engine.query(g, s, t, k, mode="dfs", first_n=10)
    print(f"  first-10 response: {resp.timing.enumerate_seconds*1e3:.2f} ms "
          f"(exhausted={resp.result.exhausted})")
    return {"query": (s, t, k), "n": g.n, "m": g.m,
            "plan": (out.plan.method, out.plan.cut, out.plan.t_dfs,
                     out.plan.t_join),
            "results": out.result.count,
            "index_edges": out.index.num_index_edges,
            "index_bytes": index_bytes, "oracle_paths": len(want),
            "first_n": (resp.result.count, resp.result.exhausted)}


if __name__ == "__main__":
    main()
