#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of PathEnum (``src/repro_torch``) on one
NVIDIA GPU and hold every kernel of its main path against its plain
PyTorch version.

Run from the root of a checkout:  ``python3 chip_smoke.py``
(``--seed`` picks the queries, ``--n`` the vertex count of the large
graph; the defaults are what the numbers in PERF.md come from).

Phases, one JSON line each (``{"phase": ...}``):

1. ``env``     — torch/CUDA versions and the seconds the kernel build took
   (every ``csrc/*.cu`` compiled by nvcc, all at once).
2. ``kernel``  — each kernel against its plain version on the card at the
   main path's shapes: exact equality (all values are integers or
   float32 integers), median time from CUDA events, the plain version's
   time, a one-call PyTorch yardstick where one exists, and the least
   time the card could take (``bound_ms``: bytes over 3.35 TB/s or
   operations over 67 TFLOP/s float32, whichever is larger).
3. ``large``   — the main path at scale: ``erdos_renyi(n, 16.0)`` held on
   the card, queries at k = 8 through
   ``PathEnum(backend="device", use_device_index=True).query``: device
   index build, planner, IDX-DFS on the frontier kernel (K1) inside the
   resident work deque (K2).
4. ``small``   — the device walk-count DP (K3, K4), which runs only on
   graphs of at most 2048 vertices: ``power_law(2000, 6.0, seed=3)`` with
   ``mode="join"`` and with ``mode="auto"`` at a τ low enough that the
   full estimator runs.
5. ``check``   — the main path's results against the port's host backend
   run on the same indexes (counts, paths, Fig.-6 stats, plans, DP
   tables), and the small graph's paths against the recursive oracle.

The launch counts are set to 0 just before phase 3 and read just after
phase 4.  Then the script prints the ``kernels`` line, the card's name
and power limit as nvidia-smi gives them, and, last, the ``ok`` line.
Any failed check exits non-zero before those lines.  Without a CUDA
device, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM data sheet, float32 outside MMA

K_LARGE = 8
TAU = 1e5
CHUNK = 16384
PICK_SECONDS = 150.0             # probe budget for the large queries


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 2, batches: int = 3
            ) -> float:
    """Milliseconds per call of ``fn``: CUDA events around ``reps``
    back-to-back calls, divided by ``reps``; the median of ``batches``
    such runs, after ``warmup`` calls.  The host's launch cost is
    included where it exceeds the device's time, as a caller sees it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want) -> float:
    """Largest |got - want| over paired tensors (0 when equal)."""
    err = 0.0
    for a, b in zip(got, want):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"shape/dtype {tuple(a.shape)} {a.dtype} vs "
              f"{tuple(b.shape)} {b.dtype}")
        if a.numel():
            d = (a.double() - b.double()).abs().max().item()
            err = max(err, d)
    return err


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def host_level_chunk(np, en, idx, rows_max):
    """The widest host frontier level of the index's walk (depth <= k-2),
    cut to ``rows_max`` rows: the rows a deque pop hands to K1."""
    k = idx.k
    paths = np.full((1, k + 1), -1, np.int32)
    paths[0, 0] = idx.s
    best = (paths, 0)
    for d in range(k - 1):
        if paths.shape[0] >= best[0].shape[0]:
            best = (paths[:rows_max], d)
        exp = en._expand_chunk(idx, paths, d, en.EnumStats())
        if exp is None:
            break
        parent, _pos, vnew, _emit, cont = exp
        sel = np.nonzero(cont)[0]
        if sel.size == 0:
            break
        paths = paths[parent[sel]].copy()
        paths[:, d + 1] = vnew[sel]
    return best


def round_work(np, en, idx, chunk_size, pops):
    """Rows read, candidate edges and rows written by the first ``pops``
    chunks of the host walk (the same chunks a deque round pops)."""
    k = idx.k
    root = np.full((1, k + 1), -1, np.int32)
    root[0, 0] = idx.s
    work = [(root, 0)]
    rows_in = edges = rows_out = done = 0
    while work and done < pops:
        paths, depth = work.pop()
        done += 1
        st = en.EnumStats()
        exp = en._expand_chunk(idx, paths, depth, st)
        rows_in += paths.shape[0]
        edges += st.edges_accessed
        if exp is None:
            continue
        parent, _pos, vnew, emit_m, cont = exp
        rows_out += int(emit_m.sum())
        if depth + 1 < k and cont.any():
            sel = np.nonzero(cont)[0]
            rows = paths[parent[sel]].copy()
            rows[:, depth + 1] = vnew[sel]
            rows_out += rows.shape[0]
            for st0 in reversed(range(0, rows.shape[0], chunk_size)):
                work.append((rows[st0:st0 + chunk_size], depth + 1))
    return rows_in, edges, rows_out


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def pick_large_queries(np, tc, ops, en, est, g, count, seed, dev):
    """Up to ``count`` (s, t) pairs drawn from ``seed`` whose k=8 index
    has at least DEVICE_AUTO_MIN_EDGES edges, is planned as IDX-DFS
    (Eq. 5 below τ) and fits the resident deque's slot budget; probing
    stops after PICK_SECONDS."""
    rng = np.random.default_rng(seed)
    picked, probes = [], 0
    t_end = time.perf_counter() + PICK_SECONDS
    while len(picked) < count and time.perf_counter() < t_end:
        s, t = (int(x) for x in rng.choice(g.n, 2, replace=False))
        probes += 1
        idx = tc.build_index_device(g, s, t, K_LARGE, device=dev)
        if idx.num_index_edges < en.DEVICE_AUTO_MIN_EDGES:
            continue
        if est.preliminary_estimate(idx) > TAU:
            continue
        max_deg = int((idx.fwd_end[:, K_LARGE] - idx.fwd_begin).max())
        if ops.deque_config(K_LARGE + 1, CHUNK, max_deg).cap \
                > en.DEVICE_SLOT_BUDGET:
            continue
        picked.append((s, t, idx))
    check(len(picked) > 0, f"no query qualified in {probes} probes")
    return picked, probes


def kernel_phase(torch, np, en, ops, fe, sr, idx, dev):
    """Each kernel against its plain version, timed, at the path's shapes."""
    rows = {}
    k1 = idx.k + 1
    max_deg = int((idx.fwd_end[:, idx.k] - idx.fwd_begin).max())
    cfg = ops.deque_config(k1, CHUNK, max_deg)
    da = idx.device_arrays()

    # K1 at a deque pop's shape: block_rows rows, the index's pow2 fan-out
    real, depth = host_level_chunk(np, en, idx, cfg.block_rows)
    C = cfg.block_rows
    padded = np.full((C, k1), -1, np.int32)
    padded[:real.shape[0]] = real
    p = torch.from_numpy(padded).to(dev)
    meta = torch.tensor([depth, idx.t], dtype=torch.int32).to(dev)
    args = (p, da.begin, da.end, da.dst, meta)
    got = fe.frontier_masks(*args, max_deg=cfg.max_deg)
    want = fe.frontier_masks_plain(*args, max_deg=cfg.max_deg)
    err = max_abs_err(torch, got, want)
    check(err == 0, f"frontier_masks differs from its plain version: {err}")
    last = real[:, depth].astype(np.int64)
    edges = int((idx.fwd_end[last, idx.k - depth - 1]
                 - idx.fwd_begin[last]).sum())
    nbytes = (real.shape[0] * ((depth + 1) * 4 + 8) + (C - real.shape[0]) * 4
              + edges * 4 + 3 * C * cfg.max_deg * 4 + 16)
    b_ms, b_by = bound(nbytes, edges * (depth + 4))
    rows["frontier_masks"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: fe.frontier_masks(*args,
                                                    max_deg=cfg.max_deg), 50),
        plain_ms=time_ms(torch, lambda: fe.frontier_masks_plain(
            *args, max_deg=cfg.max_deg), 10),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(rows=C, real_rows=int(real.shape[0]), k1=k1, depth=depth,
                   max_deg=cfg.max_deg, edges=edges))

    # K2: one round from a fresh deque on the same index
    root = np.full(k1, -1, np.int32)
    root[0] = idx.s
    state = ops.frontier_deque_init(root, cfg=cfg, device=dev)

    def fresh():
        return [x.clone() for x in state]

    rargs = (da.begin, da.end, da.dst, idx.t)
    got = ops.frontier_deque_round(*fresh(), *rargs, cfg=cfg)
    want = ops.frontier_deque_round_plain(*fresh(), *rargs, cfg=cfg)
    err = max_abs_err(torch, got, want)
    check(err == 0, f"frontier_deque_round differs from its plain version: "
                    f"{err}")
    pops = int(got[9])
    r_in, r_edges, r_out = round_work(np, en, idx, CHUNK, pops)
    nbytes = r_in * (k1 * 4 + 8) + r_edges * 4 + r_out * (k1 * 4 + 4)
    b_ms, b_by = bound(nbytes, r_edges * (k1 + 4))
    rows["frontier_deque_round"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.frontier_deque_round(
            *fresh(), *rargs, cfg=cfg), 5, warmup=1),
        plain_ms=time_ms(torch, lambda: ops.frontier_deque_round_plain(
            *fresh(), *rargs, cfg=cfg), 3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=dict(block_rows=cfg.block_rows, max_deg=cfg.max_deg,
                   round_pops=cfg.round_pops, pops=pops, rows_in=r_in,
                   edges=r_edges, rows_out=r_out))

    # K3 at n = 2048, q = 1 (the DP's shape) and q = 128
    rng = np.random.default_rng(5)
    n = 2048
    a = torch.from_numpy((rng.random((n, n)) < 0.01).astype(np.float32))
    a = a.to(dev)
    k3 = {}
    for q in (1, 128):
        x = torch.from_numpy(rng.integers(0, 16, (n, q)).astype(np.float32))
        x = x.to(dev)
        got = sr.counting_spmm(a, x)
        want = sr.counting_spmm_plain(a, x)
        err = max_abs_err(torch, [got], [want])
        check(err == 0, f"counting_spmm q={q} differs: {err}")
        b_ms, b_by = bound(n * n * 4 + 2 * n * q * 4, 2 * n * n * q)
        k3[q] = dict(
            max_abs_err=err,
            ms=time_ms(torch, lambda: sr.counting_spmm(a, x), 50),
            plain_ms=time_ms(torch, lambda: sr.counting_spmm_plain(a, x), 50),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(torch, lambda: torch.matmul(a, x), 50),
            shape=dict(n=n, q=q))
    rows["counting_spmm"] = k3[1]
    emit({"phase": "kernel", "name": "counting_spmm", "q": 128, **k3[128]})

    # K4 at n = 2048
    inf = 1e9
    adj = torch.from_numpy(np.where(rng.random((n, n)) < 0.003, 1.0, inf)
                           .astype(np.float32)).to(dev)
    dist = np.full(n, inf, np.float32)
    dist[rng.choice(n, 16, replace=False)] = rng.integers(0, 4, 16)
    d = torch.from_numpy(dist).to(dev)
    got = sr.minplus_spmv(adj, d, inf=inf)
    want = sr.minplus_spmv_plain(adj, d, inf=inf)
    err = max_abs_err(torch, [got], [want])
    check(err == 0, f"minplus_spmv differs from its plain version: {err}")
    b_ms, b_by = bound(n * n * 4 + 2 * n * 4, 2 * n * n)
    rows["minplus_spmv"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: sr.minplus_spmv(adj, d, inf=inf), 50),
        plain_ms=time_ms(torch, lambda: sr.minplus_spmv_plain(adj, d,
                                                              inf=inf), 50),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(torch, lambda: (adj + d[:, None]).amin(0), 50),
        shape=dict(n=n))
    for name, row in rows.items():
        emit({"phase": "kernel", "name": name, **row})
    return rows


def large_phase(torch, tc, kernels, g, queries, dev):
    """The main path at scale; returns the outputs to check later."""
    pe = tc.PathEnum(tau=TAU, chunk_size=CHUNK, backend="device",
                     use_device_index=True, device=dev)
    runs = []
    for i, (s, t, _idx) in enumerate(queries):
        legs = [("count_only", dict(count_only=True))]
        if i == 0:
            legs += [("paths", dict(count_only=False)),
                     ("first_n", dict(first_n=1000))]
        for leg, kw in legs:
            rounds0 = kernels.ops.deque_rounds
            torch.cuda.synchronize()
            out = pe.query(g, s, t, K_LARGE, **kw)
            r = out.result
            rounds = kernels.ops.deque_rounds - rounds0
            runs.append((s, t, leg, kw, out, rounds))
            emit({"phase": "large", "s": s, "t": t, "k": K_LARGE, "leg": leg,
                  "index_edges": out.index.num_index_edges,
                  "index_device_bytes":
                      out.index.device_arrays().memory_bytes(),
                  "plan": out.plan.method,
                  "preliminary": out.plan.preliminary,
                  "count": r.count, "stats": vars(r.stats),
                  "exhausted": r.exhausted, "deque_rounds": rounds,
                  "index_s": out.timing.index_seconds,
                  "plan_s": out.timing.optimize_seconds,
                  "enum_s": out.timing.enumerate_seconds})
    return runs


def small_phase(np, tc, g, dev):
    """The device DP on a graph small enough for it (n <= 2048)."""
    runs = []
    rng = np.random.default_rng(3)
    queries = [(1104, 997, 4)]
    while len(queries) < 3:
        s, t = (int(x) for x in rng.choice(g.n, 2, replace=False))
        if tc.build_index(g, s, t, 5, device=dev).num_index_edges >= 64:
            queries.append((s, t, 5))
    for s, t, k in queries:
        for mode, tau in (("join", TAU), ("auto", 1.0)):
            pe = tc.PathEnum(tau=tau, backend="device", device=dev)
            out = pe.query(g, s, t, k, mode=mode)
            runs.append((s, t, k, mode, tau, out))
            dp = out.plan.dp
            emit({"phase": "small", "s": s, "t": t, "k": k, "mode": mode,
                  "tau": tau, "plan": out.plan.method, "cut": out.plan.cut,
                  "dp_backend": dp.backend_used if dp else None,
                  "count": out.result.count,
                  "plan_s": out.timing.optimize_seconds,
                  "enum_s": out.timing.enumerate_seconds})
    return runs


def check_phase(np, tc, large_runs, small_runs, g_small, dev):
    """Main-path results against the host backend and the oracle."""
    for s, t, leg, kw, out, rounds in large_runs:
        idx = out.index
        host = tc.enumerate_paths_idx(idx, chunk_size=CHUNK, backend="host",
                                      device=dev, **kw)
        r = out.result
        tag = f"large {s}->{t} {leg}"
        check(r.count == host.count, f"{tag}: count {r.count} vs "
                                     f"{host.count}")
        check(r.stats == host.stats, f"{tag}: stats {r.stats} vs "
                                     f"{host.stats}")
        check(r.as_tuples() == host.as_tuples(), f"{tag}: paths differ")
        check(r.exhausted == host.exhausted, f"{tag}: exhausted differs")
        plan = tc.plan_query(idx, tau=TAU, backend="host")
        check((out.plan.method, out.plan.cut, out.plan.preliminary)
              == (plan.method, plan.cut, plan.preliminary),
              f"{tag}: plan differs")
        if "first_n" not in kw:
            check(rounds > 0, f"{tag}: the resident deque never ran")
        if r.paths.shape[0]:
            check(bool((r.paths[:, 0] == s).all()
                       and (r.paths[np.arange(r.paths.shape[0]),
                                    r.lengths] == t).all()),
                  f"{tag}: a path does not run from s to t")
    for s, t, k, mode, tau, out in small_runs:
        tag = f"small {s}->{t} k={k} {mode}"
        host = tc.PathEnum(tau=tau, backend="host", device=dev).query(
            g_small, s, t, k, mode=mode)
        a, b = out.result, host.result
        check(a.count == b.count and a.stats == b.stats
              and a.as_tuples() == b.as_tuples(), f"{tag}: results differ")
        pa, pb = out.plan, host.plan
        check((pa.method, pa.cut, pa.t_dfs, pa.t_join)
              == (pb.method, pb.cut, pb.t_dfs, pb.t_join),
              f"{tag}: plans differ")
        if mode == "auto":
            check(pa.dp is not None and pa.dp.backend_used == "device",
                  f"{tag}: the device DP did not produce the plan")
            for f in ("c_to", "c_from", "q_prefix", "q_suffix"):
                check(np.array_equal(getattr(pa.dp, f), getattr(pb.dp, f)),
                      f"{tag}: DP table {f} differs from the host DP")
            check(bool(np.isfinite(pa.dp.c_to).all()),
                  f"{tag}: non-finite DP values")
        if k == 4:
            want = tc.oracle.enumerate_paths(g_small, s, t, k)
            check(sorted(a.as_tuples()) == want,
                  f"{tag}: paths differ from the oracle")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=1_000_000,
                    help="vertices of the large graph (average degree 16)")
    ap.add_argument("--queries", type=int, default=3)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device; this script runs the port on the "
             "card and has nothing to run without one")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the repo")
    for var in ("REPRO_DEVICE_ENUM", "REPRO_DEVICE_DEQUE"):
        if var in os.environ:
            fail(f"{var} is set; it would move work off the path measured "
                 f"here")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    import repro_torch.core as tc
    from repro_torch import kernels
    from repro_torch.core import enumerate as en
    from repro_torch.core import estimator as est
    from repro_torch.kernels import _build
    from repro_torch.kernels import frontier_expand as fe
    from repro_torch.kernels import ops
    from repro_torch.kernels import semiring_spmm as sr

    # yardsticks and the plain versions run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    built = _build.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(), "nvidia_smi": smi,
          "build_s": build_s,
          "built": {k: v[0] for k, v in built.items()}})

    t0 = time.perf_counter()
    g = tc.erdos_renyi(args.n, 16.0, seed=args.seed)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dg = g.to(dev)
    torch.cuda.synchronize()
    emit({"phase": "setup", "n": g.n, "m": g.m, "avg_degree": g.m / g.n,
          "generate_s": gen_s, "to_device_s": time.perf_counter() - t0,
          "graph_device_bytes": dg.memory_bytes()})
    t0 = time.perf_counter()
    queries, probes = pick_large_queries(np, tc, ops, en, est, g,
                                         args.queries, args.seed, dev)
    emit({"phase": "setup", "queries": [(s, t) for s, t, _ in queries],
          "probes": probes, "pick_s": time.perf_counter() - t0})
    g_small = tc.power_law(2000, 6.0, seed=3)

    rows = kernel_phase(torch, np, en, ops, fe, sr, queries[0][2], dev)

    # the main path: counts from 0, read right after
    kernels.reset_launch_counts()
    large_runs = large_phase(torch, tc, kernels, g, queries, dev)
    small_runs = small_phase(np, tc, g_small, dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()

    check_phase(np, tc, large_runs, small_runs, g_small, dev)
    for name, n_launch in launches.items():
        check(n_launch > 0, f"{name} never launched on the main path")
    emit({"phase": "check", "ok": True,
          "seconds": time.perf_counter() - t_start})

    where = {
        "frontier_masks": ("src/repro_torch/kernels/csrc/frontier.cu",
                           "src/repro/kernels/frontier_expand.py:47"),
        "frontier_deque_round": ("src/repro_torch/kernels/ops.py",
                                 "src/repro/kernels/ops.py:382"),
        "counting_spmm": ("src/repro_torch/kernels/csrc/semiring.cu",
                          "src/repro/kernels/semiring_spmm.py:78"),
        "minplus_spmv": ("src/repro_torch/kernels/csrc/semiring.cu",
                         "src/repro/kernels/semiring_spmm.py:36"),
    }
    line = []
    for name, (source, replaces) in where.items():
        row = rows[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    emit({"kernels": line})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
