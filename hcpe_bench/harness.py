"""One run of one cell: set-up, the measured window, the check, metrics.

The harness is driven by data.  ``BENCHMARK.json`` names each cell's
configuration and traffic mix and the metrics each cell reports; the
harness finds

* the configuration in ``configs/<config>.json`` (graph sizes and
  seeds, the §7.1 query generator, the engine's settings),
* the traffic mix in ``traffic/<traffic>.json``, overlaid by the
  cell's own ``workloads/<cell>.json`` where that holds a ``traffic``
  block (a rate fixed for that cell),
* each metric's reader in ``metrics/<metric>.py``: a ``read(ctx)``
  that returns a number, or None when the run gave it nothing to read.

A ``--trace 1`` run switches the program's own recorder
(``repro_torch.core.trace``) on from its start and puts its set-up's
and its window's spans and counters, and the device trace read against
them, in the context each reader gets (``program_trace``); a
``--trace 0`` run never touches the recorder.

The program under test is the PyTorch port, ``repro_torch``; nothing
here imports ``repro`` or JAX.  ``run_cell`` is the whole run and
returns the result line as a dict; ``run.py`` is its command line,
which also refuses to run without a card.
"""
from __future__ import annotations

import asyncio
import dataclasses
import gc
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import checks, graphgen, loops, program_trace, stats, tracing
from .reference import paths as ref

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the index warm-up's requests stop at their first path
WARM_FIRST_N = 1
# how long the async warm-up burst may take before the run fails
WARM_TIMEOUT_S = 120.0


def load_json(path: Path) -> dict:
    """A JSON file's object."""
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    """The repository's ``BENCHMARK.json``."""
    return load_json(REPO / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    """One cell as the harness runs it."""
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def find_cell(name: str, spec: Optional[dict] = None,
              base: Path = HERE) -> Cell:
    """The cell named ``name`` with its configuration, its traffic
    parameters and the metrics it reports, all found by name (the data
    files under ``base``)."""
    spec = spec if spec is not None else benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise ValueError(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{[w['name'] for w in spec['workloads']]}")
    config = load_json(base / "configs" / f"{entry['config']}.json")
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    own = base / "workloads" / f"{name}.json"
    if own.exists():
        traffic.update(load_json(own).get("traffic", {}))

    def reports(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if reports(m)],
                per_layer=[m for m in spec["per_layer"] if reports(m)])


def metric_reader(name: str, base: Path = HERE
                  ) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` under ``base``."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"hcpe_bench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot),
    compared whole, is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def use_checkout_program() -> None:
    """Put the checkout's ``src`` first on the import path, where the
    program under test lives (the command-line entries call this)."""
    src = str(REPO / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def port_modules() -> Dict[str, object]:
    """The program's modules the harness drives."""
    names = {"batch": "repro_torch.core.batch",
             "graph": "repro_torch.core.graph",
             "build": "repro_torch.kernels._build",
             "serving": "repro_torch.serving"}
    return {key: importlib.import_module(mod) for key, mod in names.items()}


def power_limit_w(dev: torch.device) -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _engine_dists(mods, engine, pool, k):
    """Each pool pair's ``(dist_s, dist_t)`` as the engine's index cache
    holds them, None where it holds no index; reads leave the cache's
    order and counters as they are."""
    batch = mods["batch"]
    out = []
    for s, t in pool:
        idx = engine.cache.peek((batch.DEFAULT_GRAPH_ID, s, t, k,
                                 batch.edge_mask_hash(None), 0))
        out.append(None if idx is None else
                   (np.asarray(idx.dist_s).copy(),
                    np.asarray(idx.dist_t).copy()))
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", started: Optional[float] = None,
             spec: Optional[dict] = None, base: Path = HERE,
             log=None, keep: Optional[dict] = None) -> dict:
    """Run one cell once and return its result line (a dict).

    ``started`` is the process's start on ``time.perf_counter``'s clock
    (the set-up time counts from it); ``spec`` and ``base`` stand in for
    ``BENCHMARK.json`` and this folder's data files (the tests' small
    cells); ``log`` receives progress lines; ``keep``, where given,
    receives the run's context.  With ``trace`` the program's recorder
    is on from here until the window closes, and off again when the run
    ends, also when it raises.
    """
    rec = None
    if trace:
        rec = importlib.import_module("repro_torch.core.trace")
        rec.drain()
        rec.enable()
    try:
        return _run(name, seed, seconds, rec, device, started, spec, base,
                    log, keep)
    finally:
        if rec is not None:
            rec.disable()
            rec.drain()


def _run(name: str, seed: int, seconds: float, rec, device: str,
         started: Optional[float], spec: Optional[dict], base: Path, log,
         keep: Optional[dict]) -> dict:
    """``run_cell``'s body; ``rec`` is the program's recorder, switched
    on, in a traced run, and None otherwise."""
    trace = rec is not None
    started = time.perf_counter() if started is None else started
    log = log or (lambda msg: None)
    cell = find_cell(name, spec, base)
    mods = port_modules()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    # the kernels' nvcc build: only a checkout's first run builds, and
    # its seconds count in set-up, as the build is set-up; the result
    # line also gives them apart as ``compile_s``
    compile_s = 0.0
    if dev.type == "cuda":
        t0 = time.perf_counter()
        built = mods["build"].build_all()
        if built:
            compile_s = time.perf_counter() - t0
            log(f"compile_s {compile_s:.3f} (built {sorted(built)})")
    cfg, params = cell.config, cell.traffic
    k = int(cfg["query"]["k"])
    n = graphgen.vertex_count(cfg["graph"])
    t0 = time.perf_counter()
    arrays, pool = graphgen.build(cfg, seed, dev)
    host = [x.cpu().numpy() for x in (arrays.indptr, arrays.indices,
                                      arrays.rindptr, arrays.rindices,
                                      arrays.esrc, arrays.edst)]
    graph = mods["graph"].Graph.from_numpy(n, *host)
    del host
    log(f"graph_s {time.perf_counter() - t0:.3f} (m {arrays.m})")
    engine = mods["batch"].BatchPathEnum(device=dev, **cfg["engine"])
    serving = mods["serving"]
    count_only = bool(params["count_only"])
    first_n = params.get("first_n")
    queries = [(s, t, k) for s, t in pool]
    # the warm-up first builds every pool index (the host build is the
    # program's set-up cost), stopping each query at its first path;
    # then the server takes one batch of the traffic itself, so the
    # window starts with every buffer and cache at its working size
    t0 = time.perf_counter()
    engine.run(graph, queries, count_only=count_only, first_n=WARM_FIRST_N)
    _sync(dev)
    log(f"warm_pool_s {time.perf_counter() - t0:.3f}")

    counted = prof = None
    if trace:
        counted = tracing.BatchCounters(engine)
    rng = np.random.default_rng([int(seed), 1])
    req_cls = serving.PathQueryRequest
    ctx: dict = {"params": params}

    def start_window() -> None:
        _sync(dev)
        ctx["setup_s"] = time.perf_counter() - started
        nonlocal prof
        if trace:
            ctx["program_setup"] = rec.drain()
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            counted.recording = True

    def close_window() -> None:
        _sync(dev)
        if trace:
            counted.recording = False
            rec.disable()
            ctx["program"] = rec.drain()
            prof.__exit__(None, None, None)

    if params["loop"] == "closed":
        server = serving.HcPEServer(graph, engine=engine)
        loops.closed_loop(server, req_cls, pool, k, params,
                          np.random.default_rng([int(seed), 3]), 0.0)
        start_window()
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            records, w0, w1 = loops.closed_loop(
                server, req_cls, pool, k, params, rng, seconds)
            _sync(dev)
        close_window()
        ctx["window_s"] = w1 - w0
    elif params["loop"] == "open":
        server = serving.AsyncHcPEServer(
            graph, engine=engine,
            batch_window_ms=float(params["batch_window_ms"]))

        async def drive():
            async with server:
                warm = [req_cls(uid=i, s=s, t=t, k=k, count_only=count_only,
                                first_n=first_n)
                        for i, (s, t) in enumerate(pool)]
                await asyncio.wait_for(server.serve(warm), WARM_TIMEOUT_S)
                before = dataclasses.replace(server.stats)
                start_window()
                with torch.profiler.record_function(tracing.WINDOW_SPAN):
                    out = await loops.open_loop(server, req_cls, pool, k,
                                                params, rng, seconds)
                    _sync(dev)
                close_window()
                ctx["async_before"] = before
                ctx["async_after"] = dataclasses.replace(server.stats)
                return out
        records, w0, w1 = asyncio.run(drive())
        ctx["window_s"] = float(seconds)
    else:
        raise ValueError(f"unknown loop {params['loop']!r}")
    ctx["records"] = records
    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)

    engine_dists = _engine_dists(mods, engine, pool, k)
    if trace:
        t0 = time.perf_counter()
        ctx["batches"] = counted.batches
        ctx["program_device"] = program_trace.read_device(
            prof, ctx["program"].spans,
            program_trace.copy_bytes(prof) if dev.type == "cuda" else None)
        if ctx["program_device"] is None:
            raise RuntimeError("the trace holds no window span")
        counted.remove()
        del prof, counted
        log(f"trace_read_s {time.perf_counter() - t0:.3f}")
    del server, engine, graph
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    keys = (None if count_only else
            ref.edge_keys(arrays.n, arrays.esrc, arrays.edst))
    expected, ref_dists = checks.reference_answers(
        n, arrays.esrc, arrays.edst, pool, k, first_n)
    numbers = checks.compare(records, pool, k, first_n, expected, ref_dists,
                             engine_dists, keys, n,
                             admits_all=params["loop"] == "closed")
    log(f"reference_s {time.perf_counter() - t0:.3f} (pool answers "
        f"min {min(expected)} median {int(np.median(expected))} "
        f"max {max(expected)} sum {sum(expected)})")
    ctx["peaks"] = load_json(HERE / "peaks.json").get(
        torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"], base)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": 1, "memory_peak_bytes": int(memory_peak),
            "power_limit_w": (power_limit_w(dev) if dev.type == "cuda"
                              else None)}
    result = {"correct": checks.verdict(numbers),
              "attempted": len(records),
              "failed": stats.count_failed(records),
              "metrics": metrics, "device": info}
    if trace:
        dv = ctx["program_device"]
        info.update(busy_s=dv["busy_s"], window_s=dv["window_s"])
        result["breakdown"] = {
            "device_ops": dv["device_ops"],
            "idle_gaps": (program_trace.program_idle_gaps(ctx) or [])[:10]}
        result["program"] = program_trace.program_block(ctx)
    result["compile_s"] = compile_s
    result["checks"] = {key: {"value": v, "limit": checks.LIMITS[key]}
                        for key, v in numbers.items()}
    if keep is not None:
        keep.update(ctx)
    return result

