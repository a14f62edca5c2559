"""Multi-pod dry run: every (arch × shape × mesh) cell on meta tensors
over a fake process group (the port of ``repro.launch.dryrun``).

``repro`` lowers and compiles each cell for 512 fake TPU devices and
reads XLA's memory and cost analyses.  The port runs the cell's step
itself — the train step (forward and backward), ``make_prefill`` or
``make_serve_step`` — on DTensors whose local shards are meta tensors
(shapes and dtypes, no storage), over a ``DeviceMesh`` of 256 or 512
ranks of the ``"fake"`` backend of
``torch.testing._internal.distributed.fake_pg``: this process plays one
rank, every collective returns at once.  A dispatch mode under DTensor
sees each rank-local operation, so every count is rank 0's own:

  * memory — ``argument_bytes`` and ``output_bytes``, the local shard
    bytes of the inputs and outputs; ``temp_bytes``, the peak of live
    local temporaries over the step (each storage counted once, while a
    tensor on it lives) less the new outputs alive at the end;
    ``alias_bytes``, outputs that are inputs updated in place (a decode
    step's cache); ``peak_estimate_bytes`` = args + outputs + temps −
    aliases;
  * cost — ``flops_per_device`` from torch's FLOP formulas
    (``torch.utils.flop_counter``) on the local shapes (replicated work
    counts on every rank), ``bytes_accessed_per_device`` as every local
    op reading its inputs and writing its outputs (no fusion), and
    ``transcendentals`` (elements of exp, log, tanh, ...);
  * collective bytes — the functional collectives DTensor issues
    (``all_gather_into_tensor``, ``reduce_scatter_tensor``,
    ``all_reduce``, ``all_to_all_single``), per device, under
    ``repro``'s keys and with its operand and ring-wire arithmetic
    (``collective_bytes``).  A mesh on the ``"cpu"`` device type (there
    is no card here) sends DTensor's all-to-all as an all-gather.

Eager torch undercounts nothing, but ``repro``'s 1- and 2-super-block
twins are kept: the cell runs on both and ``extrapolate_costs`` scales
every count to the full depth (the stack is homogeneous), which keeps a
48-layer cell to seconds.

Usage (no card needed):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2_780m \\
      --shape long_500k --mesh multi
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .. import tree as tree_mod

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
_TRANSCENDENTAL = {"exp", "log", "tanh", "sigmoid", "rsqrt", "sqrt", "cos",
                   "sin", "_softmax", "_log_softmax", "logsumexp", "gelu",
                   "softplus", "silu", "pow"}
ALL_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def collective_bytes(records: Sequence[Tuple[str, float, int]]
                     ) -> Dict[str, float]:
    """Per-device operand bytes per collective kind from ``(kind, result
    bytes, group size)`` records, ``repro``'s arithmetic: operand ==
    result for all-reduce, all-to-all and collective-permute; result /
    group for all-gather; result · group for reduce-scatter.  Also the
    ring-model wire bytes (what crosses the links per device): all-gather
    and reduce-scatter ≈ operand·(g−1) resp. result·(g−1); all-reduce ≈
    2·operand·(g−1)/g; the rest their operand."""
    out: Dict[str, float] = {}
    wire = 0.0
    for kind, rbytes, group in records:
        g = max(int(group), 1)
        if kind == "all-gather":
            operand = rbytes / g
            wire += operand * (g - 1)
        elif kind == "reduce-scatter":
            operand = rbytes * g
            wire += rbytes * (g - 1)
        elif kind == "all-reduce":
            operand = rbytes
            wire += 2.0 * rbytes * (g - 1) / g
        else:  # all-to-all / collective-permute
            operand = rbytes
            wire += rbytes
        out[kind] = out.get(kind, 0) + operand
    out["total_operand"] = sum(v for k, v in out.items())
    out["wire_bytes"] = wire
    return out


def extrapolate_costs(c1: Dict[str, float], c2: Dict[str, float],
                      ns: int) -> Dict[str, float]:
    """Layer-linear model: f(ns) = f(1) + (ns − 1)·(f(2) − f(1)), from
    the 1- and 2-super-block twins (``repro``'s)."""
    out = {}
    for k in c1:
        body = max(c2.get(k, 0.0) - c1[k], 0.0)
        out[k] = c1[k] + (ns - 1) * body
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in tree_mod.leaves(tree) if isinstance(x, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class CostMode:
    """Counts one rank's work under DTensor: FLOPs, bytes accessed,
    transcendentals, collectives and live local bytes.  A dispatch mode
    that hands every DTensor call back to DTensor (``NotImplemented``),
    so it sees the local operations DTensor runs them as, collectives
    included (not the fake-tensor runs by which DTensor derives global
    shapes)."""

    def __init__(self, preexisting: Sequence[torch.Tensor] = ()):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.records: List[Tuple[str, float, int]] = []
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, List[int]] = {}
        self._known = {_storage_key(t) for t in preexisting}
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch._subclasses.fake_tensor import FakeTensor
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                # DTensor derives each output's global shape by running the
                # op on fake tensors: no rank's work
                if not any(isinstance(x, FakeTensor) for x in
                           tree_mod.leaves((args, kwargs, out))):
                    counter._count(func, args, kwargs, out, flop_registry)
                return out

        self._mode = _Mode()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def _count(self, func, args, kwargs, out, flop_registry) -> None:
        packet = func._overloadpacket
        outs = [x for x in tree_mod.leaves(out)
                if isinstance(x, torch.Tensor)]
        name = packet.__name__
        if str(packet).startswith("_c10d_functional."):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                self.records.append((kind, float(sum(map(_nbytes, outs))),
                                     _group_size(name, args)))
        else:
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            ins = [x for x in tree_mod.leaves((args, kwargs))
                   if isinstance(x, torch.Tensor)]
            self.bytes_accessed += sum(map(_nbytes, ins + outs))
            if name in _TRANSCENDENTAL:
                self.transcendentals += sum(x.numel() for x in outs)
        for t in outs:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._known:
            return
        ref = self._refs.get(key)
        if ref is None:
            size = t.untyped_storage().nbytes()
            self._refs[key] = [1, size]
            self.live += size
            self.peak = max(self.peak, self.live)
        else:
            ref[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self.live -= ref[1]
            del self._refs[key]

    def costs(self) -> Dict[str, float]:
        out = {"flops": float(self.flops),
               "bytes": float(self.bytes_accessed),
               "transcendentals": float(self.transcendentals)}
        for k, v in collective_bytes(self.records).items():
            out[f"coll/{k}"] = v
        return out


def _group_size(name: str, args) -> int:
    """A functional collective's group size: its ``group_size`` argument,
    else the size of the group its name resolves to."""
    if name.startswith(("all_gather", "reduce_scatter")):
        return int(args[1] if name.startswith("all_gather") else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


_FAKE: Dict[str, Any] = {"key": None}   # (world, rank) of the group made here


def _clear_dtensor_caches() -> None:
    """Forget DTensor's cached sharding and redistribution plans, which
    name the process groups of a mesh equal to a new one."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _collective_utils, _redistribute

    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(_redistribute, "_gen_transform_infos", None),
               getattr(getattr(_collective_utils, "MeshTopoInfo", None),
                       "build_from_mesh", None),
               getattr(prop, "_propagate_tensor_meta_cached", None),
               getattr(getattr(prop, "propagate_op_sharding", None),
                       "cache", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    native = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                     None)
    if native is not None:
        native()


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A default process group of ``world`` ranks of the fake backend,
    this process as ``rank``.  It stays for the next cell of the same
    world and rank (DTensor caches plans by mesh); another world or rank
    replaces it.  Refuses to run beside a default group made elsewhere."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if _FAKE["key"] is None:
            raise RuntimeError(
                f"the dry run needs its own fake process group; a "
                f"{dist.get_backend()!r} default group of "
                f"{dist.get_world_size()} ranks is set")
        if _FAKE["key"] != (world, rank):
            release_fake_group()
    if not dist.is_initialized():
        # the dry run's fake group: meta tensors, no device and no mesh
        # engine, so compat.make_mesh (a real backend) is not the place
        dist.init_process_group(  # repro-torch-lint: disable=compat-boundary
            "fake", store=FakeStore(), rank=rank, world_size=world)
        _FAKE["key"] = (world, rank)
    yield


def release_fake_group() -> None:
    """Destroy the fake group ``fake_group`` made, if any."""
    import torch.distributed as dist

    if _FAKE["key"] is not None and dist.is_initialized():
        dist.destroy_process_group()
        _clear_dtensor_caches()
    _FAKE["key"] = None


def _step_call(cfg, shape, mesh, rules, dtype, microbatches, unroll_accum):
    """(step function, its arguments distributed on meta, param specs)."""
    from ..distributed import sharding as shard_mod
    from ..optim import adamw
    from ..training import step as step_mod
    from . import specs as specs_mod

    params_t = specs_mod.param_specs(cfg, dtype)
    pspecs = shard_mod.tree_specs(params_t, rules.param_spec)
    params = shard_mod.distribute_tree(params_t, mesh, pspecs)
    inputs = specs_mod.input_specs(cfg, shape, dtype)
    if shape.kind in ("train", "prefill"):
        batch = shard_mod.distribute_tree(
            inputs["batch"], mesh,
            shard_mod.tree_specs(inputs["batch"], rules.batch_spec))
        if shape.kind == "prefill":
            return step_mod.make_prefill(cfg), (params, batch), pspecs
        opt_t = specs_mod.opt_specs(params_t)
        opt = shard_mod.distribute_tree(
            opt_t, mesh, shard_mod.opt_shardings(pspecs, opt_t))
        fn = step_mod.make_train_step(cfg, adamw.OptimizerConfig(),
                                      microbatches=microbatches,
                                      unroll_accum=unroll_accum)
        return fn, (params, opt, batch), pspecs
    cache = shard_mod.distribute_tree(
        inputs["cache"], mesh,
        shard_mod.tree_specs(inputs["cache"], rules.cache_spec))
    token, cache_len = (shard_mod.distribute_tree(
        inputs[k], mesh, shard_mod.tree_specs(inputs[k], rules.batch_spec))
        for k in ("token", "cache_len"))
    rng = shard_mod.distribute_tree(inputs["rng"], mesh, shard_mod.P(None))
    fn = step_mod.make_serve_step(cfg)

    def serve(params, token, cache, cache_len, rng):
        del rng                    # greedy: the port's step draws nothing
        return fn(params, token, cache, cache_len)
    return serve, (params, token, cache, cache_len, rng), pspecs


def measure(cfg, shape, mesh, dtype=torch.bfloat16, microbatches: int = 1,
            unroll_accum: bool = False) -> Tuple[Dict, Dict, Any]:
    """(memory, costs, param specs) of one rank running ``cfg``'s step
    for ``shape`` on ``mesh`` (meta tensors)."""
    from ..distributed import constraints as con
    from ..distributed import sharding as shard_mod

    rules = shard_mod.ShardingRules(mesh)
    fn, args, pspecs = _step_call(cfg, shape, mesh, rules, dtype,
                                  microbatches, unroll_accum)
    arg_leaves = _tensors(args)
    local_args = [_local(x) for x in arg_leaves]
    mode = CostMode(local_args)
    with con.use_mesh(mesh), mode:
        out = fn(*args)
        out_leaves = _tensors(out)
        outputs = sum(_nbytes(_local(x)) for x in out_leaves)
        alias = sum(_nbytes(_local(x)) for x in out_leaves
                    if any(x is a for a in arg_leaves))
        del out
    args_bytes = sum(map(_nbytes, local_args))
    # the new outputs are alive at the end; what peaked beyond them is
    # the temporaries
    temp = max(mode.peak - (outputs - alias), 0)
    memory = {"argument_bytes": args_bytes, "output_bytes": outputs,
              "temp_bytes": temp, "alias_bytes": alias,
              "peak_estimate_bytes": args_bytes + outputs + temp - alias}
    return memory, mode.costs(), pspecs


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             microbatches: int = 1, out_dir: str = "experiments/dryrun",
             attn_chunk: Optional[int] = None, seq_shard: bool = False,
             unroll_accum: bool = False, *,
             mesh_shape: Optional[Sequence[int]] = None, rank: int = 0,
             cfg=None, shape=None,
             dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """One cell's record (``repro``'s keys).  ``mesh_shape`` replaces the
    production mesh (``("data", "model")``, or ``("pod", "data",
    "model")`` with three dims), ``rank`` picks the rank this process
    plays, ``cfg`` and ``shape`` replace the named config and shape, and
    ``dtype`` is the parameters' (``repro``'s bfloat16 by default)."""
    from ..configs import get_arch, get_shape
    from ..compat import make_mesh
    from ..models.transformer import layer_plan
    from .mesh import make_production_mesh

    del out_dir
    cfg = cfg if cfg is not None else get_arch(arch)
    if attn_chunk:
        cfg = dataclasses.replace(cfg, attn_chunk=attn_chunk)
    if seq_shard:
        cfg = dataclasses.replace(cfg, seq_shard_activations=True)
    shape = shape if shape is not None else get_shape(shape_name)
    supported, reason = cfg.shape_supported(shape)
    record: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "microbatches": microbatches,
        "params_B": cfg.param_count() / 1e9,
        "active_params_B": cfg.active_param_count() / 1e9,
    }
    if not supported:
        record["status"] = "skipped"
        record["reason"] = reason
        return record

    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    mesh_shape = tuple(int(x) for x in mesh_shape)
    names = ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")
    chips = math.prod(mesh_shape)
    record["chips"] = chips
    pat, ns, tail = layer_plan(cfg)

    t0 = time.time()
    with fake_group(chips, rank):
        if mesh_shape in ((16, 16), (2, 16, 16)):
            mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3,
                                        device="cpu")
        else:
            mesh = make_mesh(mesh_shape, names, device="cpu")
        t_mesh = time.time() - t0
        t0 = time.time()
        kw = dict(dtype=dtype, microbatches=microbatches,
                  unroll_accum=unroll_accum)
        if ns <= 2:
            memory, costs, pspecs = measure(cfg, shape, mesh, **kw)
            record["cost_source"] = "full-depth"
        else:
            twins = [measure(dataclasses.replace(
                cfg, num_layers=n * len(pat) + len(tail)), shape, mesh,
                **kw) for n in (1, 2)]
            (m1, c1, _), (m2, c2, _) = twins
            costs = extrapolate_costs(c1, c2, ns)
            memory = {k: int(v) for k, v in
                      extrapolate_costs(m1, m2, ns).items()}
            memory["peak_estimate_bytes"] = (
                memory["argument_bytes"] + memory["output_bytes"]
                + memory["temp_bytes"] - memory["alias_bytes"])
            pspecs = twins[0][2]
            record["cost_source"] = "twins-extrapolated"
        t_analysis = time.time() - t0

    record["memory"] = memory
    record["cost"] = {
        "flops_per_device": costs["flops"],
        "bytes_accessed_per_device": costs["bytes"],
        "transcendentals": costs["transcendentals"],
    }
    record["collectives_per_device_bytes"] = {
        k.split("/", 1)[1]: v for k, v in costs.items()
        if k.startswith("coll/")}
    record["status"] = "ok"
    record["mesh_seconds"] = round(t_mesh, 2)
    record["analysis_seconds"] = round(t_analysis, 2)
    record["param_spec_sample"] = {"embed": str(pspecs["embed"])}
    # GQA fallback visibility
    record["kv_shard"] = "heads" if cfg.kv_heads % 16 == 0 else "head_dim"
    return record


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi",
                                                       "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence-parallel residuals")
    ap.add_argument("--unroll-accum", action="store_true",
                    help="repro's Python-loop accumulation switch (the "
                         "port always loops)")
    ap.add_argument("--suffix", default="",
                    help="output-file suffix for variants")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from ..configs import ARCH_IDS

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = ALL_SHAPES if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                cell = f"{arch}__{shape}__{mesh_kind}{args.suffix}"
                path = os.path.join(args.out, cell + ".json")
                if os.path.exists(path):
                    with open(path) as f:
                        if json.load(f).get("status") in ("ok", "skipped"):
                            print(f"[skip-cached] {cell}")
                            continue
                t0 = time.time()
                try:
                    rec = run_cell(arch, shape, mesh_kind,
                                   microbatches=args.microbatches,
                                   out_dir=args.out,
                                   seq_shard=args.seq_shard,
                                   unroll_accum=args.unroll_accum)
                except Exception as e:  # noqa: BLE001 — recorded per cell
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
                           "status": "error", "error": repr(e),
                           "traceback": traceback.format_exc()[-2000:]}
                    failures += 1
                rec["variant"] = args.suffix.lstrip("_") or "baseline"
                rec["wall_seconds"] = round(time.time() - t0, 2)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=2, default=float)
                print(f"[{rec['status']:7s}] {cell} "
                      f"({rec['wall_seconds']}s)", flush=True)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
