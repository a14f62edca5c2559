"""The dry run (``repro_torch.launch.{specs,dryrun,mesh}``) against
``repro.launch``'s.

In-process (no process group): the meta stand-ins' shapes and dtypes
against ``repro``'s ``ShapeDtypeStruct``s for every arch × shape, the
long_500k gates, ``HARDWARE``'s keys, ``extrapolate_costs`` and the
collective-byte arithmetic on tests/test_dryrun_unit.py's sample sizes.

In subprocesses (the fake process group is process-global; nothing
leaks into the test worker), all at once: ``run_cell`` on a 2 x 2 fake
mesh for the prefill and decode cells of one ``reduced()`` arch of each
family (tests/torch_shard_parity.py ``dryrun serve``), then its refusal
beside a real default group; and the command line on a full-size cell
of the production mesh.  (The train cells, held to the gloo ranks'
own counts, are in tests/test_torch_mesh_lm.py.)
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch as jget_arch, get_shape as jshape
from repro.launch import dryrun as jdry
from repro.launch import mesh as jmesh
from repro.launch import specs as jspecs
from repro_torch import tree as tree_mod
from repro_torch.configs import get_arch, get_shape
from repro_torch.distributed import sharding as S
from repro_torch.launch import dryrun, mesh as tmesh, specs

import torch_shard_parity as sp

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
TIMEOUT = 600
JAX_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
              jnp.dtype(jnp.uint32): torch.uint32,
              jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.float32): torch.float32}
CLI_CELL = ("mamba2_780m", "long_500k", "multi")


def jleaves(tree):
    return [(jax.tree_util.keystr(p), x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)]


def layer_count(cfg, kind_key):
    from repro_torch.models import transformer as tm
    kinds = tm.layer_kinds(cfg)
    if kind_key in ("k", "v"):
        return sum(k in tm.ATTN_KINDS for k in kinds)
    return kinds.count(kind_key.split("/")[0])


@pytest.mark.parametrize("shape_name", dryrun.ALL_SHAPES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_equal_repro(arch, shape_name):
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    jsp = jspecs.input_specs(jcfg, jshape(shape_name))
    tsp = specs.input_specs(tcfg, get_shape(shape_name))
    assert set(tsp) == set(jsp)
    for key in tsp:
        if key == "cache":
            continue
        j = dict(jleaves(jsp[key]))
        t = dict(tree_mod.leaves_with_path(tsp[key]))
        assert len(j) == len(t)
        for (jk, jx), (tk, tx) in zip(sorted(j.items()), sorted(t.items())):
            assert tx.device.type == "meta"
            assert tuple(tx.shape) == tuple(jx.shape), (key, tk)
            assert tx.dtype == JAX_DTYPES[jnp.dtype(jx.dtype)], (key, tk)
    if "cache" not in tsp:
        return
    tcache = dict(tree_mod.leaves_with_path(tsp["cache"]))
    for path, jx in jax.tree_util.tree_leaves_with_path(jsp["cache"]):
        jp = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path)
        group, block, idx = jp.split("/")
        kind = block.split("_", 1)[1]
        key = ("k", "v")[int(idx)] if kind in ("attn", "moe", "dense") \
            else f"{kind}/{idx}"
        tx = tcache[key]
        per_layer = tuple(jx.shape[1:] if group == "supers" else jx.shape)
        assert tuple(tx.shape[1:]) == per_layer, (jp, key)
        assert tx.shape[0] == layer_count(tcfg, key)
        assert tx.dtype == JAX_DTYPES[jnp.dtype(jx.dtype)], (jp, key)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_are_meta_with_repro_counts(arch):
    """The stand-ins allocate nothing and hold ``repro``'s parameter
    count and dtypes (bfloat16, float32 where ``repro`` keeps it)."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    p = specs.param_specs(tcfg)
    o = specs.opt_specs(p)
    leaves = tree_mod.leaves(p)
    assert all(x.device.type == "meta" for x in tree_mod.leaves((p, o)))
    jp = jspecs.param_specs(jcfg)
    assert sum(x.numel() for x in leaves) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(jp))
    by_dtype, jby_dtype = {}, {}
    for x in leaves:
        by_dtype[x.dtype] = by_dtype.get(x.dtype, 0) + x.numel()
    for x in jax.tree.leaves(jp):
        d = JAX_DTYPES[jnp.dtype(x.dtype)]
        jby_dtype[d] = jby_dtype.get(d, 0) + int(np.prod(x.shape))
    assert by_dtype == jby_dtype
    assert all(x.dtype == torch.float32 for x in tree_mod.leaves(o.mu))
    assert o.step.dtype == torch.int32


def test_long500k_gates():
    for arch in ARCH_IDS:
        ok, reason = get_arch(arch).shape_supported(get_shape("long_500k"))
        jok, jreason = jget_arch(arch).shape_supported(jshape("long_500k"))
        assert (ok, reason) == (jok, jreason)
    for arch, expect in [("mamba2_780m", True), ("recurrentgemma_9b", True),
                         ("mistral_large_123b", False),
                         ("musicgen_large", False)]:
        ok, _ = get_arch(arch).shape_supported(get_shape("long_500k"))
        assert ok == expect, arch
        if not expect:
            # skipped before any process group or tensor is made
            rec = dryrun.run_cell(arch, "long_500k", "single")
            assert rec["status"] == "skipped"
            assert rec["reason"].startswith("skipped(full-attention)")


def test_hardware_keys():
    """``repro``'s keys where they mean the same thing, ``ici_bandwidth``
    as ``nvlink_bandwidth``; H100 SXM data-sheet values."""
    assert set(tmesh.HARDWARE) == (set(jmesh.HARDWARE) - {"ici_bandwidth"}) \
        | {"nvlink_bandwidth"}
    assert tmesh.HARDWARE == {"peak_flops_bf16": 989e12,
                              "hbm_bandwidth": 3.35e12,
                              "nvlink_bandwidth": 450e9, "hbm_bytes": 80e9}


def test_no_process_group_at_import():
    import torch.distributed as dist
    assert not dist.is_initialized()


@pytest.mark.parametrize("ns", [1, 2, 16, 48])
def test_extrapolate_costs_equals_repro(ns):
    c1 = {"flops": 10.0, "bytes": 7.0, "coll/all-gather": 3.0, "x": 5.0}
    c2 = {"flops": 16.0, "bytes": 11.5, "coll/all-gather": 3.0, "x": 4.0}
    assert dryrun.extrapolate_costs(c1, c2, ns) == \
        jdry.extrapolate_costs(c1, c2, ns)


# tests/test_dryrun_unit.py's HLO sample as (kind, result bytes, group)
HAND_RECORDS = [("all-gather", 4096 * 256 * 4, 16),
                ("all-reduce", 256 * 4096 * 2, 16),
                ("reduce-scatter", 128 * 4, 4),
                ("collective-permute", 64 * 4, 1),
                ("all-reduce", 2 * 8 * 4, 4)]


def test_collective_arithmetic_on_repro_sample():
    out = dryrun.collective_bytes(HAND_RECORDS)
    assert out["all-gather"] == 4096 * 256 * 4 / 16
    assert out["all-reduce"] == 256 * 4096 * 2 + 2 * 8 * 4
    assert out["reduce-scatter"] == 128 * 4 * 4
    assert out["collective-permute"] == 64 * 4
    assert out["total_operand"] == sum(
        v for k, v in out.items() if k not in ("total_operand", "wire_bytes"))
    from test_dryrun_unit import HLO_SAMPLE
    assert out == jdry.collective_bytes(HLO_SAMPLE)


def test_collective_arithmetic_wire_bytes():
    """A tuple all-reduce over 8 ranks (tests/test_dryrun_unit.py's
    index-comment case): 2·operand·7/8 on the wire."""
    want = 4 * (1 + 1024 * 256 + 256 + 2 * 256 * 128 + 2 * 256 * 256
                + 2 * 256 * 256 + 2 * 256 * 128)
    out = dryrun.collective_bytes([("all-reduce", want, 8)])
    assert out["all-reduce"] == want
    assert out["wire_bytes"] == 2 * want * 7 / 8
    assert dryrun.collective_bytes([]) == {"total_operand": 0,
                                           "wire_bytes": 0.0}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(SRC), str(HERE)]),
               OMP_NUM_THREADS="1")
    arch, shape, mesh = CLI_CELL
    procs = [
        subprocess.Popen([sys.executable, str(HERE / "torch_shard_parity.py"),
                          "dryrun", "serve", str(tmp / "serve.pkl")],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True),
        subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", arch, "--shape", shape, "--mesh", mesh,
                          "--out", str(tmp / "cli")], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)]
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(tmp / "serve.pkl", "rb") as fh:
        serve = pickle.load(fh)
    with open(tmp / "cli" / f"{arch}__{shape}__{mesh}.json") as fh:
        cli = json.load(fh)
    return {"serve": serve, "cli": cli, "cli_log": logs[1]}


def hand_local_bytes(trees_and_rules, mesh):
    """The bytes of one rank's shards of every tensor, from the specs."""
    sizes = S.axis_sizes(mesh)
    total = 0
    for tree, rule in trees_and_rules:
        for path, x in tree_mod.leaves_with_path(tree):
            n = x.numel() * x.element_size()
            for entry in rule(path, tuple(x.shape)):
                for name in ((entry,) if isinstance(entry, str)
                             else entry or ()):
                    n //= sizes[name]
            total += n
    return total


@pytest.mark.parametrize("shape_name", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", sorted(sp.FAMILY_ARCHS.values()))
def test_run_cell_on_a_2x2_fake_mesh(cells, arch, shape_name):
    (rec,) = cells["serve"][(arch, shape_name)]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 4
    cfg = get_arch(arch).reduced()
    mesh = S.LayoutMesh((2, 2), ("data", "model"))
    rules = S.ShardingRules(mesh)
    inputs = specs.input_specs(cfg, sp.dryrun_shape(shape_name),
                               torch.float32)
    params = specs.param_specs(cfg, torch.float32)
    trees = [(params, rules.param_spec)]
    if shape_name == "prefill_32k":
        trees.append((inputs["batch"], rules.batch_spec))
    else:
        trees += [(inputs["cache"], rules.cache_spec),
                  (inputs["token"], rules.batch_spec),
                  (inputs["cache_len"], rules.batch_spec),
                  (inputs["rng"], lambda p, s: S.P(None))]
    mem = rec["memory"]
    assert mem["argument_bytes"] == hand_local_bytes(trees, mesh)
    assert rec["cost"]["flops_per_device"] > 0
    assert mem["temp_bytes"] > 0
    if shape_name == "decode_32k":
        # the step writes the cache in place: every cache byte aliases
        assert mem["alias_bytes"] == hand_local_bytes(
            [(inputs["cache"], rules.cache_spec)], mesh)
    assert mem["peak_estimate_bytes"] == (mem["argument_bytes"]
                                          + mem["output_bytes"]
                                          + mem["temp_bytes"]
                                          - mem["alias_bytes"])
    assert rec["param_spec_sample"]["embed"] == str(
        rules.param_spec("embed", (cfg.vocab, cfg.d_model)))


def test_run_cell_refuses_beside_a_real_group(cells):
    assert "fake process group" in cells["serve"]["refused"]


def test_command_line_on_the_production_mesh(cells):
    rec = cells["cli"]
    assert rec["status"] == "ok", rec
    assert rec["chips"] == 512
    assert rec["cost_source"] == "twins-extrapolated"
    assert rec["param_spec_sample"]["embed"] == "P('pod', None)"
    for key in ("memory", "cost", "collectives_per_device_bytes",
                "kv_shard", "mesh_seconds", "analysis_seconds",
                "wall_seconds", "variant"):
        assert key in rec
    assert rec["collectives_per_device_bytes"]["total_operand"] > 0
    assert "failures=0" in cells["cli_log"]
