"""The port's sharding rules and constraint builders against ``repro``'s
(pure layout logic: no process group, nothing allocated).

``repro``'s ``ShardingRules`` reads only ``mesh.axis_names`` and
``mesh.shape[name]``, so it gets a duck-typed mesh; the port's reads a
``LayoutMesh``.  Parameter templates come from
``repro.launch.specs.param_specs`` (``jax.eval_shape``) and the port's
meta stand-ins (``repro_torch.launch.specs``); cache templates from the
two ``init_cache``s the same way.  A port layer is paired with its slot
in ``repro``'s tree through ``transformer._plan_slots``, and each
``repro`` spec of a stacked (``supers``) leaf is compared after dropping
its lead entry; a port cache tensor's spec after dropping its layer
entry.  Specs must be equal entry for entry.

The DTensor placements of a spec are checked on hand cases, and the
order in which DTensor splits one tensor dim over two mesh dims
(``("pod", "data")``: pod outermost, JAX's major-to-minor order) on real
shards, in a subprocess with a fake process group of 8 ranks.
"""
import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_arch as jget_arch
from repro.distributed import constraints as jcon
from repro.distributed import sharding as jshard
from repro.launch import specs as jspecs
from repro.models import transformer as jtf
from repro_torch import tree as tree_mod
from repro_torch.configs import get_arch
from repro_torch.distributed import constraints as con
from repro_torch.distributed import sharding as S
from repro_torch.launch import specs
from repro_torch.models import transformer as tm

HERE = Path(__file__).resolve().parent
MESHES = {"4x2": (4, 2), "16x16": (16, 16), "2x16x16": (2, 16, 16),
          "8x1": (8, 1), "1x1": (1, 1)}
PRESETS = ("full", "reduced")
# (batch, max_len) of the cache templates per preset: repro's decode_32k
# and a batch of one (the sequence-sharded fallback)
CACHE_SHAPES = {"full": ((128, 32_768), (1, 524_288)),
                "reduced": ((4, 64), (1, 64))}


def names_of(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def jmesh(shape):
    names = names_of(shape)
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


def tmesh(shape):
    return S.LayoutMesh(tuple(shape), names_of(shape))


def jpath(path) -> str:
    return jshard.path_str(path)


def cfgs(arch, preset):
    j, t = jget_arch(arch), get_arch(arch)
    return (j.reduced(), t.reduced()) if preset == "reduced" else (j, t)


@functools.lru_cache(maxsize=None)
def param_templates(arch, preset):
    jcfg, tcfg = cfgs(arch, preset)
    jt = jspecs.param_specs(jcfg)
    jleaves = {jpath(p): tuple(x.shape)
               for p, x in jax.tree_util.tree_leaves_with_path(jt)}
    tt = specs.param_specs(tcfg)
    return jleaves, tt


def paired_params(arch, preset):
    """(port path, port shape, repro path, repro shape, stacked) for every
    parameter leaf of the port."""
    jleaves, tt = param_templates(arch, preset)
    _, tcfg = cfgs(arch, preset)
    slots = list(tm._plan_slots(tcfg))
    out = []
    for path, x in tree_mod.leaves_with_path(tt):
        parts = path.split("/")
        if parts[0] == "layers":
            _kind, group, name, _si = slots[int(parts[1])]
            jp = "/".join([group, name] + parts[2:])
            stacked = group == "supers"
        else:
            jp, stacked = path, False
        out.append((path, tuple(x.shape), jp, jleaves[jp], stacked))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_repro(arch, preset, mesh):
    jr = jshard.ShardingRules(jmesh(MESHES[mesh]))
    tr = S.ShardingRules(tmesh(MESHES[mesh]))
    pairs = paired_params(arch, preset)
    seen = set()
    for path, shape, jp, jshape, stacked in pairs:
        want = tuple(jr.param_spec(jp, jshape))
        if stacked:
            assert want[0] is None
            want = want[1:]
            assert jshape[1:] == shape
        else:
            assert jshape == shape
        assert tuple(tr.param_spec(path, shape)) == want, (path, jp)
        seen.add(jp)
    jleaves, _ = param_templates(arch, preset)
    assert seen == set(jleaves)


@functools.lru_cache(maxsize=None)
def cache_templates(arch, preset, batch, max_len):
    jcfg, tcfg = cfgs(arch, preset)
    jt = jax.eval_shape(functools.partial(jtf.init_cache, jcfg, batch,
                                          max_len))
    jleaves = [(jpath(p), tuple(x.shape))
               for p, x in jax.tree_util.tree_leaves_with_path(jt)]
    tt = tm.init_cache(tcfg, batch, max_len, device="meta")
    return jleaves, tt


def port_cache_key(jp: str) -> str:
    """The port's cache entry holding ``repro``'s cache leaf ``jp``
    (``{group}/b{j}_{kind}/{0|1}``)."""
    _group, block, idx = jp.split("/")
    kind = block.split("_", 1)[1]
    if kind in tm.ATTN_KINDS:
        return ("k", "v")[int(idx)]
    return f"{kind}/{idx}"


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_equal_repro(arch, preset, mesh):
    jr = jshard.ShardingRules(jmesh(MESHES[mesh]))
    tr = S.ShardingRules(tmesh(MESHES[mesh]))
    for batch, max_len in CACHE_SHAPES[preset]:
        jleaves, tt = cache_templates(arch, preset, batch, max_len)
        tleaves = dict(tree_mod.leaves_with_path(tt))
        assert {port_cache_key(jp) for jp, _ in jleaves} == set(tleaves)
        for jp, jshape in jleaves:
            key = port_cache_key(jp)
            t = tleaves[key]
            want = tuple(jr.cache_spec(jp, jshape))
            if jp.startswith("supers/"):
                assert want[0] is None
                want, jshape = want[1:], jshape[1:]
            assert tuple(t.shape[1:]) == jshape, (jp, key)
            got = tuple(tr.cache_spec(key, tuple(t.shape)))
            assert got[0] is None                  # the layer dim
            assert got[1:] == want, (jp, key, batch)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_equal_repro(mesh):
    jr = jshard.ShardingRules(jmesh(MESHES[mesh]))
    tr = S.ShardingRules(tmesh(MESHES[mesh]))
    for shape in ((256, 4096), (128,), (1, 524_288), (32, 256, 3072),
                  (6, 7)):
        assert tuple(tr.batch_spec("tokens", shape)) == tuple(
            jr.batch_spec("tokens", shape))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_specs_divide_their_dims(mesh):
    """``repro``'s divisibility property (tests/test_distributed.py) on
    the port's specs: every named axis group divides the dim it
    splits, for every arch at both presets, parameters and caches."""
    m = tmesh(MESHES[mesh])
    rules = S.ShardingRules(m)
    sizes = S.axis_sizes(m)
    bad = []
    for arch in ARCH_IDS:
        for preset in PRESETS:
            _, tt = param_templates(arch, preset)
            trees = [(tt, rules.param_spec)]
            for batch, max_len in CACHE_SHAPES[preset]:
                trees.append((cache_templates(arch, preset, batch,
                                              max_len)[1],
                              rules.cache_spec))
            for tree, rule in trees:
                for path, x in tree_mod.leaves_with_path(tree):
                    spec = rule(path, tuple(x.shape))
                    assert len(spec) == x.dim(), (arch, path)
                    for dim, ax in zip(x.shape, spec):
                        if ax is None:
                            continue
                        n = int(np.prod([sizes[a] for a in
                                         ((ax,) if isinstance(ax, str)
                                          else ax)]))
                        if dim % n:
                            bad.append((arch, preset, path, spec))
    assert not bad, bad[:5]


def test_placements_hand_cases():
    from torch.distributed.tensor import Replicate, Shard

    m2 = tmesh((4, 2))
    m3 = tmesh((2, 16, 16))
    assert S.placements(S.P("data", "model"), m2) == (Shard(0), Shard(1))
    assert S.placements(S.P("model", "data"), m2) == (Shard(1), Shard(0))
    assert S.placements(S.P(None, None), m2) == (Replicate(), Replicate())
    assert S.placements(S.P(), m2) == (Replicate(), Replicate())
    assert S.placements(S.P(None, "model", None), m2) == (Replicate(),
                                                           Shard(1))
    # two mesh dims on one tensor dim: both Shard(d), in mesh-dim order
    assert S.placements(S.P(("pod", "data"), "model"), m3) == (
        Shard(0), Shard(0), Shard(1))
    assert S.placements(S.P(None, ("pod", "data")), m3) == (
        Shard(1), Shard(1), Replicate())
    with pytest.raises(ValueError):                 # against the order
        S.placements(S.P(("data", "pod"), None), m3)
    with pytest.raises(ValueError):                 # one axis twice
        S.placements(S.P("data", "data"), m2)
    with pytest.raises(ValueError):                 # not on the mesh
        S.placements(S.P("pod", None), m2)
    with pytest.raises(TypeError):
        S.P(3)
    assert S.P("data", None) == S.P("data", None)
    assert S.P("data") != S.P("model")
    assert len(S.P(None, ("pod", "data"))) == 2


def test_spec_is_a_tree_leaf():
    """Spec trees map one spec to one leaf (``P`` is not a tuple)."""
    tree = {"a": torch.zeros(4, 2), "b": [torch.zeros(3)]}
    specs_ = S.tree_specs(tree, lambda path, shape: S.P(
        *(None,) * len(shape)))
    assert tree_mod.leaves(specs_) == [S.P(None, None), S.P(None)]
    shard = S.tree_shardings(tmesh((4, 2)), specs_)
    assert [s.spec for s in tree_mod.leaves(shard)] == tree_mod.leaves(
        specs_)
    opt = S.opt_shardings(specs_)
    assert opt.step == S.P() and opt.mu is specs_ and opt.nu is specs_


BUILDERS = ("act_bsd", "act_bsd_sp", "act_bsf", "act_tokens_f",
            "moe_slots", "ssd_intra", "logits_bsv", "act_heads",
            "logits_bhqk")
BUILDER_SHAPES = {
    "act_bsd": [(256, 4096, 2048), (1, 4096, 2048), (6, 10, 8)],
    "act_bsd_sp": [(256, 4096, 2048), (2, 36, 8), (1, 7, 8)],
    "act_bsf": [(256, 4096, 8192), (32, 512, 36), (3, 5, 7)],
    "act_tokens_f": [(1_048_576, 2048), (12, 6)],
    "moe_slots": [(128, 640, 2048), (16, 4, 8), (6, 4, 8)],
    "ssd_intra": [(256, 32, 128, 128, 48), (4, 2, 16, 16, 8),
                  (1, 4, 16, 16, 3)],
    "logits_bsv": [(256, 4095, 128_256), (8, 31, 50_280)],
    "act_heads": [(256, 4096, 32, 64), (16, 4096, 36, 128),
                  (16, 4096, 40, 128), (1, 7, 3, 16), (2, 16, 4, 32)],
    "logits_bhqk": [(256, 32, 1024, 4096), (16, 36, 1024, 4096),
                    (1, 3, 7, 7)],
}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("builder", BUILDERS)
def test_constraint_builders_equal_repro(builder, mesh):
    jr = jshard.ShardingRules(jmesh(MESHES[mesh]))
    tr = S.ShardingRules(tmesh(MESHES[mesh]))
    for shape in BUILDER_SHAPES[builder]:
        assert tuple(getattr(con, builder)(tr, shape)) == tuple(
            getattr(jcon, builder)(jr, shape)), shape


def test_constrain_is_a_no_op_outside_a_mesh():
    x = torch.ones(4, 8, 16)
    assert con.current_mesh() is None and con.current_rules() is None
    assert con.constrain(x, con.act_bsd) is x
    with con.use_mesh(None):
        assert con.constrain(x, con.act_bsf) is x


def test_two_axes_on_one_dim_split_pod_outermost():
    """DTensor splits a tensor dim named ``("pod", "data")`` with pod
    outermost, as JAX's major-to-minor order does: on each rank (p, d, m)
    of a (2, 2, 2) mesh the rows of ``arange`` held are block p·2 + d."""
    code = (
        "import torch, torch.distributed as dist\n"
        "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
        "from torch.distributed.tensor import distribute_tensor\n"
        "from repro_torch.compat import make_mesh\n"
        "from repro_torch.distributed import sharding as S\n"
        "x = torch.arange(8 * 4).reshape(8, 4)\n"
        "for r in range(8):\n"
        "    dist.init_process_group('fake', store=FakeStore(), rank=r,\n"
        "                            world_size=8)\n"
        "    mesh = make_mesh((2, 2, 2), ('pod', 'data', 'model'),\n"
        "                     device='cpu')\n"
        "    pl = S.placements(S.P(('pod', 'data'), 'model'), mesh)\n"
        "    loc = distribute_tensor(x, mesh, pl, src_data_rank=None)\n"
        "    print(loc.to_local().flatten().tolist())\n"
        "    dist.destroy_process_group()\n")
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[")]
    assert len(lines) == 8
    for rank, line in enumerate(lines):
        p, d, m = rank // 4, (rank // 2) % 2, rank % 2
        rows = np.arange(32).reshape(8, 4)[(p * 2 + d) * 2:(p * 2 + d + 1)
                                            * 2, m * 2:(m + 1) * 2]
        assert eval(line) == rows.flatten().tolist(), (rank, line)
