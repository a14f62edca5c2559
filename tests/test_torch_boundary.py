"""The port's boundaries: what it imports, where it runs, how it fails.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor
  ``repro`` (an AST scan of every import statement).
* The entry points (the PathEnum engines and the LM stack's parameters,
  caches, serving engine and launcher) default to ``device="cuda"``:
  without a CUDA device a default call raises instead of running on the
  CPU.
* The training entry points (``Trainer``, ``PathCorpus``,
  ``adamw.state_from_numpy``, the train launcher) default to ``"cuda"``
  and raise without a card.
* The HcPE front-ends (``HcPEServer``, ``AsyncHcPEServer``) build their
  engine on the card by default and raise without one.
* No ``async def`` body in ``src/repro_torch/serving`` blocks the event
  loop or syncs the card (the port's counterpart of ``repro``'s
  async-safety lint pass, an AST scan).
* A kernel wrapper given CPU tensors runs the plain version and counts
  no launch.
* ``chip_smoke.py`` exits non-zero and prints no result without a CUDA
  device, and when run from a directory that holds nothing else of the
  repository.
* The mesh engine's entry points (``compat.make_mesh``,
  ``DistributedPathEnum``, ``DistributedTenantRouter``) default to
  ``"cuda"`` and raise without a card before any process group exists,
  and its modules import neither ``jax`` nor ``repro``.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch import compat, kernels
from repro_torch.distributed import (DistributedPathEnum,
                                     DistributedTenantRouter)
from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import semiring_spmm as sr
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import (cache_from_numpy, init_cache, init_params,
                                params_from_numpy)
from repro_torch.serving import (AsyncHcPEServer, GraphRegistry,
                                 HcPEServer, ServeEngine)

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
    return files + [REPO / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for root in _imported_roots(tree):
            if root in FORBIDDEN:
                bad.append(f"{path.relative_to(REPO)} imports {root}")
    assert not bad, bad


def test_default_device_is_cuda():
    g = tc.erdos_renyi(40, 4.0, seed=7)
    if torch.cuda.is_available():
        out = tc.PathEnum().query(g, 0, 39, 4)
        assert out.index.device.type == "cuda"
        batch = tc.BatchPathEnum().run(g, [(0, 39, 4), (1, 38, 4)])
        assert all(i.result.count >= 0 for i in batch.items)
        assert tc.BatchPathEnum().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.BatchPathEnum()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.batched_index_distances(g, [(0, 39, 4)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.PathEnum().query(g, 0, 39, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.build_index(g, 0, 39, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.build_index_device(g, 0, 39, 4)
    idx = tc.build_index(g, 0, 39, 4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.enumerate_paths_idx(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.walk_count_dp(idx)


def test_cpu_tensors_take_the_plain_versions():
    kernels.reset_launch_counts()
    loaded = dict(_build._loaded)
    paths = torch.tensor([[0, -1, -1]], dtype=torch.int32)
    begin = torch.tensor([0, 1, 1], dtype=torch.int32)
    end = torch.tensor([[1, 1, 1], [1, 1, 1], [1, 1, 1]], dtype=torch.int32)
    dst = torch.tensor([2], dtype=torch.int32)
    meta = torch.tensor([0, 2], dtype=torch.int32)
    got = fe.frontier_masks(paths, begin, end, dst, meta, max_deg=1)
    want = fe.frontier_masks_plain(paths, begin, end, dst, meta, max_deg=1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].tolist() == [[1]] and got[3].tolist() == [1, 1, 0, 0]
    adj = torch.ones((4, 4))
    assert torch.equal(sr.counting_spmm(adj, torch.ones((4, 1))),
                       torch.full((4, 1), 4.0))
    assert torch.equal(sr.minplus_spmv(adj, torch.zeros(4), inf=1e9),
                       torch.zeros(4))
    assert torch.equal(sr.minplus_spmv(adj, torch.zeros(4), inf=1e9,
                                       transposed=True), torch.zeros(4))
    assert sr.bfs_dense(adj, 0, 2, inf=1e9).tolist() == [0.0, 1.0, 1.0,
                                                           1.0]
    erows, crows, head = fe.frontier_hop(paths, begin, end, dst, meta,
                                         max_deg=1)
    assert head.tolist() == [1, 1, 0, 0, 1, 0, 0, 0]
    assert erows[:1].tolist() == [[0, 2, -1]] and crows.shape == (1, 3)
    rank = torch.zeros(1, dtype=torch.int32)
    tv = torch.tensor([2], dtype=torch.int32)
    dv = torch.tensor([0], dtype=torch.int32)
    got = fe.frontier_fused_masks(paths, rank, tv, dv, [begin], [end],
                                  [dst], max_deg=1)
    want = fe.frontier_fused_masks_plain(paths, rank, tv, dv, [begin],
                                         [end], [dst], max_deg=1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[1].tolist() == [[1]] and got[3].tolist() == [[1, 1, 0, 0]]
    assert kernels.launch_counts() == {k: 0 for k in kernels.launch_counts()}
    assert set(kernels.launch_counts()) == {
        "frontier_masks", "frontier_hop", "frontier_fused_masks",
        "frontier_fused_hop", "frontier_deque_round", "counting_spmm",
        "minplus_spmv", "bfs_dense",
        "flash_attention", "flash_attention_sm90", "decode_attention"}
    assert _build._loaded == loaded        # nothing was built or loaded
    with pytest.raises(TypeError):
        fe.frontier_masks(paths.long(), begin, end, dst, meta, max_deg=1)
    with pytest.raises(TypeError):
        fe.frontier_fused_masks(paths, rank.long(), tv, dv, [begin], [end],
                                [dst], max_deg=1)
    with pytest.raises(ValueError):
        fe.frontier_fused_masks(paths, rank, tv, dv, [begin], [], [dst],
                                max_deg=1)


def _stacked(params):
    """A dense config's port parameters as ``repro``'s numpy tree (the
    layers stacked in ``supers["b0_attn"]``)."""
    layers = params["layers"]
    tree = {k: params[k].numpy() for k in ("embed", "final_norm", "head")
            if k in params}
    tree["supers"] = {"b0_attn": {
        "ln1": np.stack([b["ln1"].numpy() for b in layers]),
        "ln2": np.stack([b["ln2"].numpy() for b in layers]),
        "attn": {n: np.stack([b["attn"][n].numpy() for b in layers])
                 for n in ("wq", "wk", "wv", "wo")},
        "mlp": {n: np.stack([b["mlp"][n].numpy() for b in layers])
                for n in ("w_gate", "w_up", "w_down")}}}
    return tree


def test_lm_entry_points_default_to_cuda():
    """``init_params``, ``params_from_numpy``, ``init_cache``,
    ``cache_from_numpy``, ``ServeEngine`` and the serve launcher run on
    the card by default and raise without one."""
    cfg = get_arch("internlm2_1p8b").reduced()
    cpu = init_params(cfg, 0, device="cpu")
    tree = _stacked(cpu)
    shape = (cfg.num_layers, 1, 4, cfg.kv_heads, cfg.hd)
    ctree = {"supers": {"b0_attn": (np.zeros(shape, np.float32),
                                    np.zeros(shape, np.float32))}}
    if torch.cuda.is_available():
        params = params_from_numpy(cfg, tree)
        assert params["embed"].is_cuda and init_params(cfg, 0)["embed"].is_cuda
        assert init_cache(cfg, 1, 4)["k"].is_cuda
        assert cache_from_numpy(cfg, ctree)["v"].is_cuda
        assert ServeEngine(cfg, params).cache["k"].is_cuda
        return
    for call in (lambda: init_params(cfg, 0),
                 lambda: params_from_numpy(cfg, tree),
                 lambda: init_cache(cfg, 1, 4),
                 lambda: cache_from_numpy(cfg, ctree),
                 lambda: ServeEngine(cfg, cpu),
                 lambda: serve_main(["--requests", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    back = params_from_numpy(cfg, tree, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        (back["embed"], back["layers"][2]["mlp"]["w_up"]),
        (cpu["embed"], cpu["layers"][2]["mlp"]["w_up"])))


def test_training_entry_points_default_to_cuda():
    """``Trainer``, ``PathCorpus``, ``adamw.state_from_numpy`` and the
    train launcher run on the card by default and raise without one; the
    import scan covers the training modules."""
    from repro_torch.data.pipeline import PathCorpus
    from repro_torch.launch.train import main as train_main
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import Trainer, TrainerConfig

    names = {p.relative_to(REPO).as_posix() for p in _port_files()}
    assert {f"src/repro_torch/{m}.py" for m in (
        "optim/adamw", "training/trainer", "training/step",
        "checkpoint/manager", "data/pipeline", "launch/train",
        "tree")} <= names
    cfg = get_arch("llama3p2_1b").reduced()
    g = tc.erdos_renyi(40, 4.0, seed=7)
    cpu = init_params(cfg, 0, device="cpu")
    state = adamw.init(cpu)
    nstate = adamw.AdamWState(step=np.int32(2), mu=_stacked(cpu),
                              nu=_stacked(cpu))
    if torch.cuda.is_available():
        assert Trainer(cfg, adamw.OptimizerConfig(),
                       TrainerConfig()).device.type == "cuda"
        assert PathCorpus(g, 4, 16, 2).device.type == "cuda"
        assert adamw.state_from_numpy(cfg, nstate).step.is_cuda
        return
    assert TrainerConfig().device == "cuda"
    for call in (lambda: Trainer(cfg, adamw.OptimizerConfig(),
                                 TrainerConfig()),
                 lambda: PathCorpus(g, 4, 16, 2),
                 lambda: adamw.state_from_numpy(cfg, nstate),
                 lambda: train_main(["--steps", "1"]),
                 lambda: train_main(["--steps", "1", "--data",
                                     "path_corpus"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    back = adamw.state_from_numpy(cfg, nstate, device="cpu")
    assert int(back.step) == 2 and back.step.dtype == torch.int32
    assert torch.equal(back.mu["layers"][1]["mlp"]["w_up"],
                       cpu["layers"][1]["mlp"]["w_up"])
    assert state.step.device.type == "cpu"


def test_hcpe_front_ends_default_to_cuda():
    """Both front-ends' default engine is the port's: ``backend="device"``
    on ``device="cuda"``; without a card a default construction raises
    and nothing falls back to a CPU engine."""
    g = tc.erdos_renyi(40, 4.0, seed=7)
    reg = GraphRegistry(g)
    if torch.cuda.is_available():
        for srv in (HcPEServer(g), AsyncHcPEServer(reg)):
            assert srv.engine.device.type == "cuda"
            assert srv.engine.engine.backend == "device"
        return
    for call in (lambda: HcPEServer(g), lambda: AsyncHcPEServer(g),
                 lambda: HcPEServer(reg, backend="host"),
                 lambda: AsyncHcPEServer(reg, sharing="off")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert reg.graph_ids() == ("default",) and len(reg._engines) == 0
    srv = AsyncHcPEServer(g, device="cpu")
    assert srv.engine.device.type == "cpu"
    assert srv.engine.engine.backend == "device"
    eng = tc.BatchPathEnum(device="cpu", backend="host")
    assert HcPEServer(g, eng).engine is eng


def test_kernel_library_loads_once_under_racing_threads(monkeypatch,
                                                       tmp_path):
    """The async server's worker threads may be a kernel's first users:
    ``_build.load`` builds and loads each library once however many
    threads race to it (the build and the load are faked here)."""
    import threading
    import time

    lib = tmp_path / "libfake.so"
    builds, loads = [], []

    def fake_build_all():
        time.sleep(0.01)
        builds.append(1)
        lib.write_bytes(b"")
        return {}

    def fake_cdll(path):
        time.sleep(0.005)
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "lib_path", lambda name: lib)
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(
            _build.load("frontier"))) for _ in range(4 * (os.cpu_count() or 2))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(got) == len(threads) and len({id(x) for x in got}) == 1
    assert len(builds) == 1 and len(loads) == 1


# calls an ``async def`` body of the serving layer must not make: a
# blocking sleep, the engine itself (it belongs in the worker thread),
# and every read that syncs the card
BLOCKING_ATTRS = ("sleep", "item", "cpu", "numpy", "tolist", "synchronize")


def _blocking_calls(fn):
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        name = ast.unparse(func)
        if isinstance(func, ast.Attribute) and (
                func.attr in BLOCKING_ATTRS and name != "asyncio.sleep"
                or name.endswith("engine.run")):
            yield f"{fn.name}:{node.lineno} calls {name}"


def test_async_serving_bodies_do_not_block_the_loop():
    files = sorted((REPO / "src" / "repro_torch" / "serving").glob("*.py"))
    bad, bodies = [], 0
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for fn in ast.walk(tree):
            if isinstance(fn, ast.AsyncFunctionDef):
                bodies += 1
                bad += [f"{path.name} {hit}" for hit in _blocking_calls(fn)]
    assert bodies >= 8, bodies        # the async server's coroutines
    assert not bad, bad
    # the scan sees what it is meant to catch
    probe = ast.parse("async def f(self):\n    time.sleep(1)\n"
                      "    x.item()\n    self.engine.run(g, q)\n"
                      "    torch.cuda.synchronize()\n"
                      "    await asyncio.sleep(0)\n").body[0]
    assert len(list(_blocking_calls(probe))) == 4


def _run_smoke(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_cuda_or_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run_smoke(REPO, env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path, dict(os.environ))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert np.array_equal(sorted(p.name for p in tmp_path.iterdir()),
                          ["chip_smoke.py"])


MESH_MODULES = ("compat.py", "distributed/__init__.py",
                "distributed/engine.py", "distributed/compression.py",
                "distributed/wire.py", "distributed/sharding.py",
                "distributed/constraints.py", "launch/mesh.py",
                "launch/specs.py", "launch/dryrun.py")


def test_mesh_entry_points_default_to_cuda():
    """``make_mesh``, ``DistributedPathEnum`` and the router's default
    engine run on the card by default; without one each raises before a
    process group is made, and the probe says what is missing."""
    caps = compat.probe()
    assert caps.gloo
    if torch.cuda.is_available():
        assert caps.device_name == torch.cuda.get_device_name(0)
        assert caps.sm90 == (caps.compute_capability == (9, 0))
        return
    assert (caps.cuda, caps.device_name, caps.compute_capability,
            caps.sm90) == (False, None, None, False)
    g = tc.erdos_renyi(40, 4.0, seed=7)
    for call in (lambda: compat.make_mesh((1, 1), ("data", "model")),
                 lambda: compat.make_mesh((1, 1), ("data", "model"),
                                          backend="gloo"),
                 lambda: DistributedPathEnum(None, g, 4),
                 lambda: DistributedTenantRouter({})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="differ in length"):
        compat.make_mesh((1, 1), ("data",), device="cpu")
    assert not torch.distributed.is_initialized()


def test_mesh_modules_import_neither_jax_nor_repro():
    root = REPO / "src" / "repro_torch"
    for name in MESH_MODULES:
        tree = ast.parse((root / name).read_text(), filename=name)
        assert not set(_imported_roots(tree)) & set(FORBIDDEN), name
    probe = ("import sys, repro_torch.compat, repro_torch.distributed\n"
             "import repro_torch.distributed.sharding\n"
             "import repro_torch.distributed.constraints\n"
             "import repro_torch.launch.mesh, repro_torch.launch.specs\n"
             "import repro_torch.launch.dryrun\n"
             "bad = [m for m in sys.modules if m.split('.')[0] in "
             f"{FORBIDDEN!r}]\n"
             "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert res.returncode == 0, res.stderr[-2000:]


def test_lm_mesh_entry_points_default_to_cuda():
    """``make_local_mesh``, ``make_production_mesh`` and ``Trainer(mesh=)``
    run on the card by default and raise without one, leaving no process
    group behind."""
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    from repro_torch.optim import adamw
    from repro_torch.training.trainer import Trainer, TrainerConfig

    if torch.cuda.is_available():
        return
    cfg = get_arch("llama3p2_1b").reduced()
    for call in (make_local_mesh, make_production_mesh,
                 lambda: make_production_mesh(multi_pod=True),
                 lambda: Trainer(cfg, adamw.OptimizerConfig(),
                                 TrainerConfig(), mesh=object())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not torch.distributed.is_initialized()
