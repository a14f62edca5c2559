"""Training loop with fault tolerance, restart and straggler telemetry
(the port of ``repro.training.trainer``).

* **checkpoint/restart**: atomic checkpoints every ``ckpt_every`` steps;
  on (re)start the trainer resumes from the latest manifest, including
  the data stream's position (no sample skew after preemption).
* **emergency save**: SIGTERM triggers a final checkpoint.
* **elastic re-shard**: checkpoints are stored unsharded (every
  DTensor gathered to its full value); a restart may bring up a
  different mesh, and the restored tensors are distributed on it.
* **straggler telemetry**: each step's wall time feeds an EWMA; steps
  slower than ``straggler_factor`` times the EWMA are recorded with
  their index.

Everything lives on ``TrainerConfig.device`` (``"cuda"`` by default;
without a card it raises).  The step function is called as it is, with
no compilation.  A step is timed on the host's clock up to one
synchronisation, ``float(metrics["loss"])`` (``repro``'s
``block_until_ready``); nothing else in a step syncs.

``mesh`` (a ``DeviceMesh`` with ``repro``'s axis names, e.g.
``launch.mesh.make_local_mesh()``) lays the training state out as
``repro``'s docstring promises: parameters and AdamW state are DTensors
on ``shardings`` (a ``(param specs, opt specs)`` pair of spec trees;
by default ``distributed.sharding``'s rules), each batch is distributed
on ``batch_spec``, and the step runs under ``use_mesh``.  ``repro``'s
``Trainer`` takes the same two arguments and reads neither (ROADMAP.md
§3).  Without a mesh nothing changes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..distributed import constraints as con
from ..distributed import sharding as shard_mod
from ..models import transformer
from ..optim import adamw
from . import step as step_mod


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    microbatches: int = 1
    straggler_factor: float = 3.0
    seed: int = 0
    param_dtype: torch.dtype = torch.float32
    device: torch.device | str = "cuda"


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: adamw.OptimizerConfig,
                 tcfg: TrainerConfig, mesh=None, shardings=None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(tcfg.device)
        self.mesh = mesh
        self.shardings = shardings
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type}, trainer on "
                             f"{self.device}")
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.step_fn = step_mod.make_train_step(
            cfg, opt_cfg, microbatches=tcfg.microbatches)
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []

    # ------------------------------------------------------------------
    def _fresh_state(self):
        params = transformer.init_params(self.cfg, self.tcfg.seed,
                                         device=self.device,
                                         dtype=self.tcfg.param_dtype)
        return params, adamw.init(params)

    def state_specs(self, params, opt_state):
        """(param specs, opt specs): ``shardings``, or the rules'."""
        if self.shardings is not None:
            return self.shardings
        pspecs = shard_mod.param_shardings(self.mesh, self.cfg, params)
        return pspecs, shard_mod.opt_shardings(pspecs, opt_state)

    def place(self, params, opt_state):
        """Full tensors as the trainer holds them: DTensors on the
        mesh's layout, or as they are without a mesh."""
        if self.mesh is None:
            return params, opt_state
        pspecs, ospecs = self.state_specs(params, opt_state)
        return (shard_mod.distribute_tree(params, self.mesh, pspecs),
                shard_mod.distribute_tree(opt_state, self.mesh, ospecs))

    def init_state(self):
        """Fresh parameters from ``tcfg.seed`` and a fresh AdamW state,
        placed on the mesh if there is one."""
        return self.place(*self._fresh_state())

    def restore_or_init(self):
        """(params, opt_state, start step): the latest checkpoint's, or a
        fresh state at step 0, placed on the mesh if there is one.  A
        checkpoint holds full tensors, so it restores on any mesh."""
        params, opt_state = self.init_state()
        start_step = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                trees, manifest = self.ckpt.restore(
                    latest, {"params": params, "opt": opt_state})
                params, opt_state = self.place(trees["params"],
                                               trees["opt"])
                start_step = manifest["step"]
        return params, opt_state, start_step

    def _batch(self, arrays):
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in arrays.items()}
        if self.mesh is None:
            return batch
        return shard_mod.distribute_tree(
            batch, self.mesh, shard_mod.batch_shardings(self.mesh, batch))

    # ------------------------------------------------------------------
    def fit(self, data, start_step: Optional[int] = None):
        """Train from the restored (or given) step to ``tcfg.steps`` on
        ``data.batch_at(step)``; returns the final (params, opt_state)."""
        params, opt_state, resumed = self.restore_or_init()
        step0 = resumed if start_step is None else start_step

        if self.ckpt is not None:
            state_ref: Dict[str, Any] = {"params": params, "opt": opt_state,
                                         "step": step0}
            self.ckpt.install_signal_handler(
                lambda: self.ckpt.save(state_ref["step"],
                                       {"params": state_ref["params"],
                                        "opt": state_ref["opt"]},
                                       extra={"emergency": True}))

        ewma = None
        for step in range(step0, self.tcfg.steps):
            batch = self._batch(data.batch_at(step))
            t0 = time.perf_counter()
            with con.use_mesh(self.mesh):
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > self.tcfg.straggler_factor * ewma and step > step0 + 3:
                self.straggler_steps.append(step)

            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps - 1:
                self.metrics_log.append({
                    "step": step, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "lr": float(metrics["lr"]), "sec_per_step": dt})

            if self.ckpt is not None:
                state_ref = {"params": params, "opt": opt_state,
                             "step": step + 1}
                if (step + 1) % self.tcfg.ckpt_every == 0:
                    self.ckpt.save(step + 1,
                                   {"params": params, "opt": opt_state},
                                   extra={"data_step": step + 1})

        if self.ckpt is not None:
            self.ckpt.save(self.tcfg.steps,
                           {"params": params, "opt": opt_state},
                           extra={"data_step": self.tcfg.steps,
                                  "final": True})
        return params, opt_state
