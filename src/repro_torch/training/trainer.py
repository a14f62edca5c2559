"""Training loop with fault tolerance, restart and straggler telemetry
(the port of ``repro.training.trainer``).

* **checkpoint/restart**: atomic checkpoints every ``ckpt_every`` steps;
  on (re)start the trainer resumes from the latest manifest, including
  the data stream's position (no sample skew after preemption).
* **emergency save**: SIGTERM triggers a final checkpoint.
* **straggler telemetry**: each step's wall time feeds an EWMA; steps
  slower than ``straggler_factor`` times the EWMA are recorded with
  their index.

Everything lives on ``TrainerConfig.device`` (``"cuda"`` by default;
without a card it raises).  The step function is called as it is, with
no compilation.  A step is timed on the host's clock up to one
synchronisation, ``float(metrics["loss"])`` (``repro``'s
``block_until_ready``); nothing else in a step syncs.  The mesh layout
of ``repro``'s trainer (``mesh``, ``shardings``) waits for the port's
sharding rules (ROADMAP queue 1, item 9.6).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.base import ArchConfig
from ..core.device import resolve_device
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
                 tcfg: TrainerConfig):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = resolve_device(tcfg.device)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.step_fn = step_mod.make_train_step(
            cfg, opt_cfg, microbatches=tcfg.microbatches)
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []

    # ------------------------------------------------------------------
    def init_state(self):
        """Fresh parameters from ``tcfg.seed`` and a fresh AdamW state."""
        params = transformer.init_params(self.cfg, self.tcfg.seed,
                                         device=self.device,
                                         dtype=self.tcfg.param_dtype)
        return params, adamw.init(params)

    def restore_or_init(self):
        """(params, opt_state, start step): the latest checkpoint's, or a
        fresh state at step 0."""
        params, opt_state = self.init_state()
        start_step = 0
        if self.ckpt is not None:
            latest = self.ckpt.latest_step()
            if latest is not None:
                trees, manifest = self.ckpt.restore(
                    latest, {"params": params, "opt": opt_state})
                params, opt_state = trees["params"], trees["opt"]
                start_step = manifest["step"]
        return params, opt_state, start_step

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
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in data.batch_at(step).items()}
            t0 = time.perf_counter()
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
