"""AdamW, global-norm clipping and the warmup-cosine schedule (the port
of ``repro.optim.adamw``).

Plain tensor functions over a tree of parameters (``repro_torch.tree``:
the port's parameter dict), not ``torch.optim``: its AdamW applies the
decoupled weight decay before the Adam step, ``repro`` adds it to the
step (``delta = m̂ / (sqrt(v̂) + eps) + wd·p``).  The moments ``mu`` and
``nu`` are float32 whatever the parameters' dtype; every update is
computed in float32 and cast back to each leaf's dtype.  ``update``
returns new tensors and leaves its inputs as they were, as ``repro``'s
pure functions do.  On a mesh the leaves are DTensors, each gradient on
its parameter's placements: every update is elementwise on the local
shards, and ``global_norm`` reduces each leaf's sum to a replicated
scalar.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from .. import tree as tree_mod
from ..configs.base import ArchConfig
from ..distributed.sharding import replicate
from ..models import transformer

f32 = torch.float32


class AdamWState(NamedTuple):
    step: torch.Tensor          # int32, 0-d
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def cosine_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``min_lr_ratio · peak_lr`` at ``total_steps``; float32, on step's
    device."""
    step = step.to(f32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    mult = torch.where(step < cfg.warmup_steps, warm,
                       cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)
    return cfg.peak_lr * mult


def init(params) -> AdamWState:
    """Step 0 and zero float32 moments like each leaf (on its device, or
    its placements for a DTensor)."""
    def zeros(p):
        return torch.zeros_like(p, dtype=f32)
    first = tree_mod.leaves(params)[0]
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=first.device),
                      mu=tree_mod.tree_map(zeros, params),
                      nu=tree_mod.tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 squares summed leaf by leaf in tree order (a
    DTensor leaf's sum reduced over the mesh first)."""
    return torch.sqrt(sum(replicate(torch.sum(torch.square(x.to(f32))))
                          for x in tree_mod.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads in float32 scaled so their global norm is at most
    ``max_norm``, the norm before scaling)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_mod.tree_map(lambda g: g.to(f32) * scale, grads), norm


def update(cfg: OptimizerConfig, grads, state: AdamWState, params
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step: (new params in each leaf's dtype, the new state,
    ``{"lr", "grad_norm"}`` as 0-d tensors)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2

    mu = tree_mod.tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu,
                           grads)
    nu = tree_mod.tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                           state.nu, grads)
    bc1 = 1 - b1 ** step.to(f32)
    bc2 = 1 - b2 ** step.to(f32)

    def upd(p, m, v):
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(f32)
        return (p.to(f32) - lr * delta).to(p.dtype)

    new_params = tree_mod.tree_map(upd, params, mu, nu)
    return new_params, AdamWState(step=step, mu=mu, nu=nu), {
        "lr": lr, "grad_norm": gnorm}


def state_from_numpy(cfg: ArchConfig, state: Any,
                     device: torch.device | str = "cuda") -> AdamWState:
    """``repro``'s ``AdamWState`` (its leaves as numpy arrays) as the
    port's: ``step`` an int32 0-d tensor, and ``mu`` and ``nu``, which
    have the parameters' tree, through ``transformer.params_from_numpy``'s
    map."""
    mu = transformer.params_from_numpy(cfg, state.mu, device=device)
    nu = transformer.params_from_numpy(cfg, state.nu, device=device)
    step = torch.tensor(int(state.step), dtype=torch.int32,
                        device=mu["embed"].device)
    return AdamWState(step=step, mu=mu, nu=nu)
