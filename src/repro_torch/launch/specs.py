"""Stand-ins for every (arch × shape) cell on the meta device (the port
of ``repro.launch.specs``): tensors with ``repro``'s shapes and dtypes
and no storage, so the dry run allocates nothing.  Parameters and
caches come from the port's own ``init_params`` and ``init_cache``
under ``device="meta"``, in the port's layouts (per-layer parameter
dicts, caches stacked per layer kind).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..models import transformer
from ..optim import adamw

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Model inputs for the cell: the train or prefill batch, or the
    decode state (one new token against a ``seq_len``-deep cache)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32),
                 "labels": _meta((B, S), torch.int32)}
        if cfg.frontend != "none":
            batch["prefix_emb"] = _meta((B, cfg.frontend_len, cfg.d_model),
                                        dtype)
        if shape.kind == "prefill":
            batch.pop("labels")
        return {"batch": batch}
    return {
        "token": _meta((B,), torch.int32),
        "cache": transformer.init_cache(cfg, B, S, dtype=dtype, device=META),
        "cache_len": _meta((B,), torch.int32),
        "rng": _meta((2,), torch.uint32),
    }


def param_specs(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16):
    return transformer.init_params(cfg, 0, device=META, dtype=dtype)


def opt_specs(params_template):
    return adamw.init(params_template)
