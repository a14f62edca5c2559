"""Serve and prefill step factories (the port of ``repro.training.step``).

``make_serve_step`` builds the single-token decode step used by the
serving engine: greedy (``argmax``) at temperature 0, else a sample from
``softmax(logits / temperature)`` drawn with ``torch.multinomial`` on the
caller's ``torch.Generator`` (its bits are not ``jax.random``'s).
``make_prefill`` wraps ``transformer.prefill`` (the batch's
``prefix_emb`` goes through with it).  Both pass ``impl`` down to the
attention layers (None: the kernels on a CUDA device, the plain path on
the CPU).  ``make_train_step`` and ``make_loss_fn`` wait for the
training slice (ROADMAP queue 1, item 9.4).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..configs.base import ArchConfig
from ..models import transformer


def make_serve_step(cfg: ArchConfig, temperature: float = 0.0, *,
                    impl: Optional[str] = None) -> Callable:
    """``serve_step(params, token, cache, cache_len, generator, commit)``
    -> (next tokens (B,) int32, cache, logits (B, V)); ``commit`` goes to
    ``transformer.decode_step``."""
    @torch.no_grad()
    def serve_step(params, token, cache, cache_len,
                   generator: Optional[torch.Generator] = None,
                   commit: Optional[torch.Tensor] = None):
        logits, cache = transformer.decode_step(params, cfg, token, cache,
                                                cache_len, impl=impl,
                                                commit=commit)
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), cache, logits
    return serve_step


def make_prefill(cfg: ArchConfig, *, impl: Optional[str] = None) -> Callable:
    """``prefill_step(params, batch)`` -> (last-position logits, cache,
    lengths), as ``transformer.prefill``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        return transformer.prefill(params, cfg, batch, impl=impl)
    return prefill_step
