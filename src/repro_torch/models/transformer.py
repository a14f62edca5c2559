"""The decoder for the dense family (the port of
``repro.models.transformer``): ``forward`` for whole sequences,
``prefill`` and ``decode_step`` for serving.

Parameters are a plain dict with a list of per-layer dicts:
``{"embed", "final_norm", "head" (untied only), "layers": [{"ln1",
"attn": {"wq", "wk", "wv", "wo"}, "ln2", "mlp": {"w_gate", "w_up",
"w_down"}}, ...]}``, weights in ``repro``'s (d_in, d_out) layout.  A dict
rather than an ``nn.ModuleList``: it is ``repro``'s pytree with the
``supers`` axis unstacked, so ``params_from_numpy`` is a one-to-one map
and both packages compute the same products; serving needs no autograd
or module state.  ``repro``'s ``lax.scan`` over layers is a Python loop.

The KV cache is ``{"k": (layers, B, S, Hkv, hd), "v": ...}``; each
layer's slice is contiguous, the layout K7 reads.  ``decode_step``
writes into it in place and returns the same dict.

The moe, ssm, hybrid, vlm and audio families raise NotImplementedError:
they wait for ROADMAP queue 1, item 9.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from . import attention as attn_mod
from .layers import init_dense, rms_norm, swiglu

Params = Dict[str, Any]


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP queue 1, item 9); the port runs the dense family")


def layer_plan(cfg: ArchConfig) -> Tuple[Tuple[str, ...], int,
                                         Tuple[str, ...]]:
    """(super_pattern, num_supers, tail_pattern), ``repro``'s layer layout."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return ("ssm",), L, ()
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("rec", "rec", "attn")
        ns = L // len(pat)
        return pat, ns, tuple(pat[: L - ns * len(pat)])
    if cfg.family == "moe":
        pat = tuple("moe" if i == 0 else "dense"
                    for i in range(cfg.moe_every))
        ns = L // len(pat)
        return pat, ns, tuple(pat[: L - ns * len(pat)])
    return ("attn",), L, ()


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def init_params(cfg: ArchConfig, seed: int,
                device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters from ``seed`` on ``device`` at ``repro``'s scales
    (normal embedding of std 0.02, dense weights of std
    ``1 / sqrt(fan_in)``, zero norms), drawn from a ``torch.Generator``
    there; the numbers differ from ``jax.random``'s."""
    _require_dense(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    d, v, f = cfg.d_model, cfg.vocab, cfg.d_ff
    params: Params = {
        "embed": init_dense((v, d), gen, scale=0.02, dtype=dtype),
        "final_norm": torch.zeros(d, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_dense((d, v), gen, dtype=dtype)
    params["layers"] = [{
        "ln1": torch.zeros(d, dtype=dtype, device=dev),
        "attn": attn_mod.init_attention(cfg, gen, dtype),
        "ln2": torch.zeros(d, dtype=dtype, device=dev),
        "mlp": {"w_gate": init_dense((d, f), gen, dtype=dtype),
                "w_up": init_dense((d, f), gen, dtype=dtype),
                "w_down": init_dense((f, d), gen, dtype=dtype)},
    } for _ in range(cfg.num_layers)]
    return params


def params_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                      device: torch.device | str = "cuda") -> Params:
    """``repro``'s parameter pytree, as numpy arrays, as the port's
    parameters: the stacked ``supers["b0_attn"]`` arrays are split into
    one dict per layer, every weight kept in its (d_in, d_out) layout."""
    _require_dense(cfg)
    dev = resolve_device(device)

    def t(x: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(x)).to(dev)

    stacked = tree["supers"]["b0_attn"]
    params: Params = {"embed": t(tree["embed"]),
                      "final_norm": t(tree["final_norm"])}
    if not cfg.tie_embeddings:
        params["head"] = t(tree["head"])
    params["layers"] = [{
        "ln1": t(stacked["ln1"][i]),
        "attn": {n: t(stacked["attn"][n][i])
                 for n in ("wq", "wk", "wv", "wo")},
        "ln2": t(stacked["ln2"][i]),
        "mlp": {n: t(stacked["mlp"][n][i])
                for n in ("w_gate", "w_up", "w_down")},
    } for i in range(cfg.num_layers)]
    return params


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda") -> Dict[str, torch.Tensor]:
    """A zero KV cache, ``{"k", "v"}`` of (layers, batch, S, Hkv, hd) with
    ``S = max_len`` (``min(max_len, window)`` for windowed attention)."""
    _require_dense(cfg)
    dev = resolve_device(device)
    S = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
    shape = (cfg.num_layers, batch, S, cfg.kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                     device: torch.device | str = "cuda"
                     ) -> Dict[str, torch.Tensor]:
    """``repro``'s cache pytree (``{"supers": {"b0_attn": (k, v)}}`` with
    (layers, B, S, Hkv, hd) arrays) as the port's ``{"k", "v"}``."""
    _require_dense(cfg)
    dev = resolve_device(device)
    k, v = tree["supers"]["b0_attn"]
    return {"k": torch.from_numpy(np.array(k)).to(dev),
            "v": torch.from_numpy(np.array(v)).to(dev)}


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _block(blk: Params, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, impl: Optional[str]):
    """One dense layer over a sequence; returns (x, (k, v))."""
    h = rms_norm(x, blk["ln1"], cfg.norm_eps)
    o, kv = attn_mod.attention(blk["attn"], h, cfg, positions, impl=impl,
                               window=cfg.attn_window or None)
    x = x + o
    x = x + swiglu(rms_norm(x, blk["ln2"], cfg.norm_eps), **blk["mlp"])
    return x, kv


def forward_hidden(params: Params, cfg: ArchConfig,
                   batch: Dict[str, torch.Tensor], *,
                   impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backbone only: batch["tokens"] (B, S) -> final hidden (B, S, D)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    for blk in params["layers"]:
        x, _ = _block(blk, x, cfg, positions, impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {}


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-sequence forward: batch["tokens"] (B, S) -> logits (B, S, V)."""
    x, aux = forward_hidden(params, cfg, batch, impl=impl)
    return x @ _head(params, cfg), aux


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, impl: Optional[str] = None):
    """Prefill: returns (logits of the last position (B, 1, V), the KV
    cache ``{"k", "v"}`` of (layers, B, S, Hkv, hd), lengths (B,) int32)."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = params["embed"][tokens]
    B, S = tokens.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    ks, vs = [], []
    for blk in params["layers"]:
        x, (k, v) = _block(blk, x, cfg, positions, impl)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}, lengths


def _decode_block(blk: Params, x_t: torch.Tensor, cfg: ArchConfig,
                  cache: Tuple[torch.Tensor, torch.Tensor],
                  pos: torch.Tensor, impl: Optional[str]) -> torch.Tensor:
    """x_t (B, D); cache (k, v) of (B, S, Hkv, hd), written in place; pos
    (B,) current lengths."""
    h = rms_norm(x_t, blk["ln1"], cfg.norm_eps)
    window = cfg.attn_window or None
    if window:
        S = cache[0].shape[1]
        slot = pos % S                  # ring buffer: cache == window
        valid = torch.clamp(pos + 1, max=S)
    else:
        slot, valid = pos, None
    o, _ = attn_mod.attention(blk["attn"], h[:, None], cfg, pos[:, None],
                              impl=impl, window=window, kv_cache=cache,
                              cache_len=slot, valid_len=valid)
    x_t = x_t + o[:, 0]
    return x_t + swiglu(rms_norm(x_t, blk["ln2"], cfg.norm_eps), **blk["mlp"])


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, torch.Tensor], cache_len: torch.Tensor, *,
                impl: Optional[str] = None):
    """One decode step.  token (B,) integer; cache_len (B,) int32 current
    lengths.  Writes this token's K and V into ``cache`` in place and
    returns (logits (B, V), cache)."""
    _require_dense(cfg)
    x = params["embed"][token]
    for i, blk in enumerate(params["layers"]):
        x = _decode_block(blk, x, cfg, (cache["k"][i], cache["v"][i]),
                          cache_len, impl)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), cache
