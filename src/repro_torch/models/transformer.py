"""The decoder for every family (the port of
``repro.models.transformer``): ``forward`` for whole sequences,
``prefill`` and ``decode_step`` for serving, over dense, vlm, audio,
moe, ssm and hybrid configs.

Layers.  ``repro`` scans over super-blocks (the smallest repeating
group of layer kinds, ``layer_plan``) plus a tail; the port flattens
that plan (``layer_kinds``: for each super-block the pattern, then the
tail) and runs a Python loop over one list of per-layer dicts.  A
layer's kind comes from the config alone, never from the parameters:
``attn`` (dense, vlm, audio and hybrid attention), ``moe`` and ``dense``
(the moe family's two attention layers), ``rec`` (RG-LRU) and ``ssm``
(Mamba-2).

Parameters are a plain dict: ``{"embed", "final_norm", "head" (untied
only), "frontend_proj" (vlm and audio), "layers": [block, ...]}``, each
block holding ``repro``'s sub-dicts for its kind (``ln1``, ``attn``,
``ln2``, ``mlp``; ``moe`` in place of ``mlp``; ``rec`` in place of
``attn``; ``ssm`` with ``ln1`` alone), weights in (d_in, d_out) layout.
A dict rather than an ``nn.ModuleList``: it is ``repro``'s pytree with
the super-block axis unstacked, so ``params_from_numpy`` is a one-to-one
map and both packages compute the same products; serving needs no
autograd or module state.  The leaves named in ``FLOAT32_LEAVES`` stay
float32 whatever ``dtype`` is, as in ``repro``.

The cache holds ``"k"`` and ``"v"`` of (attention layers, B, S, Hkv, hd)
when the model has attention layers (each layer's slice contiguous, the
layout K7 reads), and ``"rec"`` or ``"ssm"``, a (conv window, h) pair
stacked over the layers of that kind: (layers, B, W-1, C) in the cache's
dtype and h float32.  Every cache tensor has the layer axis first and
the batch second.  ``decode_step`` writes into it in place and returns
the same dict; its ``commit`` mask keeps chosen rows' recurrent states
as they were (the serving engine's prompt replay).

``loss_fn`` is ``repro``'s cross entropy over ``forward_hidden`` on the
plain attention path (``impl="xla"``, ``repro``'s training path: the
kernels have no backward).  With ``cfg.remat`` (the default) and grad
enabled, ``forward_hidden`` runs each layer under
``torch.utils.checkpoint``, the counterpart of ``jax.checkpoint`` on
``repro``'s scan body: the same values, activations recomputed in the
backward; under ``torch.no_grad`` nothing changes.

On a mesh (``distributed.constraints.use_mesh``, the parameters, caches
and batch distributed by ``distributed.sharding``) every function runs
on DTensors and carries ``repro``'s sharding constraints at ``repro``'s
call sites: ``act_bsd`` on the embedding and in the loss, ``act_bsd_sp``
at each layer of ``forward_hidden`` under ``cfg.seq_shard_activations``,
``logits_bsv`` on the loss's logits.  Outside a mesh they do nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..distributed import constraints as con
from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import MetaGenerator, init_dense, rms_norm, swiglu, take_rows

Params = Dict[str, Any]

ATTN_KINDS = ("attn", "moe", "dense")
# leaves that stay float32 whatever the parameters' dtype (repro's)
FLOAT32_LEAVES = ("router", "A_log", "D", "dt_bias", "lam")


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


def layer_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    """Every layer's kind in order: the pattern once per super-block,
    then the tail."""
    pat, ns, tail = layer_plan(cfg)
    return pat * ns + tail


def _plan_slots(cfg: ArchConfig) -> Iterator[Tuple[str, str, str,
                                                   Optional[int]]]:
    """(kind, ``repro`` group, block name, super-block index or None) for
    every layer in order: where ``repro``'s trees keep that layer."""
    pat, ns, tail = layer_plan(cfg)
    for si in range(ns):
        for j, kind in enumerate(pat):
            yield kind, "supers", f"b{j}_{kind}", si
    for j, kind in enumerate(tail):
        yield kind, "tail", f"b{j}_{kind}", None


def _layers(params: Params, cfg: ArchConfig) -> List[Tuple[str, Params]]:
    kinds = layer_kinds(cfg)
    if len(params["layers"]) != len(kinds):
        raise ValueError(f"{cfg.name}: {len(params['layers'])} parameter "
                         f"layers for a plan of {len(kinds)}")
    return list(zip(kinds, params["layers"]))


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def _init_mlp(cfg: ArchConfig, gen: torch.Generator,
              dtype: torch.dtype) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": init_dense((d, f), gen, dtype=dtype),
            "w_up": init_dense((d, f), gen, dtype=dtype),
            "w_down": init_dense((f, d), gen, dtype=dtype)}


def _init_block(cfg: ArchConfig, kind: str, gen: torch.Generator,
                dtype: torch.dtype) -> Params:
    def norm() -> torch.Tensor:
        return torch.zeros(cfg.d_model, dtype=dtype, device=gen.device)

    blk: Params = {"ln1": norm()}
    if kind == "ssm":
        blk["ssm"] = ssm_mod.init_ssm(cfg, gen, dtype)
        return blk                        # Mamba-2 blocks have no MLP
    if kind in ATTN_KINDS:
        blk["attn"] = attn_mod.init_attention(cfg, gen, dtype)
    elif kind == "rec":
        blk["rec"] = rglru_mod.init_rglru(cfg, gen, dtype)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    blk["ln2"] = norm()
    if kind == "moe":
        blk["moe"] = moe_mod.init_moe(cfg, gen, dtype)
    else:
        blk["mlp"] = _init_mlp(cfg, gen, dtype)
    return blk


def init_params(cfg: ArchConfig, seed: int,
                device: torch.device | str = "cuda",
                dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters from ``seed`` on ``device`` at ``repro``'s scales
    (normal embedding of std 0.02, dense weights of std
    ``1 / sqrt(fan_in)``, zero norms), drawn from a ``torch.Generator``
    there; the numbers differ from ``jax.random``'s.  On ``"meta"`` the
    tensors have shapes and dtypes only (the dry run's stand-ins)."""
    dev = resolve_device(device)
    if dev.type == "meta":
        gen = MetaGenerator()
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    d, v = cfg.d_model, cfg.vocab
    params: Params = {
        "embed": init_dense((v, d), gen, scale=0.02, dtype=dtype),
        "final_norm": torch.zeros(d, dtype=dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_dense((d, v), gen, dtype=dtype)
    if cfg.frontend != "none":
        params["frontend_proj"] = init_dense((d, d), gen, dtype=dtype)
    params["layers"] = [_init_block(cfg, kind, gen, dtype)
                        for kind in layer_kinds(cfg)]
    return params


def params_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                      device: torch.device | str = "cuda") -> Params:
    """``repro``'s parameter pytree, as numpy arrays, as the port's
    parameters: each layer's slice of ``supers["b{j}_{kind}"]`` (or its
    ``tail["b{j}_{kind}"]`` block) becomes one layer dict, every weight
    kept in its (d_in, d_out) layout and dtype."""
    dev = resolve_device(device)

    def t(x: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(x)).to(dev)

    def block(node: Any, si: Optional[int]) -> Any:
        if isinstance(node, dict):
            return {k: block(v, si) for k, v in node.items()}
        return t(node if si is None else np.asarray(node)[si])

    params: Params = {k: t(tree[k]) for k in ("embed", "final_norm",
                                               "head", "frontend_proj")
                      if k in tree}
    params["layers"] = [block(tree[group][name], si)
                        for _kind, group, name, si in _plan_slots(cfg)]
    return params


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda") -> Dict[str, Any]:
    """A zero cache (module docstring): ``"k"``, ``"v"`` with ``S =
    max_len`` (``min(max_len, window)`` for windowed attention), and the
    recurrent states of the ``rec`` or ``ssm`` layers."""
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    cache: Dict[str, Any] = {}
    n_attn = sum(kind in ATTN_KINDS for kind in kinds)
    if n_attn:
        S = min(max_len, cfg.attn_window) if cfg.attn_window else max_len
        shape = (n_attn, batch, S, cfg.kv_heads, cfg.hd)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    for kind, init in (("rec", rglru_mod.init_rglru_state),
                       ("ssm", ssm_mod.init_ssm_state)):
        n = kinds.count(kind)
        if n:
            one = init(cfg, batch, dtype, dev)
            cache[kind] = tuple(x.new_zeros((n,) + x.shape) for x in one)
    return cache


def cache_from_numpy(cfg: ArchConfig, tree: Dict[str, Any],
                     device: torch.device | str = "cuda") -> Dict[str, Any]:
    """``repro``'s cache pytree (per block name a (k, v) or (conv, h)
    pair, stacked over super-blocks in ``supers``, unstacked in
    ``tail``) as the port's cache."""
    dev = resolve_device(device)
    per_kind: Dict[str, List[Tuple[np.ndarray, ...]]] = {}
    for kind, group, name, si in _plan_slots(cfg):
        pair = tuple(np.asarray(x) if si is None else np.asarray(x)[si]
                     for x in tree[group][name])
        per_kind.setdefault("kv" if kind in ATTN_KINDS else kind,
                            []).append(pair)

    def stacked(pairs, j):
        return torch.from_numpy(np.stack([p[j] for p in pairs])).to(dev)

    cache: Dict[str, Any] = {}
    if "kv" in per_kind:
        cache["k"], cache["v"] = (stacked(per_kind["kv"], j) for j in (0, 1))
    for kind in ("rec", "ssm"):
        if kind in per_kind:
            cache[kind] = (stacked(per_kind[kind], 0),
                           stacked(per_kind[kind], 1))
    return cache


def cache_tensors(cache: Dict[str, Any]) -> Iterator[torch.Tensor]:
    """Every tensor of a cache; each has the layer axis first and the
    batch second."""
    for entry in cache.values():
        yield from (entry if isinstance(entry, tuple) else (entry,))


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

def _head(params: Params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def _embed(params: Params, cfg: ArchConfig,
           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token embeddings; for vlm and audio the first P positions are
    replaced by ``batch["prefix_emb"]`` (B, P, D) through
    ``frontend_proj``, as ``repro`` does (computed in the promoted type of
    the two, like ``jnp.einsum``)."""
    x = take_rows(params["embed"], batch["tokens"])
    if cfg.frontend != "none" and "prefix_emb" in batch:
        proj = params["frontend_proj"]
        pre = batch["prefix_emb"]
        dt = torch.promote_types(pre.dtype, proj.dtype)
        pre = (pre.to(dt) @ proj.to(dt)).to(x.dtype)
        x = torch.cat([pre, x[:, pre.shape[1]:]], dim=1)
    return con.constrain(x, con.act_bsd)


def _block(blk: Params, kind: str, x: torch.Tensor, cfg: ArchConfig,
           positions: torch.Tensor, impl: Optional[str]):
    """One layer over a sequence; returns (x, (k, v) for an attention
    layer else None, the moe layer's balance aux else None)."""
    h = rms_norm(x, blk["ln1"], cfg.norm_eps)
    kv = bal = None
    if kind in ATTN_KINDS:
        o, kv = attn_mod.attention(blk["attn"], h, cfg, positions, impl=impl,
                                   window=cfg.attn_window or None)
        x = x + o
        h2 = rms_norm(x, blk["ln2"], cfg.norm_eps)
        if kind == "moe":
            o2, aux = moe_mod.moe_ffn(blk["moe"], h2, cfg)
            bal = aux["moe_balance"]
        else:
            o2 = swiglu(h2, **blk["mlp"])
        x = x + o2
    elif kind == "rec":
        x = x + rglru_mod.rglru_forward(blk["rec"], h, cfg)
        x = x + swiglu(rms_norm(x, blk["ln2"], cfg.norm_eps), **blk["mlp"])
    else:
        x = x + ssm_mod.ssd_forward(blk["ssm"], h, cfg)
    return x, kv, bal


def _positions(x: torch.Tensor) -> torch.Tensor:
    B, S = x.shape[:2]
    return torch.arange(S, device=x.device).expand(B, S)


def forward_hidden(params: Params, cfg: ArchConfig,
                   batch: Dict[str, torch.Tensor], *,
                   impl: Optional[str] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Backbone only: batch["tokens"] (B, S) (and ``prefix_emb`` for vlm
    and audio) -> final hidden (B, S, D), and ``{"moe_balance"}``, the
    sum of the moe layers' balance aux (a float32 0 without any), as
    ``repro``."""
    x = _embed(params, cfg, batch)
    positions = _positions(x)
    balance = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    # the backward may recompute a layer on another thread (CUDA's
    # autograd device threads), where the ambient mesh is not set: each
    # layer sets it itself
    mesh = con.current_mesh()
    for kind, blk in _layers(params, cfg):
        def layer(x, blk=blk, kind=kind):
            with con.use_mesh(mesh):
                if cfg.seq_shard_activations:
                    x = con.constrain(x, con.act_bsd_sp)
                x, _, bal = _block(blk, kind, x, cfg, positions, impl)
            return x, bal
        if remat:
            # the forward draws no random numbers: no RNG state to keep
            x, bal = checkpoint(layer, x, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, bal = layer(x)
        if bal is not None:
            balance = balance + bal
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, {"moe_balance": balance}


def forward(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Whole-sequence forward: batch["tokens"] (B, S) -> logits (B, S, V),
    and the aux of ``forward_hidden``."""
    x, aux = forward_hidden(params, cfg, batch, impl=impl)
    return x @ _head(params, cfg), aux


def loss_fn(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross entropy, ``repro``'s formulation: logsumexp over
    the float32 logits of positions ``:-1``, minus the label's logit as
    ⟨hidden, ``head.T[label]``⟩, averaged over the positions whose label
    is not negative; the moe family adds ``0.01 · moe_balance /
    num_layers``.  Returns ``(loss, {"loss", "tokens"})``, ``tokens`` the
    float32 count of labelled positions."""
    x, aux = forward_hidden(params, cfg, batch, impl="xla")
    labels = batch["labels"]
    head = _head(params, cfg)

    xs = con.constrain(x[:, :-1].to(torch.float32), con.act_bsd)
    logits = con.constrain(xs @ head.to(torch.float32), con.logits_bsv)
    lse = torch.logsumexp(logits, dim=-1)                    # (B, S-1)

    safe = torch.clamp(labels[:, 1:], min=0).long()
    rows = con.constrain(take_rows(head.T, safe).to(torch.float32),
                         con.act_bsd)
    lbl_logit = (xs * rows).sum(-1)

    mask = (labels[:, 1:] >= 0).to(torch.float32)
    loss = ((lse - lbl_logit) * mask).sum() / torch.clamp(mask.sum(),
                                                          min=1.0)
    if cfg.family == "moe":
        loss = loss + 0.01 * aux["moe_balance"] / max(cfg.num_layers, 1)
    return loss, {"loss": loss, "tokens": mask.sum()}


def prefill(params: Params, cfg: ArchConfig, batch: Dict[str, torch.Tensor],
            *, impl: Optional[str] = None):
    """Prefill: returns (logits of the last position (B, 1, V), the
    attention layers' K/V ``{"k", "v"}`` of (attention layers, B, S, Hkv,
    hd), empty for a model without attention; lengths (B,) int32).  The
    ``rec`` and ``ssm`` layers return no state, as in ``repro``.  Every
    layer runs, the tail's too: ``repro``'s prefill skips the tail
    (ROADMAP.md §3)."""
    x = _embed(params, cfg, batch)
    positions = _positions(x)
    ks, vs = [], []
    for kind, blk in _layers(params, cfg):
        x, kv, _ = _block(blk, kind, x, cfg, positions, impl)
        if kv is not None:
            ks.append(kv[0])
            vs.append(kv[1])
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = x @ _head(params, cfg)
    B, S = x.shape[0], positions.shape[1]
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if ks else {}
    return logits, cache, lengths


def _decode_attention(blk: Params, h: torch.Tensor, cfg: ArchConfig,
                      cache: Tuple[torch.Tensor, torch.Tensor],
                      pos: torch.Tensor, impl: Optional[str]) -> torch.Tensor:
    """h (B, D); cache (k, v) of (B, S, Hkv, hd), written in place; pos
    (B,) current lengths.  Returns the attention output (B, D)."""
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
    return o[:, 0]


def _store(dst: torch.Tensor, new: torch.Tensor,
           commit: Optional[torch.Tensor]) -> None:
    """Write a layer's new state into the cache, only in the rows where
    ``commit`` (B,) is true when it is given."""
    if commit is not None:
        new = torch.where(commit.view((-1,) + (1,) * (new.dim() - 1)), new,
                          dst)
    dst.copy_(new)


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: Dict[str, Any], cache_len: torch.Tensor, *,
                impl: Optional[str] = None,
                commit: Optional[torch.Tensor] = None):
    """One decode step.  token (B,) integer; cache_len (B,) int32 current
    lengths.  Writes this token's K and V, and the recurrent layers' new
    states, into ``cache`` in place and returns (logits (B, V), cache).
    ``commit`` (B,) bool, if given, limits the recurrent states' writes
    to its true rows, the others left bit for bit as they were; K and V
    are written in every row (a row at or past a slot's length, which its
    own next step rewrites before reading)."""
    x = take_rows(params["embed"], token)
    seen = {"attn": 0, "rec": 0, "ssm": 0}
    for kind, blk in _layers(params, cfg):
        h = rms_norm(x, blk["ln1"], cfg.norm_eps)
        if kind in ATTN_KINDS:
            i = seen["attn"]
            x = x + _decode_attention(blk, h, cfg,
                                      (cache["k"][i], cache["v"][i]),
                                      cache_len, impl)
            seen["attn"] += 1
            h2 = rms_norm(x, blk["ln2"], cfg.norm_eps)
            if kind == "moe":
                o2 = moe_mod.moe_ffn(blk["moe"], h2[:, None], cfg,
                                     decode=True)[0][:, 0]
            else:
                o2 = swiglu(h2, **blk["mlp"])
            x = x + o2
            continue
        i = seen[kind]
        conv, hs = cache[kind]
        step = rglru_mod.rglru_decode_step if kind == "rec" \
            else ssm_mod.ssd_decode_step
        o, (new_conv, new_h) = step(blk[kind], h, (conv[i], hs[i]), cfg)
        _store(conv[i], new_conv, commit)
        _store(hs[i], new_h, commit)
        seen[kind] += 1
        x = x + o
        if kind == "rec":
            x = x + swiglu(rms_norm(x, blk["ln2"], cfg.norm_eps),
                           **blk["mlp"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ _head(params, cfg), cache
