"""Mamba-2 block, SSD (state-space duality, arXiv:2405.21060): the port
of ``repro.models.ssm``.

The chunked SSD algorithm: the sequence goes in chunks of ``ssm_chunk``;
within a chunk the output is a masked quadratic (attention-like) term,
and chunk to chunk a first-order recurrence over per-chunk states, a
Python loop over the chunks (``repro``'s ``lax.scan``).  Decode is the
recurrent form, h <- dA·h + dt·B·x, y = C·h + D·x.

``torch.einsum`` takes one dtype where ``jnp.einsum`` promotes, so the
casts follow jax's promotion: dt, the decays and h are float32, and a
product with one of them is float32.  ``A_log``, ``D`` and ``dt_bias``
stay float32 whatever the parameters' dtype, as in ``repro``.  On a
mesh the forward carries ``repro``'s constraints (``act_bsf`` on the
in-projection, ``act_bsd`` on the output), and the chunked core runs on
each rank's local shards through ``local_map`` laid out as ``repro``'s
``ssd_intra`` (heads over model): its heads are independent, and its
five-dimensional intermediates would cost DTensor's sharding search more
than the work.  No Pallas kernel here in ``repro``, so no CUDA kernel in
the port.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ArchConfig
from ..core.device import resolve_device
from ..distributed import constraints as con
from ..distributed.sharding import (ShardingRules, grad_placements,
                                    placements)
from .layers import (causal_conv1d, causal_conv1d_step, init_dense, pad_seq,
                     rms_norm)

f32 = torch.float32


def init_ssm(cfg: ArchConfig, generator: torch.Generator,
             dtype: torch.dtype = torch.float32) -> dict:
    """The in/out projections, the conv taps and the gated norm in
    ``dtype``; ``A_log`` (A = -exp(A_log)), ``D`` and ``dt_bias`` float32."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = generator.device
    return {
        # projections: [z (gate) | x | B | C | dt]
        "in_proj": init_dense((d, 2 * di + 2 * ns + nh), generator,
                              dtype=dtype),
        "out_proj": init_dense((di, d), generator, dtype=dtype),
        "conv_w": init_dense((di + 2 * ns, cfg.conv_width), generator,
                             scale=0.5, dtype=dtype),
        "A_log": torch.zeros(nh, dtype=f32, device=dev),
        "D": torch.ones(nh, dtype=f32, device=dev),
        "dt_bias": torch.zeros(nh, dtype=f32, device=dev),
        "norm": torch.zeros(di, dtype=dtype, device=dev),
    }


def _split_proj(cfg: ArchConfig, proj: torch.Tensor):
    di, ns = cfg.d_inner, cfg.ssm_state
    return (proj[..., :di], proj[..., di:2 * di + 2 * ns],
            proj[..., 2 * di + 2 * ns:])


def ssd_forward(params: dict, x: torch.Tensor,
                cfg: ArchConfig) -> torch.Tensor:
    """x (B, L, D) -> (B, L, D).  L is zero-padded up to a multiple of
    ``ssm_chunk`` and the pad cut off again (causal: the pad never
    reaches an earlier output)."""
    L, Q = x.shape[1], cfg.ssm_chunk
    Lp = -(-L // Q) * Q
    if Lp != L:
        x = pad_seq(x, Lp - L)
    return _ssd_forward_aligned(params, x, cfg)[:, :L]


def _masked_decay(decay: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """exp(decay) where ``keep``, else 0, with the mask on the exponent:
    the upper triangle's exp overflows to inf once a chunk's summed dt
    passes 88.7, and a where on exp's result (``repro``'s
    ``jnp.where(tri, jnp.exp(decay), 0)``) sends 0 · inf = NaN back
    through exp's gradient.  exp(-inf) is exactly 0 and the kept entries
    are the same, so the forward is bit-identical to ``repro``'s
    expression."""
    return torch.exp(torch.where(keep, decay, -torch.inf))


def _ssd_forward_aligned(params: dict, x: torch.Tensor,
                         cfg: ArchConfig) -> torch.Tensor:
    Bsz, L, _ = x.shape
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    Q = cfg.ssm_chunk

    proj = con.constrain(x @ params["in_proj"], con.act_bsf)
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = F.silu(causal_conv1d(xbc, params["conv_w"]))
    xs = xbc[..., :di].reshape(Bsz, L, nh, hd)
    Bv = xbc[..., di:di + ns]                                   # (B, L, N)
    Cv = xbc[..., di + ns:]                                     # (B, L, N)

    dt = F.softplus(dt.to(f32) + params["dt_bias"])             # (B, L, H)
    dA = dt * -torch.exp(params["A_log"])                       # log-decay

    if isinstance(xs, DTensor):
        y = _chunks_on_mesh(xs, Bv, Cv, dt, dA, params["D"], Q)
    else:
        y = _ssd_chunks(xs, Bv, Cv, dt, dA, params["D"], Q)
    y = y.reshape(Bsz, L, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return con.constrain(y @ params["out_proj"], con.act_bsd)


def _ssd_chunks(xs: torch.Tensor, Bv: torch.Tensor, Cv: torch.Tensor,
                dt: torch.Tensor, dA: torch.Tensor, D: torch.Tensor,
                Q: int) -> torch.Tensor:
    """The chunked SSD over xs (B, L, H, P) with Bv, Cv (B, L, N), dt and
    the log-decay dA (B, L, H) float32: y (B, L, H, P) float32, the D
    skip included.  Every head is independent of the others."""
    Bsz, L, nh, hd = xs.shape
    ns = Bv.shape[-1]
    nc = L // Q

    xs_c = xs.reshape(Bsz, nc, Q, nh, hd).to(f32)
    B_c = Bv.reshape(Bsz, nc, Q, ns).to(f32)
    C_c = Cv.reshape(Bsz, nc, Q, ns).to(f32)
    dA_c = dA.reshape(Bsz, nc, Q, nh)
    dt_c = dt.reshape(Bsz, nc, Q, nh)

    seg = torch.cumsum(dA_c, dim=2)            # (B, nc, Q, H) running decay
    # intra-chunk: y[t] = sum_{s<=t} C_t·B_s exp(seg_t - seg_s) dt_s x_s
    decay = seg[:, :, :, None, :] - seg[:, :, None, :, :]    # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    gmat = _masked_decay(decay, tri[None, None, :, :, None])
    gmat = con.constrain(gmat, con.ssd_intra)   # heads over model
    cb = torch.einsum("bctn,bcsn->bcts", C_c, B_c)
    w = cb[..., None] * gmat * dt_c[:, :, None, :, :]          # (B,nc,t,s,H)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", w, xs_c)

    # per-chunk final state: sum_s exp(seg_Q - seg_s) dt_s B_s (x) x_s
    tail = torch.exp(seg[:, :, -1:, :] - seg) * dt_c            # (B,nc,Q,H)
    st = torch.einsum("bcsn,bcshp->bchnp", B_c, tail[..., None] * xs_c)
    chunk_decay = torch.exp(seg[:, :, -1, :])                   # (B, nc, H)

    # inter-chunk recurrence over the chunk states: h before each chunk
    h = torch.zeros((Bsz, nh, ns, hd), dtype=f32, device=xs.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + st[:, c]
    hp = torch.stack(h_prev, dim=1)                          # (B,nc,H,N,P)
    y_inter = torch.einsum("bctn,bchnp->bcthp", C_c, hp) \
        * torch.exp(seg)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, L, nh, hd)
    return y + xs.to(f32) * D[None, None, :, None]


def _chunks_on_mesh(xs, Bv, Cv, dt, dA, D, Q):
    """``_ssd_chunks`` on each rank's local shards (``local_map``), laid
    out as ``repro``'s ``ssd_intra``: batch over the dp group, heads over
    model; B and C whole on every rank of a batch slice."""
    mesh = xs.device_mesh
    rules = ShardingRules(mesh)
    b, h = rules.dp(xs.shape[0]), rules.tp(xs.shape[2])

    def pl(*spec):
        return list(placements(con.P(*spec), mesh))
    heads4, heads3 = pl(b, None, h, None), pl(b, None, h)
    ins = (heads4, pl(b, None, None), pl(b, None, None), heads3, heads3,
           pl(h))
    # B and C feed every head, D every batch row: their gradients are
    # sums over the mesh dims that split the heads, resp. the batch
    grads = tuple(grad_placements(p, heads4) for p in ins)

    def local(*args):
        with con.use_mesh(None):
            return _ssd_chunks(*args, Q)
    return local_map(local, out_placements=heads4, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(xs, Bv, Cv, dt, dA, D)


def ssd_decode_step(params: dict, x_t: torch.Tensor, state,
                    cfg: ArchConfig):
    """x_t (B, D); state = (conv window (B, W-1, C), h (B, H, N, P)
    float32).  Returns (out (B, D), the new state)."""
    conv_state, h = state
    di, ns, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    z, xbc, dt = _split_proj(cfg, x_t @ params["in_proj"])
    xbc, conv_state = causal_conv1d_step(xbc, conv_state, params["conv_w"])
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(-1, nh, hd).to(f32)
    Bv = xbc[..., di:di + ns].to(f32)
    Cv = xbc[..., di + ns:].to(f32)
    dt = F.softplus(dt.to(f32) + params["dt_bias"])             # (B, H)
    dA = torch.exp(dt * -torch.exp(params["A_log"]))            # (B, H)
    h = h * dA[..., None, None] + torch.einsum("bh,bn,bhp->bhnp", dt, Bv,
                                               xs)
    y = torch.einsum("bn,bhnp->bhp", Cv, h) + xs * params["D"][None, :, None]
    y = y.reshape(-1, di).to(x_t.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], (conv_state, h)


def init_ssm_state(cfg: ArchConfig, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device | str = "cuda"):
    """A zero state: (conv window (batch, W-1, d_inner + 2N) in
    ``dtype``, h (batch, H, N, P) float32)."""
    device = resolve_device(device)
    di, ns = cfg.d_inner, cfg.ssm_state
    conv = torch.zeros((batch, cfg.conv_width - 1, di + 2 * ns), dtype=dtype,
                       device=device)
    h = torch.zeros((batch, cfg.ssm_heads, ns, cfg.ssm_head_dim), dtype=f32,
                    device=device)
    return conv, h
