"""Architecture config schema + the four assigned input shapes.

Every assigned architecture is a frozen ``ArchConfig``; ``reduced()``
derives the family-preserving smoke config (small widths/layers/experts)
used by the CPU tests.  A copy of ``repro.configs.base``: the port imports
nothing of ``repro``, so it keeps its own (the tests hold the two equal).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1           # MoE layer every N layers (llama4: 2)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    conv_width: int = 4
    # --- hybrid (RG-LRU + local attention) ---
    attn_window: int = 0         # 0 -> full attention
    pattern: Tuple[str, ...] = ()  # e.g. ("rec","rec","attn")
    rnn_width: int = 0
    # --- modality frontend stubs ---
    frontend: str = "none"       # none | vision_stub | audio_stub
    frontend_len: int = 0        # prefix positions fed by the stub
    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # eligible for long_500k
    remat: bool = True
    attn_chunk: int = 1024       # q-chunk for the XLA attention path
    # analysis-only: unroll layer loops so XLA cost analysis (which counts
    # while-loop bodies ONCE, verified empirically) reports true totals.
    unroll: bool = False
    # §Perf lever: shard layer-boundary residuals over (dp, model-on-seq) —
    # Megatron sequence parallelism; divides saved-activation memory by the
    # model-axis size at the cost of seq all-gathers at attention inputs.
    seq_shard_activations: bool = False
    source: str = ""             # provenance note [source; tier]

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (self.num_heads * self.hd) + 2 * d * (self.kv_heads * self.hd) \
            + (self.num_heads * self.hd) * d
        total = emb
        for li in range(self.num_layers):
            if self.family in ("dense", "vlm", "audio", "moe"):
                total += per_attn + 2 * d  # attn + 2 norms
                if self.family == "moe" and (li % self.moe_every == 0):
                    total += self.num_experts * 3 * d * f + d * self.num_experts
                else:
                    total += 3 * d * f
            elif self.family == "ssm":
                di, ns = self.d_inner, self.ssm_state
                total += d * (2 * di + 2 * ns + self.ssm_heads) + di * d \
                    + 2 * d + self.ssm_heads * 2 + di * self.conv_width
            elif self.family == "hybrid":
                kind = self.pattern[li % len(self.pattern)] if self.pattern else "attn"
                total += 2 * d
                if kind == "attn":
                    total += per_attn
                else:
                    w = self.rnn_width or d
                    total += 2 * d * w + w * d + 3 * w + w * self.conv_width
                total += 3 * d * f
        if self.frontend != "none":
            total += self.d_model * self.d_model  # stub projection
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top_k only)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        total = self.param_count()
        for li in range(self.num_layers):
            if li % self.moe_every == 0:
                total -= self.num_experts * 3 * d * f
                total += self.top_k * 3 * d * f
        return int(total)

    def reduced(self) -> "ArchConfig":
        """Family-preserving smoke config (CPU: one step in seconds)."""
        return dataclasses.replace(
            self,
            num_layers=min(self.num_layers, 3 if not self.pattern else len(self.pattern)),
            d_model=128,
            num_heads=4,
            kv_heads=max(1, min(self.kv_heads, 2)) if self.kv_heads < self.num_heads else 4,
            d_ff=256,
            vocab=512,
            head_dim=32,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            attn_window=min(self.attn_window, 16) if self.attn_window else 0,
            rnn_width=128 if self.rnn_width else 0,
            frontend_len=min(self.frontend_len, 4) if self.frontend_len else 0,
            attn_chunk=32,
        )

    def shape_supported(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """(supported, reason) — long_500k only for sub-quadratic archs."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, "skipped(full-attention): no sub-quadratic mechanism"
        return True, ""
