"""llama4-maverick-400b-a17b — MoE 128 experts top-1, interleaved every
other layer (dense FFN between), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4_maverick_400b_a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    num_experts=128, top_k=1, moe_every=2,
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
)
