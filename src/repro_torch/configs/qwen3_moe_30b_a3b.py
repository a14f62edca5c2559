"""qwen3-moe-30b-a3b — 128 experts top-8, expert d_ff=768, every layer.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3_moe_30b_a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, kv_heads=4,
    d_ff=768, vocab=151936, head_dim=64,
    num_experts=128, top_k=8, moe_every=1,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)
