"""llama3.2-1b — small llama3, GQA kv=8, tied embeddings.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3p2_1b", family="dense",
    num_layers=16, d_model=2048, num_heads=32, kv_heads=8,
    d_ff=8192, vocab=128256, head_dim=64,
    rope_theta=500_000.0, tie_embeddings=True,
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
)
