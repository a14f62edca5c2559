"""mistral-large-123b — dense GQA. [hf:mistralai/Mistral-Large-Instruct-2407;
unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mistral_large_123b", family="dense",
    num_layers=88, d_model=12288, num_heads=96, kv_heads=8,
    d_ff=28672, vocab=32768, head_dim=128,
    source="[hf:mistralai/Mistral-Large-Instruct-2407; unverified]",
)
