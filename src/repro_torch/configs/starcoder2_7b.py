"""starcoder2-7b — GQA kv=4, RoPE. [arXiv:2402.19173; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2_7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, kv_heads=4,
    d_ff=18432, vocab=49152, head_dim=128,
    source="[arXiv:2402.19173; hf]",
)
