"""internlm2-1.8b — GQA kv=8. [arXiv:2403.17297; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2_1p8b", family="dense",
    num_layers=24, d_model=2048, num_heads=16, kv_heads=8,
    d_ff=8192, vocab=92544, head_dim=128,
    source="[arXiv:2403.17297; hf]",
)
