"""recurrentgemma-9b — RG-LRU + local attention (window 2048), pattern
(rec, rec, attn) = 1 attn : 2 rec; runs long_500k.
[arXiv:2402.19427; unverified]  38 layers = 12 super-blocks + 2 tail rec.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma_9b", family="hybrid",
    num_layers=38, d_model=4096, num_heads=16, kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    attn_window=2048, pattern=("rec", "rec", "attn"), rnn_width=4096,
    sub_quadratic=True,
    source="[arXiv:2402.19427; unverified]",
)
