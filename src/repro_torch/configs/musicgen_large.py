"""musicgen-large — decoder-only over EnCodec tokens; text-conditioning
frontend stubbed as precomputed frame embeddings. [arXiv:2306.05284; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_large", family="audio",
    num_layers=48, d_model=2048, num_heads=32, kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
    frontend="audio_stub", frontend_len=64,
    source="[arXiv:2306.05284; hf]",
)
