"""mamba2-780m — attention-free SSD (state-space duality); runs long_500k.
[arXiv:2405.21060; unverified]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2_780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=1, kv_heads=1,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    sub_quadratic=True, tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)
