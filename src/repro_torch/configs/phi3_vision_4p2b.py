"""phi-3-vision-4.2b — phi3-mini backbone + CLIP vision frontend (stubbed).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3_vision_4p2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, kv_heads=32,
    d_ff=8192, vocab=32064, head_dim=96,
    frontend="vision_stub", frontend_len=256,
    source="[hf:microsoft/Phi-3-vision-128k-instruct; hf]",
)
