"""Checkpoints of the port (``repro.checkpoint``)."""
from .manager import CheckpointManager
