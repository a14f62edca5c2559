"""The optimizer of the port (``repro.optim``): AdamW."""
from . import adamw
