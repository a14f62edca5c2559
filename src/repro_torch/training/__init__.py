"""Step factories of the port (``repro.training``): serving only so far;
``make_train_step`` and ``make_loss_fn`` wait for the training slice
(ROADMAP queue 1, item 9.4)."""
from .step import make_prefill, make_serve_step
