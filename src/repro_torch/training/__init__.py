"""Step factories and the trainer of the port (``repro.training``)."""
from .step import (make_loss_fn, make_prefill, make_serve_step,
                   make_train_step)
