"""The LM stack of the port (``repro.models``): the decoder for every
family (dense, vlm, audio, moe, ssm, hybrid), its attention on the
hand-written kernels K6 and K7."""
from . import attention, layers, moe, rglru, ssm, transformer
from .transformer import (cache_from_numpy, decode_step, forward,
                          forward_hidden, init_cache, init_params,
                          layer_kinds, layer_plan, loss_fn,
                          params_from_numpy, prefill)
