"""The LM stack of the port (``repro.models``): the dense decoder on the
hand-written attention kernels K6 and K7."""
from . import attention, layers, transformer
from .transformer import (cache_from_numpy, decode_step, forward,
                          forward_hidden, init_cache, init_params,
                          layer_plan, params_from_numpy, prefill)
