"""Known-bad module: imports nothing uses."""
import ctypes
import numpy as np
import torch as th
from typing import Dict, Optional


def ones(n):
    return [1] * n
