from .base import ArchConfig, ShapeConfig, SHAPES
from .registry import ARCH_IDS, ALIASES, all_archs, get_arch, get_shape
