from .base import (
    ArchConfig,
    EncoderConfig,
    MLAConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
)
from .registry import ARCHS, get_arch
from .shapes import InputShape, SHAPES, shapes_for

__all__ = [
    "ARCHS",
    "ArchConfig",
    "EncoderConfig",
    "InputShape",
    "MLAConfig",
    "MoEConfig",
    "RGLRUConfig",
    "SHAPES",
    "SSMConfig",
    "get_arch",
    "shapes_for",
]
