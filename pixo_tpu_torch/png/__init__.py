"""PNG encoder, 8-bit lossless slice (see encoder.py)."""

from ..options import FilterStrategy, PngOptions
from .encoder import encode

__all__ = ["FilterStrategy", "PngOptions", "encode"]
