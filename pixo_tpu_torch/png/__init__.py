"""PNG encoder, 8-bit, lossless and lossy (palette quantization); see
encoder.py and quantize.py."""

from ..options import FilterStrategy, PngOptions, QuantizationMode
from . import quantize
from .encoder import encode, encode_indexed

__all__ = ["FilterStrategy", "PngOptions", "QuantizationMode", "encode", "encode_indexed", "quantize"]
