"""PNG encoder (lossless and lossy palette quantization; see encoder.py and
quantize.py)."""

from ..options import FilterStrategy, PngOptions, QuantizationMode
from . import quantize
from .encoder import encode, encode_batch, encode_indexed


def encode_into(output: bytearray, data, options: PngOptions) -> None:
    """Buffer-reuse variant (parity: ``encode_into``, src/png/mod.rs:437):
    clears and refills the caller's bytearray."""
    output.clear()
    output += encode(data, options)


def encode_indexed_with_options(data, width, height, palette,
                                transparency=None, options=None) -> bytes:
    return encode_indexed(data, width, height, palette, transparency, options)


__all__ = [
    "FilterStrategy",
    "PngOptions",
    "QuantizationMode",
    "encode",
    "encode_batch",
    "encode_indexed",
    "encode_indexed_with_options",
    "encode_into",
    "quantize",
]
