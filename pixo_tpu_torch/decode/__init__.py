"""Decoders: PNG on the host, JPEG (baseline and progressive) with its pixel
tail on a device.

Counterpart of the JAX package's ``decode/``. The entropy stages (INFLATE,
Huffman decode) run on the host in the shared C++ tier; the JPEG pixel math
(dequantize, IDCT, upsampling, colour) runs for a whole batch at once on
``device``; the PNG decode is host work throughout, as in the JAX package.
"""

from .batch import decode_jpeg_batch, decode_png_batch
from .jpeg_decoder import JpegImage, decode_jpeg
from .png_decoder import PngImage, decode_png

__all__ = [
    "JpegImage", "PngImage", "decode_jpeg", "decode_jpeg_batch", "decode_png",
    "decode_png_batch",
]
