"""JPEG decode, baseline and progressive, with its pixel tail on a device.

Counterpart of the JAX package's ``decode/`` for JPEG: the entropy stage
runs on the host in the shared C++ tier, the pixel math (dequantize,
IDCT, upsampling, colour) runs for a whole batch at once on ``device``. The
PNG decoder is not ported yet.
"""

from .batch import decode_jpeg_batch
from .jpeg_decoder import JpegImage, decode_jpeg

__all__ = ["JpegImage", "decode_jpeg", "decode_jpeg_batch"]
