"""Batched encode and decode on one device: device compute, host packing,
DEFLATE and entropy decoding."""

from .pipeline import (
    decode_jpeg_batch,
    encode_jpeg_batch_sharded,
    encode_png_batch_sharded,
    jpeg_coeffs_sharded,
)

__all__ = [
    "decode_jpeg_batch",
    "encode_jpeg_batch_sharded",
    "encode_png_batch_sharded",
    "jpeg_coeffs_sharded",
]
