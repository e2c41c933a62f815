"""Batched encode and decode and the thumbnail pipeline on one device: device
compute, host packing, DEFLATE and entropy decoding."""

from .pipeline import (
    decode_jpeg_batch,
    decode_png_batch,
    encode_jpeg_batch_sharded,
    encode_png_batch_sharded,
    encode_png_row_sharded,
    jpeg_coeffs_sharded,
    thumbnail_pipeline,
)

__all__ = [
    "decode_jpeg_batch",
    "decode_png_batch",
    "encode_jpeg_batch_sharded",
    "encode_png_batch_sharded",
    "encode_png_row_sharded",
    "jpeg_coeffs_sharded",
    "thumbnail_pipeline",
]
