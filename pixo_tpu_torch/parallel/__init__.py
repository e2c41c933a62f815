"""Batched encode on one device: device compute, host packing and DEFLATE."""

from .pipeline import encode_jpeg_batch_sharded, encode_png_batch_sharded, jpeg_coeffs_sharded

__all__ = ["encode_jpeg_batch_sharded", "encode_png_batch_sharded", "jpeg_coeffs_sharded"]
