"""Batched encode on one device: device coefficients, host packing."""

from .pipeline import encode_jpeg_batch_sharded, jpeg_coeffs_sharded

__all__ = ["encode_jpeg_batch_sharded", "jpeg_coeffs_sharded"]
