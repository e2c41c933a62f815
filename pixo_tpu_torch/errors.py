"""Error taxonomy for pixo_tpu_torch (copied unchanged from the JAX package).

Mirrors the reference error model (pixo ``src/error.rs:10-48``) as a Python
exception hierarchy so users migrating from the reference find the same
failure categories.
"""

from __future__ import annotations


class PixoError(Exception):
    """Base class for all pixo_tpu_torch errors."""


class InvalidDimensions(PixoError):
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        super().__init__(f"invalid image dimensions: {width}x{height}")


class ImageTooLarge(PixoError):
    def __init__(self, width: int, height: int, max_dim: int):
        self.width = width
        self.height = height
        self.max = max_dim
        super().__init__(
            f"image too large: {width}x{height} exceeds maximum dimension {max_dim}"
        )


class InvalidDataLength(PixoError):
    def __init__(self, expected: int, actual: int):
        self.expected = expected
        self.actual = actual
        super().__init__(f"invalid data length: expected {expected} bytes, got {actual}")


class InvalidQuality(PixoError):
    def __init__(self, quality: int):
        self.quality = quality
        super().__init__(f"invalid quality value: {quality} (must be 1-100)")


class InvalidCompressionLevel(PixoError):
    def __init__(self, level: int):
        self.level = level
        super().__init__(f"invalid compression level: {level} (must be 1-9)")


class UnsupportedColorType(PixoError):
    def __init__(self, detail: str = ""):
        super().__init__(f"unsupported color type{': ' + detail if detail else ''}")


class CompressionError(PixoError):
    pass


class InvalidRestartInterval(PixoError):
    def __init__(self, interval: int):
        self.interval = interval
        super().__init__(f"invalid restart interval: {interval} (must be >= 1)")


class InvalidDecode(PixoError):
    """Malformed input encountered while decoding."""

    def __init__(self, detail: str):
        super().__init__(f"invalid encoded data: {detail}")


class UnsupportedDecode(PixoError):
    """Valid but unsupported feature encountered while decoding."""

    def __init__(self, detail: str):
        super().__init__(f"unsupported feature: {detail}")
