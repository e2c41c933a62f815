"""DEFLATE of the PNG encode: the native C++ stack (host stage)."""

from .deflate import deflate_zlib

__all__ = ["deflate_zlib"]
