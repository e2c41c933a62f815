"""DEFLATE of the PNG encode: the native C++ stack (host stage); and the
package-merge code lengths of the optimal JPEG tables (``huffman.py``)."""

from .deflate import deflate_zlib

__all__ = ["deflate_zlib"]
