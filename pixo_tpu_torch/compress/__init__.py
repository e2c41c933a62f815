"""DEFLATE, its Huffman codes and the checksums, on the host: the native C++
stack of the PNG encode and decode, and the package-merge code lengths of the
optimal JPEG tables (``huffman.py``)."""

from .checksums import Crc32, adler32, crc32
from .deflate import (
    deflate_optimal_zlib,
    deflate_raw,
    deflate_zlib,
    inflate_raw,
    inflate_zlib,
)
from .huffman import build_code_lengths, build_codes, generate_canonical_codes

__all__ = [
    "adler32",
    "crc32",
    "Crc32",
    "deflate_zlib",
    "deflate_raw",
    "deflate_optimal_zlib",
    "inflate_zlib",
    "inflate_raw",
    "build_code_lengths",
    "build_codes",
    "generate_canonical_codes",
]
