"""PNG chunk framing (parity: pixo ``src/png/chunk.rs:10-31``).

Counterpart of the JAX package's ``png/chunks.py``; the CRC comes from the
native library, with no ``zlib`` fallback.
"""

from __future__ import annotations

import struct

from ..native import native_crc32

PNG_SIGNATURE = bytes([0x89, 0x50, 0x4E, 0x47, 0x0D, 0x0A, 0x1A, 0x0A])


def write_chunk(out: bytearray, chunk_type: bytes, data: bytes) -> None:
    """length + type + data + CRC32(type || data), all big-endian."""
    out += struct.pack(">I", len(data))
    out += chunk_type
    out += data
    out += struct.pack(">I", native_crc32(chunk_type + data))


def write_ihdr(
    out: bytearray, width: int, height: int, bit_depth: int, color_type: int,
    interlace: int = 0,
) -> None:
    data = struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, interlace)
    write_chunk(out, b"IHDR", data)


def write_idat_chunks(out: bytearray, compressed: bytes, chunk_size: int = 262144) -> None:
    """IDAT in 256 KiB chunks (parity: ``src/png/mod.rs:619-626``)."""
    for i in range(0, len(compressed), chunk_size):
        write_chunk(out, b"IDAT", compressed[i : i + chunk_size])
    if not compressed:
        write_chunk(out, b"IDAT", b"")


def write_iend(out: bytearray) -> None:
    write_chunk(out, b"IEND", b"")
