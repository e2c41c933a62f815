"""JPEG marker segment writers.

Byte parity with pixo ``src/jpeg/mod.rs:449-682``: SOI, APP0 (JFIF 1.01,
no units, 1x1 density), DQT (two 8-bit tables in zigzag order), SOF0/SOF2,
DHT (four tables), DRI, SOS (baseline + progressive variants), EOI.
"""

from __future__ import annotations

import struct

from ..color import ColorType
from ..options import Subsampling
from .tables import HuffmanTables, QuantizationTables

SOI = 0xFFD8
EOI = 0xFFD9
APP0 = 0xFFE0
DQT = 0xFFDB
SOF0 = 0xFFC0
SOF2 = 0xFFC2
DHT = 0xFFC4
SOS = 0xFFDA
DRI = 0xFFDD


def write_soi(out: bytearray) -> None:
    out += struct.pack(">H", SOI)


def write_eoi(out: bytearray) -> None:
    out += struct.pack(">H", EOI)


def write_app0(out: bytearray) -> None:
    out += struct.pack(">HH", APP0, 16)
    out += b"JFIF\x00"
    out += bytes([1, 1])  # version 1.01
    out += bytes([0])  # units: aspect-ratio only
    out += struct.pack(">HH", 1, 1)  # x/y density
    out += bytes([0, 0])  # no thumbnail


def write_dqt(out: bytearray, tables: QuantizationTables) -> None:
    out += struct.pack(">HH", DQT, 67)
    out += bytes([0])
    out += tables.luminance.tobytes()
    out += struct.pack(">HH", DQT, 67)
    out += bytes([1])
    out += tables.chrominance.tobytes()


def write_sof(
    out: bytearray,
    marker: int,
    width: int,
    height: int,
    color_type: ColorType,
    subsampling: Subsampling,
) -> None:
    out += struct.pack(">H", marker)
    num_components = 1 if color_type == ColorType.GRAY else 3
    out += struct.pack(">H", 8 + 3 * num_components)
    out += bytes([8])  # precision
    out += struct.pack(">HH", height, width)
    out += bytes([num_components])
    if num_components == 1:
        out += bytes([1, 0x11, 0])
    else:
        y_sampling = {
            Subsampling.S420: 0x22,  # h=2, v=2
            Subsampling.S422: 0x21,  # h=2, v=1
        }.get(subsampling, 0x11)
        out += bytes([1, y_sampling, 0])
        out += bytes([2, 0x11, 1])
        out += bytes([3, 0x11, 1])


def write_huffman_table(out: bytearray, table_id: int, bits: bytes, vals: bytes) -> None:
    out += struct.pack(">HH", DHT, 2 + 1 + 16 + len(vals))
    out += bytes([table_id])
    out += bits
    out += vals


def write_dht(out: bytearray, tables: HuffmanTables) -> None:
    write_huffman_table(out, 0x00, tables.dc_lum_bits, tables.dc_lum_vals)
    write_huffman_table(out, 0x01, tables.dc_chrom_bits, tables.dc_chrom_vals)
    write_huffman_table(out, 0x10, tables.ac_lum_bits, tables.ac_lum_vals)
    write_huffman_table(out, 0x11, tables.ac_chrom_bits, tables.ac_chrom_vals)


def write_dri(out: bytearray, interval: int) -> None:
    out += struct.pack(">HHH", DRI, 4, interval)


def write_sos(out: bytearray, color_type: ColorType) -> None:
    out += struct.pack(">H", SOS)
    num_components = 1 if color_type == ColorType.GRAY else 3
    out += struct.pack(">H", 6 + 2 * num_components)
    out += bytes([num_components])
    if num_components == 1:
        out += bytes([1, 0x00])
    else:
        out += bytes([1, 0x00, 2, 0x11, 3, 0x11])
    out += bytes([0, 63, 0])  # Ss, Se, Ah/Al


def write_sos_progressive(out: bytearray, components, ss: int, se: int, ah: int, al: int) -> None:
    """``components`` is a sequence of 0-based component indices (0=Y)."""
    out += struct.pack(">H", SOS)
    n = len(components)
    out += struct.pack(">H", 6 + 2 * n)
    out += bytes([n])
    for comp_id in components:
        out += bytes([comp_id + 1, 0x00 if comp_id == 0 else 0x11])
    out += bytes([ss, se, (ah << 4) | al])
