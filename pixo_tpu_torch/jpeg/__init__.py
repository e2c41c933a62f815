"""JPEG encoder (baseline and progressive, standard, optimized and optimal
Huffman tables, the trellis): ``encode`` one image, ``encode_batch`` a batch,
on the card or (``device="cpu"``) on the host library — see encoder.py."""

from ..options import JpegOptions, Subsampling
from .encoder import compute_coefficients, encode, encode_batch
from .tables import ZIGZAG, HuffmanTables, QuantizationTables


def encode_into(output: bytearray, data, options: JpegOptions, *, device="cuda") -> None:
    """Buffer-reuse variant (parity: ``encode_into``, src/jpeg/mod.rs:328):
    clears and refills the caller's bytearray."""
    output.clear()
    output += encode(data, options, device=device)


__all__ = [
    "JpegOptions",
    "Subsampling",
    "encode",
    "encode_batch",
    "encode_into",
    "compute_coefficients",
    "HuffmanTables",
    "QuantizationTables",
    "ZIGZAG",
]
