"""JPEG encoder (baseline and progressive, standard, optimized and optimal
Huffman tables): ``encode`` one image, ``encode_batch`` a batch, on the card
or (``device="cpu"``) on the host library — see encoder.py."""

from .encoder import encode, encode_batch
from .tables import ZIGZAG, HuffmanTables, QuantizationTables

__all__ = ["HuffmanTables", "QuantizationTables", "ZIGZAG", "encode", "encode_batch"]
