"""JPEG encoder, baseline slice: tables, markers and the coefficient stage."""

from .tables import ZIGZAG, HuffmanTables, QuantizationTables

__all__ = ["HuffmanTables", "QuantizationTables", "ZIGZAG"]
