"""MSB-first bit writer for the JPEG entropy stages, in Python.

Copied from the JAX package's ``bits.py`` (``BitWriterMsb``; semantics
parity with pixo ``src/bits.rs:195-293``: MSB-first packing, 0xFF -> 0xFF00
byte stuffing, flush padding with 1 bits). The host library packs every
scan the port emits; this writer is the Python fallback of the progressive
scans (``jpeg/progressive.py``) and of ``jpeg/packer.py``, and the tests'
oracle. The LSB-first writer and reader of the JAX module serve its Python
DEFLATE, which the port does not have.
"""

from __future__ import annotations


class BitWriterMsb:
    """MSB-first bit writer with JPEG 0xFF byte stuffing."""

    __slots__ = ("_buf", "_cur", "_space")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._cur = 0
        self._space = 8  # bits remaining in current byte

    def write_bits(self, value: int, num_bits: int) -> None:
        remaining = num_bits
        while remaining > 0:
            to_write = min(remaining, self._space)
            shift = remaining - to_write
            bits = (value >> shift) & ((1 << to_write) - 1)
            self._space -= to_write
            self._cur |= bits << self._space
            remaining -= to_write
            if self._space == 0:
                self._buf.append(self._cur)
                if self._cur == 0xFF:
                    self._buf.append(0x00)
                self._cur = 0
                self._space = 8

    def write_bit(self, bit: bool) -> None:
        self.write_bits(1 if bit else 0, 1)

    def flush(self) -> None:
        """Pad the partial byte with 1s (JPEG spec), applying stuffing."""
        if self._space < 8:
            self._cur |= (1 << self._space) - 1
            self._buf.append(self._cur)
            if self._cur == 0xFF:
                self._buf.append(0x00)
            self._cur = 0
            self._space = 8

    def write_bytes(self, data: bytes) -> None:
        """Append raw bytes; must be byte-aligned (used for RST markers)."""
        assert self._space == 8, "must be byte-aligned"
        self._buf.extend(data)

    def finish(self) -> bytes:
        self.flush()
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)
