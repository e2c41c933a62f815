"""Bit-level writers and a reader, in Python.

Copied from the JAX package's ``bits.py``, with semantics parity with pixo
``src/bits.rs``:

- ``BitWriterMsb``: MSB-first packing with 0xFF -> 0xFF00 byte stuffing and
  flush padding with 1 bits (``:195-293``), for JPEG. The host library packs
  every scan the port emits; this writer is the Python fallback of the
  progressive scans (``jpeg/progressive.py``) and of ``jpeg/packer.py``, and
  the tests' oracle.
- ``BitWriterLsb`` and ``BitReaderLsb``: LSB-first packing and reading, the
  DEFLATE bit order (``:5-113``). No path of the port uses them: its
  DEFLATE and INFLATE are the host library's. They serve callers that write
  or read DEFLATE-ordered bit streams in Python.
"""

from __future__ import annotations


class BitWriterLsb:
    """LSB-first bit writer (DEFLATE bit order), 64-bit accumulator."""

    __slots__ = ("_buf", "_acc", "_nbits")

    def __init__(self) -> None:
        self._buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write_bits(self, value: int, num_bits: int) -> None:
        self._acc |= (value & ((1 << num_bits) - 1)) << self._nbits
        self._nbits += num_bits
        while self._nbits >= 8:
            self._buf.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8

    def write_bit(self, bit: bool) -> None:
        self.write_bits(1 if bit else 0, 1)

    def write_bytes(self, data: bytes) -> None:
        if self._nbits == 0:
            self._buf.extend(data)
        else:
            for b in data:
                self.write_bits(b, 8)

    def flush(self) -> None:
        """Pad the partial byte with zeros."""
        if self._nbits > 0:
            self._buf.append(self._acc & 0xFF)
            self._acc = 0
            self._nbits = 0

    def finish(self) -> bytes:
        self.flush()
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def bit_position(self) -> int:
        return self._nbits



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


class BitReaderLsb:
    """LSB-first bit reader (DEFLATE)."""

    __slots__ = ("_data", "_pos", "_acc", "_nbits")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0
        self._acc = 0
        self._nbits = 0

    def _fill(self, need: int) -> None:
        while self._nbits < need:
            if self._pos >= len(self._data):
                raise EOFError("out of input bits")
            self._acc |= self._data[self._pos] << self._nbits
            self._pos += 1
            self._nbits += 8

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        self._fill(n)
        val = self._acc & ((1 << n) - 1)
        self._acc >>= n
        self._nbits -= n
        return val

    def peek_bits(self, n: int) -> int:
        """Peek up to n bits, zero-padded past end of stream."""
        while self._nbits < n and self._pos < len(self._data):
            self._acc |= self._data[self._pos] << self._nbits
            self._pos += 1
            self._nbits += 8
        return self._acc & ((1 << n) - 1)

    def consume(self, n: int) -> None:
        if n > self._nbits:
            raise EOFError("out of input bits")
        self._acc >>= n
        self._nbits -= n

    def align_to_byte(self) -> None:
        drop = self._nbits % 8
        self._acc >>= drop
        self._nbits -= drop

    def read_aligned_bytes(self, n: int) -> bytes:
        self.align_to_byte()
        out = bytearray()
        while self._nbits >= 8 and n > 0:
            out.append(self._acc & 0xFF)
            self._acc >>= 8
            self._nbits -= 8
            n -= 1
        if n > 0:
            if self._pos + n > len(self._data):
                raise EOFError("out of input bytes")
            out.extend(self._data[self._pos : self._pos + n])
            self._pos += n
        return bytes(out)

    @property
    def byte_position(self) -> int:
        return self._pos - self._nbits // 8
