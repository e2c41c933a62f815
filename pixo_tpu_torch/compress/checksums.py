"""CRC-32 and Adler-32 checksums, on the host.

Counterpart of the JAX package's ``compress/checksums.py`` (parity with pixo
``src/compress/crc32.rs`` and ``src/compress/adler32.rs``): the same
functions, routed through the native library, which raises where it does not
load; the JAX package's NumPy versions are its fallback tier, which the port
does not have. Both agree with ``zlib.crc32`` and ``zlib.adler32``. The JAX
package's device Adler-32 (``adler32_jnp``) is not ported yet: only its
device LZ77 route would call it (ROADMAP.md queue 2b).
"""

from __future__ import annotations

from ..native import native_adler32, native_crc32


def crc32(data: bytes, crc: int = 0) -> int:
    """CRC-32 (IEEE, reflected) of ``data``, continuing from ``crc``."""
    return native_crc32(data, crc)


class Crc32:
    """Incremental CRC-32 (mirrors pixo's ``Crc32`` struct)."""

    def __init__(self) -> None:
        self._crc = 0

    def update(self, data: bytes) -> None:
        self._crc = crc32(data, self._crc)

    def finalize(self) -> int:
        return self._crc


def adler32(data: bytes, adler: int = 1) -> int:
    """Adler-32 of ``data``, continuing from ``adler``."""
    return native_adler32(data, adler)
