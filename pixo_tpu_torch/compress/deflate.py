"""zlib-wrapped DEFLATE through the native C++ stack.

Counterpart of the JAX package's ``compress/deflate.py::deflate_zlib``. The
JAX package falls back to Python's ``zlib`` when its native library is
missing; the port has no such tier: the native library builds or the call
raises.
"""

from __future__ import annotations

import os

from ..native import native_deflate


def _parity_default() -> bool:
    return os.environ.get("PIXO_TPU_DEFLATE_PARITY") == "1"


def deflate_zlib(data, level: int = 6, parity: bool = None, packed: bool = False) -> bytes:
    """zlib-wrapped DEFLATE stream of ``data`` (bytes or a contiguous uint8
    array) at ``level`` 1-9.

    ``parity=True`` (or ``PIXO_TPU_DEFLATE_PARITY=1`` when ``parity`` is
    None) selects the reference-parity decision layer. ``packed=True``
    selects, in parity mode only, the reference's deflate_zlib_packed policy,
    the one every PNG encode takes. The default is the performance path.
    """
    if parity is None:
        parity = _parity_default()
    return native_deflate(data, level, True, parity=parity, packed=packed)
