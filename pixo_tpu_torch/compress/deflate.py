"""DEFLATE and INFLATE through the native C++ stack.

Counterpart of the JAX package's ``compress/deflate.py``: ``deflate_zlib``,
``deflate_raw``, ``deflate_optimal_zlib`` (the PNG ``max`` preset's optimal
parse, with its ``PIXO_TPU_LZ77=device`` route, whose match tables start on
the card), ``inflate_zlib`` and ``inflate_raw``. The JAX package falls back to
Python's ``zlib`` when its native library is missing; the port has no such
tier: the native library builds or the call raises. Where the native INFLATE rejects a
stream, Python's ``zlib`` decodes it again under the same size cap, as in the
JAX package, so that a malformed stream raises that package's error.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional

import numpy as np

from ..errors import InvalidDecode
from ..native import (NativeInflateError, native_deflate, native_deflate_optimal,
                      native_deflate_optimal_assisted, native_deflate_optimal_parity,
                      native_inflate)

LZ77_ASSIST_STEPS = 16  # chain steps a position the device route's tables hold


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


def deflate_raw(data, level: int = 6, parity: bool = None, packed: bool = False) -> bytes:
    """``deflate_zlib`` without the zlib wrapper: a raw DEFLATE stream."""
    if parity is None:
        parity = _parity_default()
    return native_deflate(data, level, False, parity=parity, packed=packed)


def deflate_optimal_zlib(data, iterations: int = 5, *, device="cuda") -> bytes:
    """The zopfli-style iterative optimal parse of pixo's
    ``deflate_optimal_zlib``: per-position match tables, an entropy cost
    model and a shortest-path DP, ``iterations`` rounds.

    Under ``PIXO_TPU_DEFLATE_PARITY=1`` it is the reference's own path
    (byte-identical to pixo). Otherwise the performance path's parse, or
    ``deflate_zlib(data, 9)`` where that is shorter. Under
    ``PIXO_TPU_LZ77=device`` (the JAX package's route) the match tables'
    first 16 chain steps of every position come from
    ``ops/lz77_assist.py::chain_candidates`` on ``device``, the only thing
    ``device`` decides; the host walks the chains past them and the bytes
    are the same. A kernel that fails raises: there is no fallback to the
    host matcher.
    """
    if _parity_default():
        return native_deflate_optimal_parity(data, iterations)
    src = np.frombuffer(data, dtype=np.uint8)
    if os.environ.get("PIXO_TPU_LZ77") == "device" and src.size:
        from ..ops import lz77_assist as lz  # the device layer loads only for this route

        cand, lens = lz.chain_candidates(lz.stream_to(src, device), k=LZ77_ASSIST_STEPS)
        out = native_deflate_optimal_assisted(data, iterations, True, *lz.tables_to_host(cand, lens))
    else:
        out = native_deflate_optimal(data, iterations, True)
    greedy = deflate_zlib(data, 9)
    return out if len(out) < len(greedy) else greedy


def _zlib_inflate_capped(data: bytes, wbits: int, expected_size: Optional[int]) -> bytes:
    """Python's zlib under the native path's decompression-bomb guard: never
    more than ``expected_size`` + 1 bytes (the one makes oversize
    detectable), and no compressed input left after the expected output."""
    if expected_size is None:
        return zlib.decompress(data, wbits)
    d = zlib.decompressobj(wbits)
    try:
        out = d.decompress(data, expected_size + 1)
    except zlib.error as e:
        raise InvalidDecode(f"inflate failed: {e}") from e
    if len(out) > expected_size:
        raise InvalidDecode(f"inflated output exceeds expected size {expected_size}")
    if d.unconsumed_tail:
        raise InvalidDecode("inflate: compressed input after expected output")
    return out


def _inflate(data: bytes, expected_size: Optional[int], zlib_wrap: bool) -> bytes:
    if expected_size is not None:
        try:
            return native_inflate(data, expected_size, zlib_wrap)
        except NativeInflateError:
            pass  # zlib decodes it again below and names the error, or accepts it
    return _zlib_inflate_capped(data, zlib.MAX_WBITS if zlib_wrap else -15, expected_size)


def inflate_zlib(data: bytes, expected_size: Optional[int] = None) -> bytes:
    """Inverse of ``deflate_zlib``: at most ``expected_size`` bytes where it
    is given (the native INFLATE), the whole stream where it is not."""
    return _inflate(data, expected_size, True)


def inflate_raw(data: bytes, expected_size: Optional[int] = None) -> bytes:
    """``inflate_zlib`` for a raw DEFLATE stream."""
    return _inflate(data, expected_size, False)
