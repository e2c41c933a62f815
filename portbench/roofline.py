"""The yardstick of the kernel metrics: the card's peak and the bytes a
stage's work needs, counted from shapes.

Each input byte is read once and each output byte written once; what one
kernel hands the next on the card is not counted, so a stage reads the same
work whatever implements it. The per-kernel counts are the ones the port's
kernel table (``PERF.md`` section 6) gives its rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .reference import tiers

# NVIDIA's data sheet, H100 SXM at 700 W: HBM3 bytes a second
H100_BYTES_PER_S = 3.35e12

MCU = {"444": (8, 8, 3), "420": (16, 16, 6)}  # MCU height, width, blocks


def blocks(h: int, w: int, mode: str) -> int:
    """Blocks of one [h, w, 3] image in ``mode`` ("444" or "420")."""
    mh, mw, per = MCU[mode]
    return -(-h // mh) * -(-w // mw) * per


def coeffs_bytes(b: int, h: int, w: int, mode: str) -> int:
    """The coefficient kernel: the pixels in, the int16 zigzag blocks out."""
    return b * h * w * 3 + b * blocks(h, w, mode) * 128


def compact_bytes(nblocks: int, cap: int) -> int:
    """The compaction at ``cap``: the int16 blocks in, the padded rows out."""
    return nblocks * 128 + tiers.route_bytes(nblocks, cap)


def idct_bytes(nblocks: int) -> int:
    """The decode's IDCT: int16 coefficients in, uint8 pixels out."""
    return nblocks * (128 + 64)


def resize_bytes(b: int, h: int, w: int, c: int, dh: int, dw: int) -> int:
    """The two Lanczos3 passes: the source pixels in, the resized out."""
    return b * (h * w + dh * dw) * c


def encode_stage_bytes(b: int, h: int, w: int, mode: str, route) -> int:
    """A batch's device stage of the standard-table encode: its pixels in,
    its route's arrays out (the padded rows at the batch's cap, or the dense
    coefficients)."""
    return b * h * w * 3 + tiers.route_bytes(b * blocks(h, w, mode), route)


def thumb_source_bytes(shape: Tuple[int, ...], zz: Optional[np.ndarray]) -> int:
    """What a thumbnail's device stage reads of one source: a JPEG's
    coefficient planes (int16), or the decoded pixels of any other file."""
    return int(zz.shape[0]) * 128 if zz is not None else int(np.prod(shape))


def thumb_out_bytes(n: int, size: int, route) -> int:
    """A chunk of ``n`` thumbnails' compacted streams at its route."""
    return tiers.route_bytes(n * blocks(size, size, "444"), route)


def share_pct(nbytes: float, seconds: float) -> Optional[float]:
    """Percent of the card's peak bandwidth that moving ``nbytes`` in
    ``seconds`` reaches; None without a time."""
    if not seconds or seconds <= 0:
        return None
    return 100.0 * nbytes / H100_BYTES_PER_S / seconds
