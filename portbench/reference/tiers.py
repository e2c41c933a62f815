"""The compaction route of a batch, worked out from its coefficients.

pixo's padded compaction keeps, for every block, its DC, its count of
nonzero AC coefficients and its first ``cap`` nonzero (position, value)
pairs. A batch is compacted at cap 8 first; where any block of the batch
holds more nonzero ACs, it is compacted again at the smallest tier of
(16, 32) that holds them all, and above 32 the dense coefficients (128
bytes a block) are fetched instead.
"""

from __future__ import annotations

import numpy as np

CAP_TIERS = (8, 16, 32)
DENSE = "dense"


def nonzero_acs(zz: np.ndarray) -> np.ndarray:
    """[..., 64] zigzag coefficients -> [...] count of nonzero ACs."""
    return np.count_nonzero(np.asarray(zz)[..., 1:], axis=-1)


def tier(max_nonzero_acs: int):
    """The cap a batch whose fullest block holds ``max_nonzero_acs``
    nonzero ACs is fetched at, or ``DENSE``."""
    return next((t for t in CAP_TIERS if max_nonzero_acs <= t), DENSE)


def route_bytes(blocks: int, route) -> int:
    """Bytes of the route's output arrays for ``blocks`` blocks: the padded
    rows (DC int16, count u8, ``cap`` positions u8 and values int16 a block)
    or the dense int16 coefficients."""
    return blocks * (128 if route == DENSE else 3 + 3 * route)
