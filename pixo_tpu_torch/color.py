"""Color types and fixed-point color-space conversion, on torch tensors.

Counterpart of the JAX package's ``color.py``; behavioral parity with pixo
``src/color.rs``:
  - ``ColorType`` enum with bytes/pixel and PNG color-type byte mapping
    (``src/color.rs:9-48``).
  - BT.601 RGB->YCbCr using the same /256 fixed-point arithmetic
    (``src/color.rs:60-77``) as int32 tensor arithmetic, and its NumPy
    mirror; the CLI's BT.601 grayscale.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class ColorType(enum.IntEnum):
    GRAY = 0
    GRAY_ALPHA = 1
    RGB = 2
    RGBA = 3

    @property
    def bytes_per_pixel(self) -> int:
        return _BPP[self]

    @property
    def png_color_type(self) -> int:
        return _PNG_CT[self]

    @property
    def png_bit_depth(self) -> int:
        return 8

    @property
    def has_alpha(self) -> bool:
        return self in (ColorType.GRAY_ALPHA, ColorType.RGBA)


_BPP = {
    ColorType.GRAY: 1,
    ColorType.GRAY_ALPHA: 2,
    ColorType.RGB: 3,
    ColorType.RGBA: 4,
}

_PNG_CT = {
    ColorType.GRAY: 0,
    ColorType.GRAY_ALPHA: 4,
    ColorType.RGB: 2,
    ColorType.RGBA: 6,
}


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """Fixed-point BT.601 RGB -> YCbCr over a [..., 3] uint8 tensor.

    Exact integer semantics of pixo ``rgb_to_ycbcr`` (``src/color.rs:60-77``):
      y  = (77 R + 150 G + 29 B + 128) >> 8
      cb = ((-43 R - 85 G + 128 B + 128) >> 8) + 128
      cr = ((128 R - 107 G - 21 B + 128) >> 8) + 128
    with arithmetic (sign-preserving) right shift, as ``>>`` is on int32
    tensors, and clamp to [0, 255]. Returns a [..., 3] uint8 tensor.
    """
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128
    cr = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128
    out = torch.stack([y, cb, cr], dim=-1)
    return out.clamp(0, 255).to(torch.uint8)


def rgb_to_ycbcr_np(rgb: np.ndarray) -> np.ndarray:
    """``rgb_to_ycbcr`` in NumPy over a [..., 3] uint8 array (the scalar
    path's mirror, as the JAX package's ``color.rgb_to_ycbcr_np``)."""
    x = rgb.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128
    cr = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128
    return np.clip(np.stack([y, cb, cr], axis=-1), 0, 255).astype(np.uint8)


def to_grayscale_bt601(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma of a [..., 3] uint8 array, for the CLI's ``--grayscale``
    (pixo ``src/bin/pixo.rs:478-502``)."""
    x = rgb.astype(np.int64)
    y = (77 * x[..., 0] + 150 * x[..., 1] + 29 * x[..., 2] + 128) >> 8
    return np.clip(y, 0, 255).astype(np.uint8)
