"""Public resize API (parity: pixo ``src/resize.rs:163-293``).

Counterpart of the JAX package's ``resize.py``: the same validation and
errors in the same order, computing on ``device`` ("cpu" or a CUDA device).
Lanczos3 on a card is the hand-written kernel of ``csrc/resize.cu``. The
reference's choice of tier (``PIXO_TPU_RESIZE``) has no counterpart:
``device=`` decides, and the result has the bytes of the reference's tiers.
"""

from __future__ import annotations

import numpy as np
import torch

from . import errors
from .ops.resize_kernels import resize_bilinear, resize_lanczos3, resize_nearest
from .options import ResizeFilter, ResizeOptions

MAX_RESIZE_DIMENSION = 1 << 24


def resize(data, options: ResizeOptions, *, device="cuda") -> np.ndarray:
    """Resize an image; accepts flat bytes or [H, W, C] uint8 array.

    Returns a [dst_h, dst_w, C] uint8 array (C = bytes/pixel; squeezed for
    grayscale input arrays of shape [H, W]).
    """
    sw, sh = options.src_width, options.src_height
    dw, dh = options.dst_width, options.dst_height
    if sw == 0 or sh == 0:
        raise errors.InvalidDimensions(sw, sh)
    if dw == 0 or dh == 0:
        raise errors.InvalidDimensions(dw, dh)
    for dim in (sw, sh, dw, dh):
        if dim > MAX_RESIZE_DIMENSION:
            raise errors.ImageTooLarge(dw, dh, MAX_RESIZE_DIMENSION)
    bpp = options.color_type.bytes_per_pixel

    squeeze = False
    if isinstance(data, np.ndarray):
        if data.ndim == 2:
            arr = data[..., None]
            squeeze = True
        else:
            arr = data
        arr = np.ascontiguousarray(arr, dtype=np.uint8)
        if arr.shape != (sh, sw, bpp):
            expected = sh * sw * bpp
            raise errors.InvalidDataLength(expected, arr.size)
    else:
        expected = sh * sw * bpp
        if len(data) != expected:
            raise errors.InvalidDataLength(expected, len(data))
        arr = np.frombuffer(bytearray(data), np.uint8).reshape(sh, sw, bpp)  # writable, for torch

    if (sw, sh) == (dw, dh):
        out = arr.copy()
    else:
        kernel = {ResizeFilter.NEAREST: resize_nearest, ResizeFilter.BILINEAR: resize_bilinear,
                  ResizeFilter.LANCZOS3: resize_lanczos3}[options.filter]
        out = kernel(torch.from_numpy(arr).to(device), dst_w=dw, dst_h=dh).cpu().numpy()

    return out[..., 0] if squeeze else out


def resize_into(output: bytearray, data, options: ResizeOptions, *, device="cuda") -> None:
    """Buffer-reuse variant (parity: ``resize_into``, src/resize.rs:180)."""
    output.clear()
    output += resize(data, options, device=device).tobytes()
