"""Flat convenience bindings (the WASM-export surface analog).

Counterpart of the JAX package's ``bindings.py``. The reference exposes a
minimal flat API to the browser (``src/wasm.rs:44-201``):
``encodePng(data, w, h, colorType, preset, lossy)``, ``encodeJpeg(data, w,
h, colorType, quality, preset, sub420)``, ``resizeImage(...)``,
``bytesPerPixel(colorType)``. This module gives the same call shapes for
embedders that want a stable, options-free entry surface (color types by
integer id, presets 0/1/2), computing on ``device``.
"""

from __future__ import annotations

import numpy as np

from .color import ColorType
from .options import JpegOptions, PngOptions, ResizeFilter, ResizeOptions, Subsampling


def bytes_per_pixel(color_type: int) -> int:
    return ColorType(color_type).bytes_per_pixel


def encode_png(data, width: int, height: int, color_type: int = 3, preset: int = 1,
               lossless: bool = True, *, device="cuda") -> bytes:
    from . import png

    opts = PngOptions.from_preset_with_lossless(width, height, preset, lossless)
    opts.color_type = ColorType(color_type)
    return png.encode(_as_array(data, width, height, opts.color_type), opts, device=device)


def encode_jpeg(data, width: int, height: int, color_type: int = 2, quality: int = 85,
                preset: int = 1, subsample_420: bool = False, *, device="cuda") -> bytes:
    from . import jpeg

    opts = JpegOptions.from_preset(width, height, quality, preset)
    opts.color_type = ColorType(color_type)
    if subsample_420 and preset != 2:
        opts.subsampling = Subsampling.S420
    arr = _as_array(data, width, height, opts.color_type)
    if opts.color_type == ColorType.GRAY and arr.ndim == 3:
        arr = arr[..., 0]
    return jpeg.encode(np.ascontiguousarray(arr), opts, device=device)


def resize_image(data, src_width: int, src_height: int, dst_width: int, dst_height: int,
                 color_type: int = 3, algorithm: str = "lanczos3", *, device="cuda") -> bytes:
    from .resize import resize

    ct = ColorType(color_type)
    opts = ResizeOptions(
        src_width=src_width, src_height=src_height,
        dst_width=dst_width, dst_height=dst_height,
        color_type=ct, filter=ResizeFilter(algorithm),
    )
    return resize(_as_array(data, src_width, src_height, ct), opts, device=device).tobytes()


def _as_array(data, width: int, height: int, ct: ColorType) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(height, width, ct.bytes_per_pixel)
    return np.frombuffer(bytearray(data), np.uint8).reshape(height, width, ct.bytes_per_pixel)
