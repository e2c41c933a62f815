"""JPEG encoder, baseline slice: option validation and the batched
coefficient stage.

Counterpart of the JAX package's ``jpeg/encoder.py`` (parity with pixo
``src/jpeg/mod.rs:328-447``). The device computes, for every block of every
image: pad -> fixed-point RGB->YCbCr -> level shift -> MCU blockify (scan
order) -> AAN f32 DCT -> quantize (round half away) -> zigzag. On a CUDA
tensor that whole chain is one hand-written kernel (``ops/kernels.py``); on a
CPU tensor it is the plain PyTorch chain of ``ops/``. The host entropy stage
and the marker framing live in ``parallel/pipeline.py``.

Not ported yet (ROADMAP queue 1 item 6): the single-image ``encode``, the
host coefficient tier, optimize-Huffman, progressive and trellis.
"""

from __future__ import annotations

import torch

from .. import errors
from ..color import ColorType
from ..options import MAX_DIMENSION, JpegOptions
from ..ops.kernels import coeffs


def _validate(options: JpegOptions, data_len: int) -> int:
    if options.quality == 0 or options.quality > 100:
        raise errors.InvalidQuality(options.quality)
    if options.restart_interval is not None and options.restart_interval == 0:
        raise errors.InvalidRestartInterval(0)
    w, h = options.width, options.height
    if w == 0 or h == 0:
        raise errors.InvalidDimensions(w, h)
    if w > MAX_DIMENSION or h > MAX_DIMENSION:
        raise errors.ImageTooLarge(w, h, MAX_DIMENSION)
    if options.color_type == ColorType.RGB:
        bpp = 3
    elif options.color_type == ColorType.GRAY:
        bpp = 1
    else:
        raise errors.UnsupportedColorType("JPEG supports RGB and Gray")
    expected = w * h * bpp
    if data_len != expected:
        raise errors.InvalidDataLength(expected, data_len)
    return bpp


def _device_coeffs_batch(
    imgs: torch.Tensor, lum_q, chrom_q, *, color: str, subsampling: str
) -> torch.Tensor:
    """[B, H, W, C?] uint8 -> [B, nblocks, 64] int16 zigzag coeffs, on
    ``imgs``' device. ``lum_q``/``chrom_q`` are the natural-order f32
    quantization tables."""
    mode = "gray" if color == "gray" else subsampling
    return coeffs(imgs, lum_q, chrom_q, mode)
