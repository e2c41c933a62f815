"""PNG encoder, 8-bit: quantization, reductions, host filter, native DEFLATE,
chunks.

Counterpart of the JAX package's ``png/encoder.py``, with pipeline parity with
pixo ``encode_into`` (``src/png/mod.rs:437-590``): validate -> [quantization]
-> color-type/palette reduction -> signature + IHDR (+PLTE/tRNS) -> alpha
optimization -> per-row filtering -> DEFLATE(zlib) -> IDAT 256 KiB chunks ->
IEND.

``encode`` is the per-image path. It quantizes and filters on the host (the
native tier), as the JAX package's does; the batch encode's fallback images
take it, and it is the reference the batch encode is held against.
``encode_indexed`` writes pre-indexed data with an explicit palette (the
lossy path's last stage). Options outside the ported slice raise
``NotImplementedError`` (``check_ported``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import errors
from ..color import ColorType
from ..compress.deflate import deflate_zlib
from ..options import MAX_DIMENSION, FilterStrategy, PngOptions, QuantizationMode
from ..ops.png_filters import apply_filters
from . import chunks, quantize, reduce


def check_ported(options: PngOptions) -> None:
    """Raise ``NotImplementedError`` for an option the port does not cover yet."""
    if options.interlace:
        raise NotImplementedError("Adam7 interlace is not ported yet (ROADMAP.md queue 1 item 8)")
    if options.bit_depth == 16:
        raise NotImplementedError("16-bit PNG is not ported yet (ROADMAP.md queue 1 item 8)")
    if options.filter_strategy == FilterStrategy.BIGRAMS or options.optimal_compression:
        raise NotImplementedError(
            "FilterStrategy.BIGRAMS and optimal_compression (the max preset) are not ported "
            "yet (ROADMAP.md queue 1 item 8)"
        )


def _validate(options: PngOptions, data_len: int) -> int:
    """data_len counts samples (any input dtype is cast to u8); returns
    bytes per pixel."""
    if not (1 <= options.compression_level <= 9):
        raise errors.InvalidCompressionLevel(options.compression_level)
    if options.bit_depth not in (8, 16):
        raise errors.CompressionError(f"unsupported bit depth {options.bit_depth} (8 or 16)")
    w, h = options.width, options.height
    if w == 0 or h == 0:
        raise errors.InvalidDimensions(w, h)
    if w > MAX_DIMENSION or h > MAX_DIMENSION:
        raise errors.ImageTooLarge(w, h, MAX_DIMENSION)
    bpp = options.color_type.bytes_per_pixel * (options.bit_depth // 8)
    expected = w * h * bpp
    if data_len != expected:
        raise errors.InvalidDataLength(expected, data_len)
    return bpp


def _as_pixels(data, options: PngOptions, bpp: int) -> np.ndarray:
    """-> [N, bpp] uint8 pixel matrix."""
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    else:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return arr.reshape(-1, bpp)


def _compress(filtered, options: PngOptions) -> bytes:
    # packed=True: the reference PNG path is deflate_zlib_packed (no block
    # splitting); it matters only in parity mode
    return deflate_zlib(filtered, options.compression_level, packed=True)


def _finish(out: bytearray, filtered, options: PngOptions) -> bytes:
    """DEFLATE the filtered stream and close the file (IDAT + IEND)."""
    compressed = _compress(filtered, options)
    chunks.write_idat_chunks(out, compressed)
    chunks.write_iend(out)
    return bytes(out)


def quantize_decision(pixels: np.ndarray, options: PngOptions) -> bool:
    """Whether ``encode`` quantizes these [N, bpp] pixels (parity:
    src/png/mod.rs:470-512): FORCE quantizes RGB and RGBA; AUTO those of
    them that the sampled heuristic accepts."""
    mode = options.quantization.mode
    if mode == QuantizationMode.OFF or options.color_type not in (ColorType.RGB, ColorType.RGBA):
        return False
    if mode == QuantizationMode.FORCE:
        return True
    return quantize.should_quantize_auto(pixels, max_colors(options))


def max_colors(options: PngOptions) -> int:
    """The palette size the quantizer aims at: at most 256 entries."""
    return min(options.quantization.max_colors, 256)


def encode_quantized(palette_rgba: np.ndarray, indices: np.ndarray, options: PngOptions) -> bytes:
    """The indexed file of a quantized image: PLTE from the palette, tRNS
    from its alpha where any is below 255 (trailing 255s trimmed)."""
    alpha = reduce.maybe_trim_transparency(palette_rgba[:, 3])
    return encode_indexed(indices, options.width, options.height, palette_rgba[:, :3], alpha,
                          options)


def encode(data, options: PngOptions) -> bytes:
    """Encode one 8-bit image (flat bytes or an [H, W, C] uint8 array) to
    PNG bytes, equal to the JAX package's ``png.encode``."""
    check_ported(options)
    data_len = data.size if isinstance(data, np.ndarray) else len(data)
    bpp = _validate(options, data_len)
    w, h = options.width, options.height
    pixels = _as_pixels(data, options, bpp)

    if quantize_decision(pixels, options):
        palette_rgba, indices = quantize.quantize_image(
            pixels, w, h, max_colors(options), options.quantization.dithering
        )
        return encode_quantized(palette_rgba, indices, options)

    out = bytearray()
    out += chunks.PNG_SIGNATURE
    red = reduce.maybe_reduce_color_type(
        pixels, w, h, options.color_type, options.reduce_color_type, options.reduce_palette,
    )
    chunks.write_ihdr(out, w, h, red.bit_depth, red.color_type_byte)
    if red.palette is not None:
        chunks.write_chunk(out, b"PLTE", red.palette[:, :3].tobytes())
        if (red.palette[:, 3] != 255).any():
            chunks.write_chunk(out, b"tRNS", red.palette[:, 3].tobytes())

    payload = red.data
    if options.optimize_alpha and red.palette is None and red.effective_color_type in (
        ColorType.RGBA, ColorType.GRAY_ALPHA
    ):
        px = np.frombuffer(payload, dtype=np.uint8).reshape(-1, red.bytes_per_pixel)
        payload = reduce.optimize_alpha(px, red.effective_color_type).tobytes()

    if red.bit_depth < 8:
        row_bytes = (w * red.bit_depth + 7) // 8
    else:
        row_bytes = w * red.bytes_per_pixel
    filtered = apply_filters(
        payload, w, h, row_bytes, red.bytes_per_pixel, options.filter_strategy,
        verbose_filter_log=options.verbose_filter_log,
    )
    # strip_metadata: the encoder writes no ancillary metadata chunks, so
    # stripping is a no-op here
    return _finish(out, filtered, options)


def encode_indexed(
    data,
    width: int,
    height: int,
    palette: np.ndarray,
    transparency: Optional[np.ndarray] = None,
    options: Optional[PngOptions] = None,
) -> bytes:
    """Encode pre-indexed data with an explicit palette, equal to the JAX
    package's ``png.encode_indexed``.

    Parity: ``encode_indexed_into`` (``src/png/mod.rs:1814-1886``): 8-bit
    indexed, palette-aware filter override (the adaptive strategies become
    None). Interlace and optimal compression raise ``NotImplementedError``.
    """
    options = options or PngOptions(width=width, height=height)
    if options.interlace or options.optimal_compression:
        raise NotImplementedError(
            "Adam7 interlace and optimal_compression are not ported yet (ROADMAP.md queue 1 item 8)"
        )
    palette = np.asarray(palette, dtype=np.uint8).reshape(-1, 3)
    if not (1 <= len(palette) <= 256):
        raise errors.CompressionError(
            f"Invalid palette length: {len(palette)} (must be 1-256)"
        )
    if transparency is not None:
        transparency = np.asarray(transparency, dtype=np.uint8).reshape(-1)
        if len(transparency) > len(palette):
            raise errors.CompressionError(
                f"Transparency length {len(transparency)} exceeds palette "
                f"length {len(palette)}"
            )
    if isinstance(data, np.ndarray):
        indexed = np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    else:
        indexed = np.frombuffer(bytes(data), dtype=np.uint8)
    expected = width * height
    if indexed.size != expected:
        raise errors.InvalidDataLength(expected, indexed.size)

    out = bytearray()
    out += chunks.PNG_SIGNATURE
    chunks.write_ihdr(out, width, height, 8, 3)
    chunks.write_chunk(out, b"PLTE", palette.tobytes())
    if transparency is not None:
        chunks.write_chunk(out, b"tRNS", transparency.tobytes())

    strategy = options.filter_strategy
    if strategy in (
        FilterStrategy.ADAPTIVE,
        FilterStrategy.ADAPTIVE_FAST,
        FilterStrategy.MIN_SUM,
        FilterStrategy.BIGRAMS,
    ):
        strategy = FilterStrategy.NONE
    filtered = apply_filters(
        indexed.tobytes(), width, height, width, 1, strategy,
        verbose_filter_log=options.verbose_filter_log,
    )
    return _finish(out, filtered, options)
