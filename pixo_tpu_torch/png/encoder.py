"""PNG encoder: quantization, reductions, host filter, native DEFLATE, chunks.

Counterpart of the JAX package's ``png/encoder.py``, with pipeline parity with
pixo ``encode_into`` (``src/png/mod.rs:437-590``): validate -> [quantization]
-> color-type/palette reduction -> signature + IHDR (+PLTE/tRNS) -> alpha
optimization -> per-row filtering -> DEFLATE(zlib) -> IDAT 256 KiB chunks ->
IEND. Beyond the reference, as in the JAX package: Adam7 interlace (each pass
filtered as an image of its own) and 16-bit input (the big-endian byte
stream, with no reductions or quantization).

``encode`` is the per-image path. It quantizes and filters on the host (the
native tier), as the JAX package's does; the batch encode's per-image images
take it, and it is the reference the batch encode is held against.
``encode_indexed`` writes pre-indexed data with an explicit palette (the
lossy path's last stage). ``encode_batch`` encodes a batch on the card
(``parallel/pipeline.py::encode_png_batch_sharded``) or, with
``device="cpu"``, image by image on a pool of threads.
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Optional

import numpy as np
import torch

from .. import errors
from ..color import ColorType
from ..compress.deflate import deflate_optimal_zlib, deflate_zlib
from ..options import MAX_DIMENSION, FilterStrategy, PngOptions, QuantizationMode
from ..ops.png_filters import apply_filters
from . import chunks, quantize, reduce


def _validate(options: PngOptions, data_len: int) -> int:
    """data_len counts samples at 8-bit (any input dtype is cast to u8) and
    bytes at 16-bit; returns bytes per pixel at the option depth."""
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


def _compress(filtered, options: PngOptions, device) -> bytes:
    if options.optimal_compression:
        return deflate_optimal_zlib(filtered, 5, device=device)
    # packed=True: the reference PNG path is deflate_zlib_packed (no block
    # splitting); it matters only in parity mode
    return deflate_zlib(filtered, options.compression_level, packed=True)


def _filter_adam7(samples: np.ndarray, bit_depth: int, bpp: int, strategy: FilterStrategy,
                  verbose_filter_log: bool = False) -> bytes:
    """Filter an image as its 7 Adam7 passes and join the streams.

    ``samples`` is [H, W, bpp] uint8 at 8 bits (and for 16-bit bytes), or
    [H, W] unpacked samples below 8 bits: each pass is an image of its own,
    its rows packed at the pass's width and filtered alone (filters never
    cross passes, PNG spec 8.2)."""
    # the decoder's table of the pass grid keeps encode and decode in step
    from ..decode.png_decoder import ADAM7_PASSES

    parts = []
    for x0, y0, dx, dy in ADAM7_PASSES:
        sub = samples[y0::dy, x0::dx]
        ph, pw = sub.shape[:2]
        if ph == 0 or pw == 0:
            continue
        if bit_depth == 8:
            payload, row_bytes, fbpp = np.ascontiguousarray(sub).tobytes(), pw * bpp, bpp
        else:
            payload = reduce.pack_bits_rows(np.ascontiguousarray(sub).reshape(-1), pw, bit_depth)
            row_bytes, fbpp = (pw * bit_depth + 7) // 8, 1
        parts.append(apply_filters(payload, pw, ph, row_bytes, fbpp, strategy,
                                   verbose_filter_log=verbose_filter_log))
    return b"".join(parts)


def _filter_stage(payload, samples: np.ndarray, row_bytes: int, bit_depth: int, bpp: int,
                  options: PngOptions, filter_fn) -> bytes:
    """``encode``'s filter stage: by Adam7 pass on ``samples`` (see
    ``_filter_adam7``) when interlaced, else the rows of ``payload`` through
    ``filter_fn`` or the host filter."""
    w, h, strategy = options.width, options.height, options.filter_strategy
    if options.interlace:
        # Adam7 filters per pass through its own path: a per-row filter
        # override (the row-sharded encode's) cannot apply, and is refused
        if filter_fn is not None:
            raise errors.CompressionError(
                "filter_fn override is incompatible with interlaced output")
        return _filter_adam7(samples, bit_depth, bpp, strategy, options.verbose_filter_log)
    if filter_fn is not None:
        return filter_fn(payload, w, h, row_bytes, bpp, strategy)
    return apply_filters(payload, w, h, row_bytes, bpp, strategy,
                         verbose_filter_log=options.verbose_filter_log)


def _finish(out: bytearray, filtered, options: PngOptions, device) -> bytes:
    """DEFLATE the filtered stream and close the file (IDAT + IEND); the
    optimal DEFLATE's ``PIXO_TPU_LZ77=device`` route runs on ``device``."""
    compressed = _compress(filtered, options, device)
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


def encode_quantized(palette_rgba: np.ndarray, indices: np.ndarray, options: PngOptions, *,
                     device="cuda") -> bytes:
    """The indexed file of a quantized image: PLTE from the palette, tRNS
    from its alpha where any is below 255 (trailing 255s trimmed)."""
    alpha = reduce.maybe_trim_transparency(palette_rgba[:, 3])
    return encode_indexed(indices, options.width, options.height, palette_rgba[:, :3], alpha,
                          options, device=device)


def _data_len(data, options: PngOptions) -> int:
    """The length ``_validate`` checks: elements at 8-bit (any dtype is cast
    to u8, the historical contract), bytes at 16-bit, where a 2-byte dtype
    counts 2."""
    if not isinstance(data, np.ndarray):
        return len(data)
    wide = options.bit_depth == 16 and data.dtype.itemsize == 2
    return data.size * (data.dtype.itemsize if wide else 1)


def _payload16(data) -> bytes:
    """16-bit input as the big-endian sample bytes PNG stores: a uint16 array
    in any byte order, a uint8 array or bytes already in that order."""
    if isinstance(data, np.ndarray) and data.dtype.itemsize == 2:
        if data.dtype.kind != "u":
            raise errors.CompressionError(
                f"16-bit input must be uint16 or raw bytes, got {data.dtype}")
        return data.astype(">u2").tobytes()  # '<u2', '=u2' and '>u2' alike
    if isinstance(data, np.ndarray):
        if data.dtype != np.uint8:
            raise errors.CompressionError(
                f"16-bit input must be uint16 or raw bytes, got {data.dtype}")
        return np.ascontiguousarray(data).tobytes()
    return bytes(data)


def _encode16(data, options: PngOptions, bpp: int, filter_fn, device) -> bytes:
    """The 16-bit branch of ``encode``: the big-endian byte stream filtered
    with the byte offset bpp = channels * 2; no quantization or reductions."""
    if options.quantization.mode != QuantizationMode.OFF:
        raise errors.CompressionError("quantization requires 8-bit input")
    w, h = options.width, options.height
    payload = _payload16(data)
    out = bytearray()
    out += chunks.PNG_SIGNATURE
    chunks.write_ihdr(out, w, h, 16, options.color_type.png_color_type,
                      interlace=int(options.interlace))
    samples = np.frombuffer(payload, np.uint8).reshape(h, w, bpp)  # Adam7 takes bytes at 16-bit
    filtered = _filter_stage(payload, samples, w * bpp, 8, bpp, options, filter_fn)
    return _finish(out, filtered, options, device)


def encode(data, options: PngOptions, *, filter_fn=None, device="cuda") -> bytes:
    """Encode one image (flat bytes or an [H, W, C] array: uint8, or at
    16-bit uint16 in any byte order or big-endian bytes) to PNG bytes, equal
    to the JAX package's ``png.encode``.

    ``filter_fn`` replaces the filter stage (``apply_filters``' arguments
    without the keywords): the row-sharded encode's
    (``parallel/pipeline.py::encode_png_row_sharded``). Interlaced output
    refuses it. The image is encoded on the host; ``device`` is read only
    by the optimal DEFLATE's ``PIXO_TPU_LZ77=device`` route."""
    bpp = _validate(options, _data_len(data, options))
    if options.bit_depth == 16:
        return _encode16(data, options, bpp, filter_fn, device)
    w, h = options.width, options.height
    pixels = _as_pixels(data, options, bpp)

    if quantize_decision(pixels, options):
        palette_rgba, indices = quantize.quantize_image(
            pixels, w, h, max_colors(options), options.quantization.dithering
        )
        return encode_quantized(palette_rgba, indices, options, device=device)

    out = bytearray()
    out += chunks.PNG_SIGNATURE
    red = reduce.maybe_reduce_color_type(
        pixels, w, h, options.color_type, options.reduce_color_type, options.reduce_palette,
    )
    chunks.write_ihdr(out, w, h, red.bit_depth, red.color_type_byte,
                      interlace=int(options.interlace))
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
        samples = red.samples.reshape(h, w)
    else:
        row_bytes = w * red.bytes_per_pixel
        samples = np.frombuffer(payload, np.uint8).reshape(h, w, red.bytes_per_pixel)
    filtered = _filter_stage(payload, samples, row_bytes, red.bit_depth, red.bytes_per_pixel,
                             options, filter_fn)
    # strip_metadata: the encoder writes no ancillary metadata chunks, so
    # stripping is a no-op here
    return _finish(out, filtered, options, device)


def encode_indexed(
    data,
    width: int,
    height: int,
    palette: np.ndarray,
    transparency: Optional[np.ndarray] = None,
    options: Optional[PngOptions] = None,
    *,
    device="cuda",
) -> bytes:
    """Encode pre-indexed data with an explicit palette, equal to the JAX
    package's ``png.encode_indexed``.

    Parity: ``encode_indexed_into`` (``src/png/mod.rs:1814-1886``): 8-bit
    indexed, palette-aware filter override (the adaptive strategies and
    Bigrams become None); interlaced and optimally compressed as the options
    say; ``device`` as ``encode``'s.
    """
    options = options or PngOptions(width=width, height=height)
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
    chunks.write_ihdr(out, width, height, 8, 3, interlace=int(options.interlace))
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
    if options.interlace:
        filtered = _filter_adam7(indexed.reshape(height, width, 1), 8, 1, strategy,
                                 options.verbose_filter_log)
    else:
        filtered = apply_filters(
            indexed.tobytes(), width, height, width, 1, strategy,
            verbose_filter_log=options.verbose_filter_log,
        )
    return _finish(out, filtered, options, device)


def encode_batch(imgs, options: PngOptions, *, device="cuda") -> List[bytes]:
    """Encode a batch [B, H, W, C] of same-shape images, each file equal to
    ``encode`` of its image.

    On a CUDA device the batch goes to the fused batch encode
    (``parallel.encode_png_batch_sharded``); an error there raises. With
    ``device="cpu"`` the images encode one by one on a pool of 8 threads
    (the native stages release the GIL), the JAX package's branch for its
    CPU backend."""
    if torch.device(device).type != "cpu":
        from ..parallel import encode_png_batch_sharded

        return encode_png_batch_sharded(imgs, options, device=device)
    imgs = imgs.numpy() if torch.is_tensor(imgs) else imgs
    if len(imgs) > 1:
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            return list(ex.map(lambda img: encode(img, options, device=device), imgs))
    return [encode(img, options, device=device) for img in imgs]
