"""JPEG encoder: option validation, the coefficient stage, the host entropy
stage and the single-image and batch entry points.

Counterpart of the JAX package's ``jpeg/encoder.py`` (parity with pixo
``src/jpeg/mod.rs:328-447``). The coefficient chain is, for every block of
every image: pad -> fixed-point RGB->YCbCr -> level shift -> MCU blockify
(scan order) -> AAN f32 DCT -> quantize (round half away) -> zigzag. Then,
on the host: [optimize_huffman] symbol histograms -> canonical tables (a
16-bit overflow falls back to the K.3 standard tables) -> Huffman bit-pack
with 0xFF stuffing and restart markers, or the progressive scans ->
marker framing. With ``trellis_quant`` (the ``max`` preset) the progressive
pass takes trellis-quantized coefficients instead (the unquantized zigzag
DCT, then a Viterbi DP per block: ``ops/trellis_device.py``); a baseline
encode ignores the option, as the reference's baseline scan does.

The ``device`` argument picks the tier, where the JAX package reads its
``PIXO_TPU_COEFFS``, ``PIXO_TPU_HUFFMAN`` and ``PIXO_TPU_TRELLIS`` knobs:

- ``device="cpu"``: the reference's host tier (its ``auto_host_tier`` under a
  CPU backend): the host library's coefficients and count per image, or its
  fused coefficient + pack call for the baseline standard-table encode; for
  the trellis, its unquantized DCT and its DP;
- a CUDA device: the batch path of ``parallel/pipeline.py``; the
  coefficient chain is one hand-written kernel (``ops/kernels.py::coeffs``),
  the optimized-Huffman count another (``count_symbols``), the trellis' DCT
  and DP two more (``dct_zz``, ``trellis_quantize``). ``encode`` is a batch
  of one there.
"""

from __future__ import annotations

import concurrent.futures
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import errors
from ..color import ColorType
from ..options import MAX_DIMENSION, JpegOptions
from ..ops.blockify import scan_layout
from . import markers
from .tables import ZIGZAG, HuffmanTables, QuantizationTables


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
    from ..ops.kernels import coeffs  # the kernels import the decode's ops, which import jpeg/

    mode = "gray" if color == "gray" else subsampling
    return coeffs(imgs, lum_q, chrom_q, mode)


def _mode(options: JpegOptions) -> str:
    return "gray" if options.color_type == ColorType.GRAY else options.subsampling.value


def _pattern(options: JpegOptions):
    """(blocks an image, the MCU's component pattern)."""
    color = "gray" if options.color_type == ColorType.GRAY else "rgb"
    n_mcus, bpm, pattern = scan_layout(options.width, options.height, color,
                                       options.subsampling.value)
    return n_mcus * bpm, pattern


def compute_coefficients_host(
    img: np.ndarray, options: JpegOptions, quant: QuantizationTables
) -> np.ndarray:
    """Host coefficient pipeline of one image (the host library's AVX2
    chain): [nblocks, 64] int16 zigzag, bit-equal to the ``coeffs`` kernel."""
    from ..native import native_jpeg_coefficients

    return native_jpeg_coefficients(img, _mode(options), quant.luminance_table,
                                    quant.chrominance_table)


def compute_coefficients(img: np.ndarray, options: JpegOptions, quant: QuantizationTables, *,
                         device="cuda") -> np.ndarray:
    """Coefficient pipeline of one [H, W(, 3)] uint8 image: [nblocks, 64]
    int16 zigzag on the host. On a card the coefficient kernel, as a batch of
    one; with ``device="cpu"`` the host library's chain
    (``compute_coefficients_host``). The two are bit-equal."""
    if _on_cpu(device):
        return compute_coefficients_host(img, options, quant)
    x = torch.from_numpy(np.ascontiguousarray(img))[None].to(device)
    color = "gray" if options.color_type == ColorType.GRAY else "rgb"
    return _device_coeffs_batch(x, quant.luminance_table, quant.chrominance_table, color=color,
                                subsampling=options.subsampling.value)[0].cpu().numpy()


def zigzag_tables(quant: QuantizationTables):
    """(luminance, chrominance) quantization tables in zigzag order, f32:
    the trellis' tables."""
    return (quant.luminance_table[ZIGZAG].astype(np.float32),
            quant.chrominance_table[ZIGZAG].astype(np.float32))


def _trellis_coefficients(
    img: np.ndarray, options: JpegOptions, quant: QuantizationTables, pattern: Sequence[int]
) -> np.ndarray:
    """The progressive pass's trellis-quantized [nblocks, 64] int16 zigzag
    coefficients of one image, on the host: the host library's unquantized
    DCT (the coefficient chain's op order, bit-equal to ``dct_zz``), then its
    trellis DP."""
    from ..native import native_jpeg_dct_zz, native_trellis_quantize

    return native_trellis_quantize(native_jpeg_dct_zz(img, _mode(options)), pattern,
                                   *zigzag_tables(quant))


def _pack(
    zz: np.ndarray,
    pattern: Sequence[int],
    tables: HuffmanTables,
    restart_interval: Optional[int],
) -> bytes:
    from ..native import native_pack_scan

    return native_pack_scan(zz, pattern, tables, restart_interval)


def tables_from_counts(dc, ac, options: JpegOptions) -> HuffmanTables:
    """One image's tables from its symbol counts ((dc_lum, dc_chrom) and
    (ac_lum, ac_chrom) histograms): ``optimized_from_counts`` (gray passes no
    chroma counts), or the standard tables where that overflows."""
    gray = options.color_type == ColorType.GRAY
    built = HuffmanTables.optimized_from_counts(
        dc[0], None if gray else dc[1], ac[0], None if gray else ac[1],
        optimal=options.optimal_huffman,
    )
    return built if built is not None else HuffmanTables.default()


def _build_tables(
    zz: np.ndarray,
    pattern: Sequence[int],
    options: JpegOptions,
) -> HuffmanTables:
    if not (options.optimize_huffman or options.optimal_huffman):
        return HuffmanTables.default()
    from ..native import native_count_symbols

    dc_lum, dc_chrom, ac_lum, ac_chrom = native_count_symbols(zz, pattern, options.restart_interval)
    return tables_from_counts((dc_lum, dc_chrom), (ac_lum, ac_chrom), options)


def _as_image_array(data, options: JpegOptions, bpp: int) -> np.ndarray:
    if isinstance(data, np.ndarray) and data.ndim >= 2:
        arr = data
    else:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
        shape = (options.height, options.width) if bpp == 1 else (
            options.height, options.width, bpp)
        arr = arr.reshape(shape)
    if arr.dtype != np.uint8:
        raise errors.UnsupportedColorType("pixel data must be uint8")
    if bpp == 1 and arr.ndim == 3:
        arr = arr[..., 0]
    return np.ascontiguousarray(arr)


def _emit_jpeg(
    zz: Optional[np.ndarray],
    img: Optional[np.ndarray],
    options: JpegOptions,
    quant: QuantizationTables,
    pattern: Sequence[int],
) -> bytes:
    """Frame + entropy-code one image from its coefficients ``zz``; with
    ``zz`` None (the baseline standard-table encode, ``_fused_ok``), the
    host library's fused call computes them from ``img``. A progressive
    encode with ``trellis_quant`` takes the trellis-quantized coefficients
    as ``zz`` (the trellis applies to the progressive pass only; the
    callers compute them once an image, where the reference recomputes them
    in every call)."""
    out = bytearray()
    markers.write_soi(out)
    markers.write_app0(out)
    markers.write_dqt(out, quant)
    if options.progressive:
        from . import progressive

        sa = getattr(options, "progressive_sa", True)
        huff = None
        if not sa:
            # Single-table mode (parity script): tables counted over the
            # actual scan symbols so EOBn codes exist (progressive.py's
            # divergence note), one DHT up front.
            script = progressive.get_script(options)
            comp_blocks = progressive.split_components(
                zz, pattern, options.width, options.height
            )
            is_gray = options.color_type == ColorType.GRAY
            huff = progressive.build_progressive_tables(
                comp_blocks, script, is_gray, optimal=options.optimal_huffman
            )
            if huff is None:
                huff = HuffmanTables()
        markers.write_sof(
            out, markers.SOF2, options.width, options.height,
            options.color_type, options.subsampling,
        )
        if huff is not None:
            markers.write_dht(out, huff)
        # SA mode: per-scan optimized tables, each DHT emitted by
        # encode_progressive right before its scan (libjpeg/mozjpeg
        # optimize_coding scheme).
        # restart_interval is ignored in progressive mode: the progressive
        # scan coders emit no RSTn markers, so advertising a DRI interval
        # desyncs decoders (the reference has this bug — it writes DRI at
        # src/jpeg/mod.rs:409 but its scans never restart; not reproduced).
        progressive.encode_progressive(out, zz, pattern, options, huff)
    else:
        huff = (
            _build_tables(zz, pattern, options)
            if zz is not None
            else HuffmanTables.default()
        )
        markers.write_sof(
            out, markers.SOF0, options.width, options.height,
            options.color_type, options.subsampling,
        )
        markers.write_dht(out, huff)
        if options.restart_interval is not None:
            markers.write_dri(out, options.restart_interval)
        markers.write_sos(out, options.color_type)
        if zz is None:
            # Fused tier (see _fused_ok): coefficients + pack in one host
            # library call, byte-identical to the two-stage path.
            from ..native import native_jpeg_encode_scan

            out += native_jpeg_encode_scan(
                img, _mode(options), quant.luminance_table, quant.chrominance_table,
                pattern, huff, options.restart_interval,
            )
        else:
            out += _pack(zz, pattern, huff, options.restart_interval)
    markers.write_eoi(out)
    return bytes(out)


def _emit_with_sa_fallback(
    zz, img, options: JpegOptions, quant: QuantizationTables,
    pattern: Sequence[int], n_blocks: int,
) -> bytes:
    """_emit_jpeg plus the small-image SA fallback, shared by the
    single-image and batch entry points so batch == single byte-for-byte.

    Small images: the SA script's 18 per-scan DHT+SOS headers can
    outweigh its entropy win (measured crossover is well under 2048
    blocks); emit the 7-scan single-table variant too and keep the
    smaller file. Cheap where it triggers — blocks are few."""
    out = _emit_jpeg(zz, img, options, quant, pattern)
    if (
        options.progressive
        and getattr(options, "progressive_sa", True)
        and n_blocks <= 2048
    ):
        alt = _emit_jpeg(zz, img, options.replace(progressive_sa=False), quant, pattern)
        if len(alt) < len(out):
            return alt
    return out


def _fused_ok(options: JpegOptions) -> bool:
    """True when the baseline default-table configuration (exactly the
    fast preset) can take the single-call fused host path: coefficients +
    pack in C++, no [nblocks, 64] int16 array. Optimized-Huffman encodes
    need the coefficient array for the counting pass, and progressive ones
    split it into components, so neither fuses."""
    if options.progressive or options.optimize_huffman or options.optimal_huffman:
        return False
    if _mode(options) == "422":
        # the fused call counts 4:2:2's blocks as 4:2:0's (core.cpp:7486-7493)
        # and fails; the JAX package then packs the two-stage path's
        # coefficients, and so does this tier
        return False
    from ..native import native_has_fused_encode

    return native_has_fused_encode()


def encode_host(img: np.ndarray, options: JpegOptions) -> bytes:
    """The host tier of one validated [H, W(, 3)] uint8 image."""
    quant = QuantizationTables(options.quality)
    n_blocks, pattern = _pattern(options)
    if options.progressive and options.trellis_quant:
        # no plain-quantized pass: the progressive scans read the trellis'
        zz = _trellis_coefficients(img, options, quant, pattern)
    elif _fused_ok(options):
        zz = None
    else:
        zz = compute_coefficients_host(img, options, quant)
    return _emit_with_sa_fallback(zz, img, options, quant, pattern, n_blocks)


def _on_cpu(device) -> bool:
    return torch.device(device).type == "cpu"


def encode(data, options: JpegOptions, *, device="cuda") -> bytes:
    """Encode one image (flat bytes or [H, W(, 3)] uint8 array) to JPEG
    bytes: on the host library with ``device="cpu"``, else as a batch of one
    on ``device``. Byte-identical to the JAX package's ``jpeg.encode``."""
    data_len = data.size if isinstance(data, np.ndarray) else len(data)
    bpp = _validate(options, data_len)
    img = _as_image_array(data, options, bpp)
    if _on_cpu(device):
        return encode_host(img, options)
    return encode_batch(img[None], options, device=device)[0]


def encode_batch(imgs, options: JpegOptions, *, device="cuda") -> List[bytes]:
    """Encode a batch [B, H, W, 3] (or [B, H, W] gray) of same-shape uint8
    images. With ``device="cpu"`` each image takes the host tier on a thread
    pool (ctypes releases the GIL); on a CUDA device the batch goes through
    ``parallel/pipeline.py::encode_jpeg_batch_sharded``."""
    if len(imgs) == 0:
        return []
    if not _on_cpu(device):
        from ..parallel.pipeline import encode_jpeg_batch_sharded

        return encode_jpeg_batch_sharded(imgs, options, device=device)
    imgs = imgs.numpy() if torch.is_tensor(imgs) else np.asarray(imgs)
    bpp = _validate(options, imgs[0].size)
    with concurrent.futures.ThreadPoolExecutor() as ex:
        return list(ex.map(lambda im: encode_host(_as_image_array(im, options, bpp), options), imgs))
