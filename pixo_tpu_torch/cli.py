"""Command-line interface.

Counterpart of the JAX package's ``cli.py``; flag and behavior parity with
pixo's CLI (``src/bin/pixo.rs:34-1132``): input PNG/JPEG/PPM(P6)/PGM(P5) or
stdin ``-`` with magic-byte detection, output format from extension or
``--format``, shared presets, JPEG quality/subsampling/restart/optimize-
huffman, PNG level/filter/alpha/reduce/strip flags, ``--grayscale``
(BT.601), ``--resize WxH``, verbose wall-clock timing, ``--json``,
``--quiet``, ``--dry-run``.

``--device cuda`` (the default) decodes a JPEG input's pixels, resizes and
encodes a JPEG on the card; ``--device cpu`` does all of it on the host. The
JAX package's ``--device cpu/tpu/default`` and the environment settings it
makes for them (its coefficient and resize tiers, its compile cache) have no
counterpart: the device decides, and the bytes are the same either way.
"""

from __future__ import annotations

import argparse
import json as jsonlib
import sys
import time
from pathlib import Path

import numpy as np

from . import __version__, errors
from .color import ColorType, to_grayscale_bt601
from .decode import decode_jpeg, decode_png
from .options import (
    FilterStrategy,
    JpegOptions,
    PngOptions,
    QuantizationMode,
    ResizeFilter,
    ResizeOptions,
    Subsampling,
)

_FILTERS = {
    "none": FilterStrategy.NONE,
    "sub": FilterStrategy.SUB,
    "up": FilterStrategy.UP,
    "average": FilterStrategy.AVERAGE,
    "paeth": FilterStrategy.PAETH,
    "minsum": FilterStrategy.MIN_SUM,
    "adaptive": FilterStrategy.ADAPTIVE,
    "adaptive-fast": FilterStrategy.ADAPTIVE_FAST,
    "bigrams": FilterStrategy.BIGRAMS,
}
_PRESETS = {"fast": 0, "balanced": 1, "max": 2}
_BY_CHANNELS = {1: ColorType.GRAY, 2: ColorType.GRAY_ALPHA, 3: ColorType.RGB, 4: ColorType.RGBA}


def detect_format_from_bytes(data: bytes) -> str:
    if data[:8] == bytes([0x89, 0x50, 0x4E, 0x47, 0x0D, 0x0A, 0x1A, 0x0A]):
        return "png"
    if data[:2] == b"\xff\xd8":
        return "jpeg"
    if data[:2] == b"P6":
        return "ppm"
    if data[:2] == b"P5":
        return "pgm"
    raise ValueError("unrecognized input format (not PNG/JPEG/PPM/PGM)")


def _parse_pnm(data: bytes):
    """P5/P6 parser (parity: ``src/bin/pixo.rs:247-335``)."""
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if pos < len(data) and data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    width, height, maxval = fields
    if maxval != 255:
        raise ValueError(f"unsupported PNM maxval {maxval}")
    channels = 3 if data[:2] == b"P6" else 1
    pixels = np.frombuffer(data, np.uint8, width * height * channels, pos)
    return pixels.reshape(height, width, channels), width, height


def _with_channels(img):
    px = img.pixels if img.pixels.ndim == 3 else img.pixels[..., None]
    return px, img.width, img.height, img.color_type


def load_image(data: bytes, fancy_upsampling: bool = False, *, device="cuda"):
    """-> (pixels [H, W, C] uint8 numpy, width, height, color_type). A JPEG's
    pixel tail runs on ``device`` ("cpu" or a CUDA device); PNG and PNM
    inputs decode on the host."""
    fmt = detect_format_from_bytes(data)
    if fmt == "png":
        return _with_channels(decode_png(data))
    if fmt == "jpeg":
        return _with_channels(decode_jpeg(data, fancy_upsampling=fancy_upsampling, device=device))
    px, w, h = _parse_pnm(data)
    ct = ColorType.RGB if px.shape[2] == 3 else ColorType.GRAY
    return px, w, h, ct


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pixo-tpu-torch",
        description="image compression on an NVIDIA GPU (PNG/JPEG encode, decode, resize)",
    )
    p.add_argument("input", help="input file (PNG/JPEG/PPM/PGM) or '-' for stdin")
    p.add_argument("-o", "--output", help="output path (format from extension)")
    p.add_argument("-f", "--format", choices=["png", "jpeg"], help="output format override")
    p.add_argument("-q", "--quality", type=int, default=85, help="JPEG quality 1-100")
    p.add_argument("--jpeg-optimize-huffman", action="store_true")
    p.add_argument("--jpeg-optimal-huffman", action="store_true",
                   help="package-merge tables (beyond parity; never larger)")
    p.add_argument("--jpeg-restart-interval", type=int, default=0, metavar="N")
    p.add_argument("--jpeg-progressive", action="store_true")
    p.add_argument("--jpeg-trellis", action="store_true")
    p.add_argument("-c", "--compression", type=int, help="PNG level 1-9")
    # s422 is beyond the reference's flag surface (its encoder has no 4:2:2
    # path; this one completes the matrix its decoder already reads)
    p.add_argument("--subsampling", choices=["s444", "s420", "s422"], default="s444")
    p.add_argument("--filter", choices=sorted(_FILTERS), help="PNG filter strategy")
    p.add_argument("--preset", choices=sorted(_PRESETS), help="compression preset")
    p.add_argument("--lossy", action="store_true", help="PNG palette quantization")
    p.add_argument("--png-optimize-alpha", action="store_true")
    p.add_argument("--interlace", action="store_true",
                   help="Adam7 interlaced PNG output (beyond parity)")
    p.add_argument("--png-reduce-color", action="store_true")
    p.add_argument("--png-strip-metadata", action="store_true")
    p.add_argument("--resize", metavar="WxH", help="resize before encoding")
    p.add_argument("--resize-filter", choices=["nearest", "bilinear", "lanczos3"],
                   default="lanczos3")
    p.add_argument("--fancy-upsampling", action="store_true",
                   help="libjpeg-style triangle chroma upsampling when decoding "
                        "subsampled JPEG input (default nearest, matching the "
                        "reference decoder)")
    p.add_argument("--grayscale", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true")
    p.add_argument("-n", "--dry-run", action="store_true")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the JPEG decode's pixels, the resize and the JPEG "
                        "encode run: cuda (default, the card) or cpu (the host); "
                        "the bytes are the same. The card's throughput surface is "
                        "the batch and stream library API (pixo_tpu_torch.parallel)")
    p.add_argument("--version", action="version", version=f"pixo-tpu-torch {__version__}")
    return p


def _jpeg_options(args, width: int, height: int, channels: int) -> JpegOptions:
    preset = _PRESETS.get(args.preset) if args.preset else None
    if preset is not None:
        jopts = JpegOptions.from_preset(width, height, args.quality, preset)
    else:
        jopts = JpegOptions(width=width, height=height, quality=args.quality)
    jopts.color_type = ColorType.GRAY if channels == 1 else ColorType.RGB
    if preset is None and args.subsampling != "s444":
        jopts.subsampling = Subsampling.S420 if args.subsampling == "s420" else Subsampling.S422
    if args.jpeg_optimize_huffman:
        jopts.optimize_huffman = True
    if args.jpeg_optimal_huffman:
        jopts.optimal_huffman = True
    if args.jpeg_progressive:
        jopts.progressive = True
    if args.jpeg_trellis:
        jopts.trellis_quant = True
    if args.jpeg_restart_interval > 0:
        jopts.restart_interval = args.jpeg_restart_interval
    return jopts


def _png_options(args, width: int, height: int, channels: int) -> PngOptions:
    preset = _PRESETS.get(args.preset) if args.preset else None
    if preset is not None:
        popts = PngOptions.from_preset_with_lossless(width, height, preset, not args.lossy)
    else:
        popts = PngOptions(width=width, height=height)
        if args.lossy:
            popts.quantization.mode = QuantizationMode.AUTO
            popts.quantization.dithering = True
    popts.color_type = _BY_CHANNELS[channels]
    if args.compression is not None:
        popts.compression_level = args.compression
    if args.filter is not None:
        popts.filter_strategy = _FILTERS[args.filter]
    if args.png_optimize_alpha:
        popts.optimize_alpha = True
    if args.png_reduce_color:
        popts.reduce_color_type = True
    if args.png_strip_metadata:
        popts.strip_metadata = True
    if args.interlace:
        popts.interlace = True
    return popts


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = args.device
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: --device cuda requested but no CUDA device is available",
                  file=sys.stderr)
            return 2
    t_start = time.perf_counter()

    try:
        data = sys.stdin.buffer.read() if args.input == "-" else Path(args.input).read_bytes()
        t0 = time.perf_counter()
        pixels, width, height, color_type = load_image(
            data, fancy_upsampling=args.fancy_upsampling, device=device)
        t_decode = time.perf_counter() - t0
    except (OSError, ValueError, errors.PixoError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1

    out_fmt = args.format
    out_path = Path(args.output) if args.output else None
    if out_fmt is None and out_path is not None:
        out_fmt = {".png": "png", ".jpg": "jpeg", ".jpeg": "jpeg"}.get(out_path.suffix.lower())
    if out_fmt is None:
        out_fmt = detect_format_from_bytes(data)
        if out_fmt in ("ppm", "pgm"):
            out_fmt = "png"

    if args.grayscale and pixels.shape[2] >= 3:
        pixels = to_grayscale_bt601(pixels[..., :3])[..., None]
        color_type = ColorType.GRAY

    if args.resize:
        try:
            dw, dh = (int(v) for v in args.resize.lower().split("x"))
        except ValueError:
            print("error: --resize expects WxH", file=sys.stderr)
            return 1
        from .resize import resize as do_resize

        opts = ResizeOptions(
            src_width=width, src_height=height, dst_width=dw, dst_height=dh,
            color_type=_BY_CHANNELS[pixels.shape[2]], filter=ResizeFilter(args.resize_filter),
        )
        pixels = do_resize(pixels, opts, device=device)
        width, height = dw, dh

    channels = pixels.shape[2]
    t0 = time.perf_counter()
    try:
        if out_fmt == "jpeg":
            if channels == 4:
                pixels, channels = pixels[..., :3], 3  # strip alpha (parity with the CLI)
            elif channels == 2:
                pixels, channels = pixels[..., :1], 1
            from . import jpeg as jpeg_mod

            src = pixels[..., 0] if channels == 1 else pixels
            out_bytes = jpeg_mod.encode(np.ascontiguousarray(src),
                                        _jpeg_options(args, width, height, channels), device=device)
        else:
            from . import png as png_mod

            src = pixels[..., 0] if channels == 1 else pixels
            out_bytes = png_mod.encode(np.ascontiguousarray(src),
                                       _png_options(args, width, height, channels), device=device)
    except errors.PixoError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    t_encode = time.perf_counter() - t0

    input_size = len(data)
    output_size = len(out_bytes)
    ratio = (output_size / input_size * 100.0) if input_size else 0.0

    if not args.dry_run:
        if out_path is None:
            sys.stdout.buffer.write(out_bytes)
        else:
            out_path.write_bytes(out_bytes)

    total = time.perf_counter() - t_start
    if args.json:
        print(jsonlib.dumps({
            "dry_run": args.dry_run,
            "input": args.input,
            "output": str(out_path) if out_path else "-",
            "format": out_fmt,
            "width": width,
            "height": height,
            "input_size": input_size,
            "output_size": output_size,
            "ratio": round(ratio, 1),
            "decode_ms": round(t_decode * 1000, 2),
            "encode_ms": round(t_encode * 1000, 2),
            "total_ms": round(total * 1000, 2),
        }))
    elif not args.quiet and out_path is not None:
        msg = (f"{args.input} -> {out_path} ({out_fmt}, {width}x{height}, "
               f"{input_size} -> {output_size} bytes, {ratio:.1f}%)")
        print(msg, file=sys.stderr)
        if args.verbose:
            print(f"  decode: {t_decode*1000:.1f} ms  encode: {t_encode*1000:.1f} ms"
                  f"  total: {total*1000:.1f} ms", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
