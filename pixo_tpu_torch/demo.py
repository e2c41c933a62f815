"""End-to-end demo (the web playground analog): compress one image every way
the package supports and print a size report.

Counterpart of the JAX package's ``examples/demo.py``, on the card by
default:

    python -m pixo_tpu_torch.demo [input.png|input.jpg] [--device cuda|cpu]

Without an input, a synthetic photographic 512x384 image is used.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np


def synthetic_photo() -> np.ndarray:
    """A 384x512 RGB gradient with seeded noise: photographic statistics."""
    from .utils.synthetic import synth_gradient

    g = synth_gradient(384, 512, 3).astype(np.int32)
    noise = np.random.default_rng(0).integers(-18, 19, g.shape)
    return np.clip(g + noise, 0, 255).astype(np.uint8)


def compress_every_way(img: np.ndarray, *, device="cuda") -> List[Tuple[str, bytes]]:
    """(name, file) for each way of compressing the [H, W, 3] uint8 ``img``:
    JPEG at the three presets, PNG at the three presets, and the lossy PNG
    (128 colours, dithered)."""
    from . import jpeg, png
    from .color import ColorType
    from .options import JpegOptions, PngOptions, QuantizationMode

    h, w = img.shape[:2]
    rgb = dict(color_type=ColorType.RGB)
    lossy = PngOptions.balanced(w, h).replace(**rgb)
    lossy.quantization.mode = QuantizationMode.FORCE
    lossy.quantization.max_colors = 128
    lossy.quantization.dithering = True
    ways = [
        ("JPEG fast q85", lambda: jpeg.encode(img, JpegOptions.fast(w, h, 85), device=device)),
        ("JPEG balanced q85", lambda: jpeg.encode(img, JpegOptions.balanced(w, h, 85), device=device)),
        ("JPEG max q85 (prog+trellis)", lambda: jpeg.encode(img, JpegOptions.max(w, h, 85), device=device)),
        ("PNG fast", lambda: png.encode(img, PngOptions.fast(w, h).replace(**rgb), device=device)),
        ("PNG balanced", lambda: png.encode(img, PngOptions.balanced(w, h).replace(**rgb), device=device)),
        ("PNG max (optimal deflate)", lambda: png.encode(img, PngOptions.max(w, h).replace(**rgb),
                                                         device=device)),
        ("PNG lossy 128c dithered", lambda: png.encode(img, lossy, device=device)),
    ]
    return [(name, bytes(make())) for name, make in ways]


def thumbnail_round_trip(img: np.ndarray, *, device="cuda") -> bytes:
    """JPEG at q90, decoded, resized to 128x128 with Lanczos3 and encoded
    again at q85, each step on ``device``."""
    from . import jpeg
    from .color import ColorType
    from .decode import decode_jpeg
    from .options import JpegOptions, ResizeFilter, ResizeOptions
    from .resize import resize

    h, w = img.shape[:2]
    dec = decode_jpeg(jpeg.encode(img, JpegOptions.fast(w, h, 90), device=device), device=device)
    thumb = resize(dec.pixels, ResizeOptions(src_width=w, src_height=h, dst_width=128, dst_height=128,
                                             color_type=ColorType.RGB, filter=ResizeFilter.LANCZOS3),
                   device=device)
    return jpeg.encode(np.asarray(thumb), JpegOptions.fast(128, 128, 85), device=device)


def main(argv=None) -> int:
    from .cli import load_image

    ap = argparse.ArgumentParser(prog="python -m pixo_tpu_torch.demo",
                                 description="compress one image every way and print the sizes")
    ap.add_argument("input", nargs="?", help="a PNG or JPEG file (default: a synthetic photo)")
    ap.add_argument("--device", default="cuda", help="where the work runs: cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    if args.input:
        with open(args.input, "rb") as f:
            data = f.read()
        img, w, h, _ = load_image(data, device=args.device)
        img = np.ascontiguousarray(img[..., :3] if img.shape[2] >= 3 else np.repeat(img[..., :1], 3, 2))
        print(f"input: {args.input} ({w}x{h}, {len(data)} bytes)")
    else:
        img = synthetic_photo()
        print(f"input: synthetic photographic {img.shape[1]}x{img.shape[0]}")
    raw = img.nbytes
    print(f"\n{'codec':30s} {'bytes':>9s} {'vs raw':>8s}")
    for name, out in compress_every_way(img, device=args.device):
        print(f"{name:30s} {len(out):9d} {len(out) / raw * 100:7.1f}%")
    print(f"\nthumbnail pipeline: decode -> 128x128 lanczos -> re-encode "
          f"= {len(thumbnail_round_trip(img, device=args.device))} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
