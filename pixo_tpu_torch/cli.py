"""The input front of the command line: format detection and image loading.

Counterpart of the part of the JAX package's ``cli.py`` that the thumbnail
pipeline needs (parity with pixo ``src/bin/pixo.rs:247-335``): PNG, JPEG,
PPM (P6) and PGM (P5) by their magic bytes. The argument parser and the
transcode command are not ported yet (ROADMAP queue 1 item 12b).
"""

from __future__ import annotations

import numpy as np

from .color import ColorType
from .decode import decode_jpeg, decode_png


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
