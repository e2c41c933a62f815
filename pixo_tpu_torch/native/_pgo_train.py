"""Training battery of the host library's profile-guided build.

``native.load()``'s build (``utils/build.py``) runs it in a subprocess
between the instrumented compile and the compile that reads the profile:

    python -m pixo_tpu_torch.native._pgo_train <instrumented library>

It loads that library (``native._load_instrumented``; it never builds one)
and drives deterministic synthetic inputs through the port's public API
with ``device="cpu"``, so that every entry point of the host library that a
path of the port calls runs, the card paths' first: the padded and dense
JPEG packers, the progressive scans, the trellis and the decode's entropy
stage, then the host tiers, DEFLATE and INFLATE, the PNG filters, the lossy
PNG's palette work and the checksums. GCC lays out as cold what the
training never ran, so what it leaves out runs slower. Entry points that
only the tests call (``resize_lanczos3_host``, the parity mirror of the
optimal parse) stay cold. The inputs are the JAX package's training
payloads and its 160x160 image, and images made from them; none is a
fixture or an input that ``chip_smoke.py`` times, so the profile is not
fitted to the timed inputs. The library's counters are atomic
(``utils/build.py``), and every pool here has one thread.

Imports numpy, torch and the port only. Keep it under about 30 s on one
core: every first build pays it under the build lock.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np

ROUTE_VARIABLES = ("PIXO_TPU_DEFLATE_PARITY", "PIXO_TPU_LZ77", "PIXO_TPU_DECODE_PIXELS")


@contextlib.contextmanager
def _env(**values):
    """The port's route variables as ``values`` gives them (unset for the
    others) for the block, restored after it."""
    saved = {k: os.environ.get(k) for k in ROUTE_VARIABLES}
    try:
        for k in ROUTE_VARIABLES:
            os.environ.pop(k, None)
        os.environ.update(values)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _payloads():
    """The JAX package's DEFLATE training payloads (``pixo_tpu/native/
    _pgo_train.py``): text, random bytes, photo-like residual rows, gradient
    residuals and Sub-filtered RGB rows."""
    rng = np.random.default_rng(0)
    text = (b"the quick brown fox jumps over the lazy dog. " * 6000)[: 256 << 10]
    rand = rng.integers(0, 256, 256 << 10, dtype=np.uint8).tobytes()
    # photo-like residual rows: smooth noise differentiated along rows
    base = rng.normal(0, 40, (128, 2048)).cumsum(axis=1)
    photo = np.diff(base, axis=1, prepend=0).astype(np.int16).astype(np.uint8).tobytes()
    # gradient residuals: long zero runs with periodic nonzeros
    ramp = np.tile(np.arange(2048, dtype=np.uint8), (128, 1))
    resid = np.diff(ramp.astype(np.int16), axis=1, prepend=0).astype(np.uint8).tobytes()
    # Sub-filtered interleaved RGB rows: the photographic-residual class the
    # PNG encoder deflates (bpp-strided diffs of smooth channels)
    yy, xx = np.mgrid[0:96, 0:1024].astype(np.float32)
    chans = [
        np.clip(120 + 70 * np.sin(yy / 11 + k) + 50 * np.cos(xx / 17 - k)
                + rng.normal(0, 12, (96, 1024)), 0, 255)
        for k in range(3)
    ]
    rgb = np.stack(chans, -1).astype(np.uint8)
    rows = rgb.reshape(96, -1).astype(np.int16)
    sub = (rows - np.concatenate([np.zeros((96, 3), np.int16), rows[:, :-3]], 1))
    return [text, rand, photo, resid, sub.astype(np.uint8).tobytes()]


def _image():
    """The JAX package's 160x160 training image: smooth RGB with mild noise."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:160, 0:160].astype(np.float32)
    smooth = 96 + 80 * np.sin(yy / 17.0) + 60 * np.cos(xx / 23.0) + rng.normal(0, 6, (160, 160))
    return np.clip(np.stack([smooth, np.roll(smooth, 7, 0), np.roll(smooth, 13, 1)], -1),
                   0, 255).astype(np.uint8)


def _images():
    """(the image, a batch of it and two of its variants, a ramp whose
    blocks fit the padded packer's first cap, uniform noise)."""
    img = _image()
    batch = np.stack([img, img[:, ::-1], np.roll(img, 40, 1)])
    ramp = np.add.outer(np.arange(160), np.arange(160)).astype(np.uint8)
    ramp = np.stack([ramp, ramp.T, 255 - ramp], -1)
    noise = np.random.default_rng(2).integers(0, 256, img.shape, dtype=np.uint8)
    return img, batch, ramp, noise


def train_jpeg(img, batch, ramp, noise) -> list:
    """Every JPEG encode route on the CPU; returns files for the decode."""
    from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, encode_jpeg_batch_sharded, jpeg

    h, w = img.shape[:2]
    std = JpegOptions(width=w, height=h, quality=85, subsampling=Subsampling.S420)
    balanced = JpegOptions.balanced(w, h, 85)
    files = []
    # the card paths' host stages: the padded packer at the first cap (the
    # ramp) and after the cap escalates (the image's blocks), the dense
    # packer past the top cap (noise at q98), the balanced and optimal
    # tables, the progressive scans and the max preset's trellis
    for imgs, opts in (
        (ramp[None], std),
        (batch, std),
        (batch, std.replace(restart_interval=4)),
        (noise[None], std.replace(quality=98, subsampling=Subsampling.S444)),
        (batch, balanced),
        (batch, balanced.replace(optimal_huffman=True, subsampling=Subsampling.S420)),
        (batch, balanced.replace(progressive=True, subsampling=Subsampling.S420)),
        (batch[:1], balanced.replace(progressive=True, progressive_sa=False)),
        (batch, JpegOptions.max(w, h, 85)),
    ):
        files += encode_jpeg_batch_sharded(imgs, opts, device="cpu", host_workers=1)
    # the host tier: coefficients and the fused encode (fast), count and pack
    # (balanced, optimal), the DCT and the trellis (max); gray and 4:4:4
    gray = JpegOptions(width=w, height=h, quality=85, color_type=ColorType.GRAY)
    for data, opts in (
        (img, std),
        (img, std.replace(subsampling=Subsampling.S444)),
        (img[..., 0], gray),
        (img, balanced),
        (img, balanced.replace(optimal_huffman=True)),
        (img, JpegOptions.max(w, h, 85)),
    ):
        files.append(jpeg.encode(data, opts, device="cpu"))
    return files


def train_png(img, batch) -> list:
    """The PNG encode's presets on the batch path and the per-image host
    tier; returns files for the decode."""
    from pixo_tpu_torch import ColorType, PngOptions, encode_png_batch_sharded, png

    h, w = img.shape[:2]
    files = []
    for preset in (PngOptions.fast, PngOptions.balanced, PngOptions.max):
        opts = preset(w, h).replace(color_type=ColorType.RGB)
        files += encode_png_batch_sharded(batch[:2], opts, device="cpu", host_workers=1)
        files.append(png.encode(img, opts, device="cpu"))
    rgba = np.dstack([img, (np.arange(w)[None, :] * np.ones((h, 1)) % 256).astype(np.uint8)])
    files.append(png.encode(rgba, PngOptions.balanced(w, h), device="cpu"))
    # the max preset's DEFLATE with the chain tables made by the device
    # route (its plain version here), and the parity layer's packed policy
    with _env(PIXO_TPU_LZ77="device"):
        png.encode(img[:48, :48], PngOptions.max(48, 48).replace(color_type=ColorType.RGB),
                   device="cpu")
    with _env(PIXO_TPU_DEFLATE_PARITY="1"):
        png.encode(img, PngOptions.balanced(w, h).replace(color_type=ColorType.RGB), device="cpu")
    return files


def train_lossy(img, batch) -> list:
    """The lossy PNG: the batch path and the per-image host tier (median
    cut, nearest palette, the opaque LUT, Floyd-Steinberg); returns its
    indexed files."""
    from pixo_tpu_torch import (ColorType, PngOptions, QuantizationMode, QuantizationOptions,
                                encode_png_batch_sharded, png)

    h, w = img.shape[:2]
    files = []
    for mode, dithering in ((QuantizationMode.FORCE, True), (QuantizationMode.AUTO, False)):
        opts = PngOptions.balanced(w, h).replace(
            color_type=ColorType.RGB,
            quantization=QuantizationOptions(mode=mode, max_colors=64, dithering=dithering))
        files += encode_png_batch_sharded(batch[:2], opts, device="cpu", host_workers=1)
    rgba = np.dstack([img, np.full((h, w), 255, np.uint8)])
    rgba[:16, :16, 3] = 0  # transparent pixels: the nearest-palette path
    opts = PngOptions.balanced(w, h).replace(quantization=QuantizationOptions(
        mode=QuantizationMode.FORCE, max_colors=256, dithering=True))
    files.append(png.encode(rgba, opts, device="cpu"))
    return files


def train_decode(jpegs, pngs) -> None:
    """The JPEG decode under both pixel tiers (the device tier's tail in plain
    PyTorch here; its host stage is the card path's entropy decode), and the
    PNG decode (INFLATE, unfilter, palette expansion)."""
    from pixo_tpu_torch.decode import decode_jpeg_batch, decode_png

    with _env(PIXO_TPU_DECODE_PIXELS="device"):
        decode_jpeg_batch(jpegs, workers=1, device="cpu")
    with _env(PIXO_TPU_DECODE_PIXELS="host"):
        decode_jpeg_batch(jpegs, workers=1, device="cpu")
    for data in pngs:
        decode_png(data)


def train_deflate() -> None:
    """DEFLATE at levels 1, 2, 6 and 9 and INFLATE on the payloads, as the
    JAX package trains them; the parity layer and the optimal parse."""
    from pixo_tpu_torch.compress import checksums
    from pixo_tpu_torch.compress.deflate import deflate_optimal_zlib, deflate_zlib, inflate_zlib

    payloads = _payloads()
    for payload in payloads:
        for level in (1, 2, 6, 9):
            out = deflate_zlib(payload, level)
            if inflate_zlib(out, len(payload)) != payload:
                raise RuntimeError(f"pgo training: DEFLATE level {level} did not round-trip")
        deflate_zlib(payload[: 64 << 10], 6, parity=True)
        checksums.adler32(payload)
        checksums.crc32(payload)
    deflate_optimal_zlib(payloads[0][: 32 << 10], 3, device="cpu")


def train() -> None:
    """The whole battery, on whatever library ``native.load()`` returns."""
    with _env():
        img, batch, ramp, noise = _images()
        jpegs = train_jpeg(img, batch, ramp, noise)
        pngs = train_png(img, batch) + train_lossy(img, batch)
        train_decode(jpegs, pngs)
        train_deflate()


def main(argv) -> int:
    import torch

    from pixo_tpu_torch import native

    if len(argv) != 2:
        print("usage: python -m pixo_tpu_torch.native._pgo_train <instrumented library>",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    native._load_instrumented(argv[1])
    train()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
