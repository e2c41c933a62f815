"""The port's Adam7 interlace, 16-bit input, batch entry points and
row-sharded encode against the JAX package's, byte for byte, on the CPU.

Every file equals the JAX package's ``png.encode`` for the same input and
options (and its batch encode for the same batch); the interlaced and 16-bit
files also decode with the port's decoder to the pixels they came from.
Inputs come from a numpy seed; images are at most 64x64.
"""

import numpy as np
import pytest

import jax

from pixo_tpu import errors as jax_errors
from pixo_tpu import png as jax_png
from pixo_tpu.parallel.pipeline import encode_png_batch_sharded as jax_encode_batch

from pixo_tpu_torch import (
    ColorType,
    FilterStrategy,
    PngOptions,
    QuantizationMode,
    QuantizationOptions,
    encode_png_batch_sharded,
    encode_png_row_sharded,
    errors,
    png,
)
from pixo_tpu_torch.decode import decode_png
from test_torch_png import _jax_options as _jax

jax.config.update("jax_platforms", "cpu")


def _ihdr(data: bytes):
    """(bit depth, colour type, interlace) of a PNG file."""
    return data[24], data[25], data[28]


def _images(kind: str, h: int, w: int, n: int = 2, seed: int = 0):
    """(colour type, [n, h, w, C] uint8): noise of each colour type, and
    images whose reductions give sub-8-bit rows: "gray N", an RGB image of
    gray values 0 to N (1-, 2- or 4-bit gray where palettes are off), and
    "palette N", an opaque RGBA image of N colours (a palette of 1, 2, 4 or
    8 bits)."""
    rng = np.random.default_rng(seed)
    if kind in ("GRAY", "GRAY_ALPHA", "RGB", "RGBA"):
        ct = ColorType[kind]
        return ct, rng.integers(0, 256, (n, h, w, ct.bytes_per_pixel), dtype=np.uint8)
    if kind.startswith("gray"):
        gray = rng.integers(0, int(kind.split()[1]) + 1, (n, h, w, 1)).astype(np.uint8)
        return ColorType.RGB, np.repeat(gray, 3, axis=-1)
    colours = rng.integers(0, 256, (int(kind.split()[1]), 4), dtype=np.uint8)
    colours[:, 3] = 255
    return ColorType.RGBA, colours[rng.integers(0, len(colours), (n, h, w))]


def _options(preset: str, kind: str, w: int, h: int, ct: ColorType, **kw) -> PngOptions:
    """The preset's options; palettes off for the "gray N" kinds, so that
    their reduction is to gray of fewer bits."""
    opts = getattr(PngOptions, preset)(w, h).replace(color_type=ct, **kw)
    return opts.replace(reduce_palette=False) if kind.startswith("gray") else opts


KINDS = ["GRAY", "GRAY_ALPHA", "RGB", "RGBA", "gray 1", "gray 3", "gray 15", "palette 3",
         "palette 12", "palette 40"]
SHAPES = [(1, 1), (3, 5), (9, 9), (17, 30), (64, 33)]


@pytest.mark.parametrize("preset", ["fast", "balanced", "max"])
@pytest.mark.parametrize("kind", KINDS)
def test_interlaced_equals_jax_and_decodes(kind, preset):
    """8-bit and sub-8-bit interlaced files, pass grids from one pixel to
    passes that are empty: equal to the JAX package's; decoded, equal to the
    non-interlaced file's pixels."""
    for h, w in SHAPES:
        ct, imgs = _images(kind, h, w, n=1, seed=h * 100 + w)
        opts = _options(preset, kind, w, h, ct, interlace=True)
        img = imgs[0]
        out = png.encode(img, opts)
        assert out == jax_png.encode(img, _jax(opts)), (h, w)
        assert _ihdr(out)[2] == 1
        plain = png.encode(img, opts.replace(interlace=False))
        assert _ihdr(out)[:2] == _ihdr(plain)[:2]
        assert np.array_equal(decode_png(out).pixels, decode_png(plain).pixels), (h, w)


def test_reductions_reach_sub_8_bit_under_interlace():
    """The kinds above do take the packed rows of each pass under the
    reducing presets: 1-, 2- and 4-bit gray, 2-, 4- and 8-bit palettes."""
    want = {"gray 1": (1, 0), "gray 3": (2, 0), "gray 15": (4, 0), "palette 3": (2, 3),
            "palette 12": (4, 3), "palette 40": (8, 3)}
    for kind, (depth, ctype) in want.items():
        ct, imgs = _images(kind, 17, 30, n=1)
        for preset in ("balanced", "max"):
            out = png.encode(imgs[0], _options(preset, kind, 30, 17, ct, interlace=True))
            assert _ihdr(out) == (depth, ctype, 1), (kind, preset)


@pytest.mark.parametrize("strategy", list(FilterStrategy), ids=lambda s: s.value)
def test_encode_indexed_interlaced_equals_jax(strategy):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 7, (23, 37), dtype=np.uint8)
    palette = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    for optimal in (False, True):
        opts = PngOptions.balanced(37, 23).replace(filter_strategy=strategy, interlace=True,
                                                   optimal_compression=optimal)
        for trns in (None, np.array([0, 128], np.uint8)):
            out = png.encode_indexed(idx, 37, 23, palette, trns, opts)
            assert out == jax_png.encode_indexed(idx, 37, 23, palette, trns, _jax(opts))
            assert png.encode_indexed_with_options(idx, 37, 23, palette, trns, opts) == out
            pixels = decode_png(out).pixels
            assert np.array_equal(pixels[..., :3], palette[idx])


@pytest.mark.parametrize("dithering", [False, True])
@pytest.mark.parametrize("mode", ["FORCE", "AUTO"])
def test_lossy_interlaced_equals_jax(mode, dithering):
    rng = np.random.default_rng(8)
    xx, yy = np.meshgrid(np.arange(40), np.arange(24))
    img = np.stack([xx * 6, yy * 10, (xx + yy) * 4], -1) + rng.integers(-6, 7, (24, 40, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    opts = PngOptions.balanced(40, 24).replace(color_type=ColorType.RGB, interlace=True, quantization=(
        QuantizationOptions(mode=QuantizationMode[mode], max_colors=64, dithering=dithering)))
    want = jax_png.encode(img, _jax(opts))
    assert png.encode(img, opts) == want
    assert encode_png_batch_sharded(img[None], opts, device="cpu") == [want]
    assert decode_png(want).pixels.shape == (24, 40, 3)


# ------------------------------------------------------------------- 16-bit

@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("preset", ["fast", "balanced", "max"])
@pytest.mark.parametrize("kind", ["GRAY", "GRAY_ALPHA", "RGB", "RGBA"])
def test_16_bit_equals_jax_and_decodes(kind, preset, interlace):
    """uint16 in both byte orders and the big-endian raw bytes (as bytes and
    as a uint8 array) give one file, the JAX package's; it decodes to the
    input's values."""
    ct = ColorType[kind]
    h, w = 19, 27
    values = np.random.default_rng(len(kind)).integers(0, 65536, (h, w, ct.bytes_per_pixel))
    big = values.astype(">u2")
    opts = getattr(PngOptions, preset)(w, h).replace(color_type=ct, bit_depth=16, interlace=interlace)
    want = jax_png.encode(big, _jax(opts))
    for data in (big, values.astype("<u2"), big.tobytes(), np.frombuffer(big.tobytes(), np.uint8)):
        assert png.encode(data, opts) == want
    assert _ihdr(want) == (16, ct.png_color_type, int(interlace))
    assert np.array_equal(decode_png(want, keep_bit_depth=True).pixels.reshape(h, w, -1), values)


def _error(fn):
    try:
        fn()
    except (errors.PixoError, jax_errors.PixoError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("case", ["int16", "float32", "uint32", "short bytes", "quantized",
                                  "level 0", "depth 12", "filter_fn interlaced"])
def test_16_bit_errors_equal_jax(case):
    h, w = 4, 5
    opts = PngOptions.fast(w, h).replace(color_type=ColorType.RGB, bit_depth=16)
    data = np.zeros((h, w, 3), np.uint16)
    if case in ("int16", "float32", "uint32"):
        data = data.astype(case)
        if case != "int16":  # a 4-byte dtype is counted by elements: the length is wrong
            data = np.zeros((h, w, 6), case)
    elif case == "short bytes":
        data = bytes(h * w * 6 - 1)
    elif case == "quantized":
        opts = opts.replace(quantization=QuantizationOptions(mode=QuantizationMode.FORCE))
    elif case == "level 0":
        opts = opts.replace(compression_level=0)
    elif case == "depth 12":
        opts = opts.replace(bit_depth=12)
    if case == "filter_fn interlaced":
        opts = opts.replace(interlace=True)
        got = _error(lambda: png.encode(data, opts, filter_fn=lambda *a: b""))
        want = _error(lambda: jax_png.encode(data, _jax(opts), filter_fn=lambda *a: b""))
    else:
        got = _error(lambda: png.encode(data, opts))
        want = _error(lambda: jax_png.encode(data, _jax(opts)))
    assert want is not None and got == want


def test_filter_fn_refused_under_interlace_at_8_bit():
    img = np.zeros((6, 6, 3), np.uint8)
    opts = PngOptions.fast(6, 6).replace(color_type=ColorType.RGB, interlace=True)
    with pytest.raises(errors.CompressionError, match="filter_fn"):
        png.encode(img, opts, filter_fn=lambda *a: b"")


# ------------------------------------------------------------------- batches

BATCH_OPTIONS = {
    "interlaced balanced": dict(interlace=True),
    "interlaced max": dict(interlace=True, preset="max"),
    "16-bit fast": dict(bit_depth=16, preset="fast"),
    "16-bit interlaced max": dict(bit_depth=16, interlace=True, preset="max"),
    "max": dict(preset="max"),
}


@pytest.mark.parametrize("name", list(BATCH_OPTIONS))
def test_batch_entry_points_equal_jax(name):
    """``encode_png_batch_sharded(device="cpu")`` and
    ``png.encode_batch(device="cpu")`` against the JAX package's batch
    encode and its per-image ``png.encode``."""
    kw = dict(BATCH_OPTIONS[name])
    preset = kw.pop("preset", "balanced")
    rng = np.random.default_rng(21)
    h, w = 48, 64
    opts = getattr(PngOptions, preset)(w, h).replace(color_type=ColorType.RGBA, **kw)
    if opts.bit_depth == 16:
        imgs = rng.integers(0, 65536, (3, h, w, 4)).astype("<u2")
    else:
        _, pal = _images("palette 9", h, w, n=1)
        imgs = np.concatenate([rng.integers(0, 256, (2, h, w, 4), dtype=np.uint8), pal])
    want = jax_encode_batch(imgs, _jax(opts))
    assert want == [jax_png.encode(img, _jax(opts)) for img in imgs]
    assert encode_png_batch_sharded(imgs, opts, device="cpu") == want
    assert encode_png_batch_sharded(imgs, opts, device="cpu", host_workers=1) == want
    assert png.encode_batch(imgs, opts, device="cpu") == want
    assert png.encode_batch(imgs[:1], opts, device="cpu") == want[:1]


def test_encode_into_refills_the_buffer():
    img = np.random.default_rng(2).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    opts = PngOptions.max(11, 9).replace(color_type=ColorType.RGB, interlace=True)
    buf = bytearray(b"stale")
    png.encode_into(buf, img, opts)
    assert bytes(buf) == jax_png.encode(img, _jax(opts))


# ------------------------------------------------------------- row-sharded

@pytest.mark.parametrize("preset", ["fast", "balanced", "max"])
@pytest.mark.parametrize("kind", ["RGB", "RGBA", "gray 3", "palette 12", "palette 40"])
def test_row_sharded_equals_jax(kind, preset):
    """One image's filter stage as one ``filter_rows`` call on its rows
    (the plain version on the CPU), sub-8-bit rows too: the bytes of the JAX
    package's ``png.encode``; interlaced, the ordinary path."""
    ct, imgs = _images(kind, 64, 64, n=1, seed=4)
    for interlace in (False, True):
        opts = _options(preset, kind, 64, 64, ct, interlace=interlace)
        want = jax_png.encode(imgs[0], _jax(opts))
        assert encode_png_row_sharded(imgs[0], opts, device="cpu") == want


def test_row_sharded_bigrams_on_a_large_image_equals_jax():
    """Past 4096 pixels Bigrams runs (not Sub): the rows of a 72x60 image."""
    rng = np.random.default_rng(6)
    img = (np.add.outer(np.arange(60), np.arange(72))[..., None] % 256
           + rng.integers(0, 20, (60, 72, 3))).astype(np.uint8)
    opts = PngOptions.max(72, 60).replace(color_type=ColorType.RGB)
    assert encode_png_row_sharded(img, opts, device="cpu") == jax_png.encode(img, _jax(opts))
    big = rng.integers(0, 65536, (60, 72, 3)).astype(">u2")
    opts16 = opts.replace(bit_depth=16)
    assert encode_png_row_sharded(big, opts16, device="cpu") == jax_png.encode(big, _jax(opts16))
