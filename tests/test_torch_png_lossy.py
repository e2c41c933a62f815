"""The port's lossy PNG encode against the JAX package's, byte for byte, on
the CPU.

``encode_png_batch_sharded(..., device="cpu")`` with quantization (FORCE or
AUTO, 64 or 256 colours, dithered or not, RGB or RGBA) runs the batch
quantizer's device stage through the kernels' plain versions; the port's
per-image ``png.encode`` runs the host tier; both must give the JAX
package's ``png.encode`` bytes, and ``encode_indexed`` its
``encode_indexed`` bytes. Images are small (a few thousand pixels), except
the AUTO batch that needs every branch: its exact-mapped member exists only
where the heuristic's sampling stride exceeds the histogram's.
"""

import numpy as np
import pytest
import torch

from pixo_tpu import png as jpng
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.options import FilterStrategy as JaxFilterStrategy
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.options import QuantizationMode as JaxQuantizationMode
from pixo_tpu.options import QuantizationOptions as JaxQuantizationOptions

from chip_smoke import auto_mix_batch, corpus_batch, lossy_branches
from pixo_tpu_torch import (
    ColorType,
    FilterStrategy,
    PngOptions,
    QuantizationMode,
    QuantizationOptions,
    encode_png_batch_sharded,
    png,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The plain LUT (262,144 x 256 distances an image) is the heaviest CPU
    work of the suite: on two threads it leaves the other test workers their
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _options(w, h, mode, colors, dithering, color_type="RGB", preset="balanced", **kw):
    port = getattr(PngOptions, preset)(w, h).replace(
        color_type=ColorType[color_type], quantization=QuantizationOptions(
            mode=QuantizationMode[mode], max_colors=colors, dithering=dithering), **kw)
    ref = getattr(JaxPngOptions, preset)(w, h).replace(
        color_type=JaxColorType[color_type], quantization=JaxQuantizationOptions(
            mode=JaxQuantizationMode[mode], max_colors=colors, dithering=dithering),
        **{k: JaxFilterStrategy[v.name] if isinstance(v, FilterStrategy) else v for k, v in kw.items()})
    return port, ref


def _batch(channels, h=24, w=40, n=1, seed=0):
    """Noisy gradients (many colours: the device stage), then an image of
    30 colours only (the exact mapping at 64 colours and more); RGBA with
    alpha of 60 to 255 and an opaque right half."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    imgs = []
    for s in range(n):
        img = np.stack([xx * 255 // (w - 1), yy * 255 // (h - 1), (xx + yy + 37 * s) % 256], -1)
        imgs.append(np.clip(img + rng.integers(-6, 7, (h, w, 3)), 0, 255).astype(np.uint8))
    imgs.append(rng.integers(0, 256, (30, 3), dtype=np.uint8)[rng.integers(0, 30, (h, w))])
    imgs = np.stack(imgs)
    if channels == 4:
        alpha = rng.integers(60, 256, (n + 1, h, w, 1)).astype(np.uint8)
        alpha[:, :, w // 2:] = 255
        alpha[-1] = 255
        imgs = np.concatenate([imgs, alpha], -1)
    return imgs


CASES = [(mode, colors, dithering, ct) for ct in ("RGB", "RGBA") for mode in ("FORCE", "AUTO")
         for colors in (64, 256) for dithering in (True, False)]


@pytest.mark.parametrize("mode,colors,dithering,ct", CASES,
                         ids=[f"{ct}-{m}-{c}-{'dither' if d else 'plain'}" for m, c, d, ct in CASES])
def test_batch_and_per_image_encode_equal_jax(mode, colors, dithering, ct):
    imgs = _batch(4 if ct == "RGBA" else 3)
    h, w = imgs.shape[1:3]
    opts, ref_opts = _options(w, h, mode, colors, dithering, ct)
    ref = [jpng.encode(img, ref_opts) for img in imgs]
    assert encode_png_batch_sharded(imgs, opts, device="cpu") == ref
    assert [png.encode(img, opts) for img in imgs] == ref
    assert all(f[25] == 3 for f in ref[:-1])  # the gradients are indexed (colour type 3)


def test_fast_preset_and_a_filter_strategy_equal_jax():
    imgs = _batch(3, n=2, seed=1)
    h, w = imgs.shape[1:3]
    for kw in ({"preset": "fast"}, {"filter_strategy": FilterStrategy.PAETH}):
        opts, ref_opts = _options(w, h, "FORCE", 64, True, **kw)
        assert encode_png_batch_sharded(imgs, opts, device="cpu") == [
            jpng.encode(img, ref_opts) for img in imgs]


def test_gray_batch_is_not_quantized():
    """FORCE and AUTO leave gray images lossless, on the batch path too."""
    rng = np.random.default_rng(2)
    for ct, c in (("GRAY", 1), ("GRAY_ALPHA", 2)):
        imgs = rng.integers(0, 256, (2, 20, 30, c), dtype=np.uint8)
        for mode in ("FORCE", "AUTO"):
            opts, ref_opts = _options(30, 20, mode, 64, True, ct)
            got = encode_png_batch_sharded(imgs, opts, device="cpu")
            assert got == [jpng.encode(img, ref_opts) for img in imgs]
            assert all(f[25] != 3 for f in got)


def test_auto_batch_takes_every_branch():
    """AUTO at 256 colours on 320x320 images: noise (declined, lossless), an
    image that the heuristic's sample accepts and the histogram maps exactly,
    and two photos quantized through the device stage."""
    imgs = auto_mix_batch(corpus_batch()[:1], 320)
    opts, ref_opts = _options(320, 320, "AUTO", 256, True)
    assert lossy_branches(imgs, opts) == (1, 1, 2)
    got = encode_png_batch_sharded(imgs, opts, device="cpu")
    assert got == [jpng.encode(img, ref_opts) for img in imgs]
    assert [f[25] for f in got] == [2, 3, 3, 3]


@pytest.mark.parametrize("strategy", [FilterStrategy.ADAPTIVE, FilterStrategy.NONE,
                                      FilterStrategy.SUB, FilterStrategy.PAETH],
                         ids=lambda s: s.value)
def test_encode_indexed_equals_jax(strategy):
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 7, (15, 21), dtype=np.uint8)
    palette = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    opts = PngOptions.balanced(21, 15).replace(filter_strategy=strategy)
    ref_opts = JaxPngOptions.balanced(21, 15).replace(filter_strategy=JaxFilterStrategy[strategy.name])
    for trns in (None, np.array([0, 128, 255], np.uint8)):
        assert png.encode_indexed(idx, 21, 15, palette, trns, opts) == jpng.encode_indexed(
            idx, 21, 15, palette, trns, ref_opts)
    assert png.encode_indexed(idx.tobytes(), 21, 15, palette) == jpng.encode_indexed(
        idx.tobytes(), 21, 15, palette)


def test_encode_indexed_refuses_bad_input():
    from pixo_tpu_torch import errors

    idx = np.zeros((4, 4), np.uint8)
    with pytest.raises(errors.CompressionError, match="palette length"):
        png.encode_indexed(idx, 4, 4, np.zeros((0, 3), np.uint8))
    with pytest.raises(errors.CompressionError, match="Transparency length"):
        png.encode_indexed(idx, 4, 4, np.zeros((2, 3), np.uint8), np.zeros(3, np.uint8))
    with pytest.raises(errors.InvalidDataLength):
        png.encode_indexed(idx[:3], 4, 4, np.zeros((2, 3), np.uint8))


def test_interlace_with_quantization_still_raises():
    """Interlace with quantization raised until Adam7 was ported (ROADMAP.md
    queue 1 item 8); it gives the JAX package's files now: each image
    quantized on the host, then written as an interlaced indexed file."""
    imgs = _batch(3)
    h, w = imgs.shape[1:3]
    opts, ref = _options(w, h, "FORCE", 64, True, interlace=True)
    want = [jpng.encode(img, ref) for img in imgs]
    assert encode_png_batch_sharded(imgs, opts, device="cpu") == want
    assert png.encode(imgs[0], opts) == want[0]
