"""The port's thumbnail pipeline against the JAX package's, on the CPU.

``thumbnail_pipeline(..., device="cpu")`` must emit, input by input, the bytes
of ``pixo_tpu.parallel.thumbnail_pipeline`` (exact: the decode is integer
work, the resize and the coefficient chain run in the reference's f32
operation order). The reference runs under its default tiers, which on the
CPU backend are the host tiers, the authoritative f32 order
(``pixo_tpu/parallel/pipeline.py:778-784``). The first three cases are those
of ``tests/test_parallel.py:136-198`` (same seeds and shapes); the shapes are
kept few because JAX compiles anew for each.
"""

import numpy as np
import pytest
import torch

import jax

from pixo_tpu import JpegOptions as JaxJpegOptions
from pixo_tpu import errors as jax_errors
from pixo_tpu import jpeg as jax_jpeg
from pixo_tpu.cli import load_image as jax_load_image
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.ops.resize_kernels import resize_lanczos3_np
from pixo_tpu.parallel import thumbnail_pipeline as jax_thumbnail_pipeline
from pixo_tpu.utils.synthetic import synth_gradient, synth_noise

from pixo_tpu_torch import errors, thumbnail_pipeline
from pixo_tpu_torch.cli import detect_format_from_bytes, load_image
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.ops.resize_kernels import lanczos_taps
from pixo_tpu_torch.parallel import pipeline
from tests.support.png_writer import write_png

jax.config.update("jax_platforms", "cpu")


def _jpeg(img, quality=90):
    h, w = img.shape[:2]
    opts = JaxJpegOptions.fast(w, h, quality)
    if img.ndim == 2:
        opts = opts.replace(color_type=JaxColorType.GRAY)
    return jax_jpeg.encode(img, opts)


def _pnm(img):
    h, w = img.shape[:2]
    magic = b"P5" if img.ndim == 2 else b"P6"
    return magic + b"\n# a comment\n%d %d\n255\n" % (w, h) + img.tobytes()


@pytest.fixture(scope="module")
def batch_files():
    """tests/test_parallel.py's module batch: three 32x32 JPEGs at q90."""
    rng = np.random.default_rng(0)
    imgs = [synth_gradient(32, 32, 3), synth_noise(32, 32, 3)]
    imgs += [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(6)]
    return [_jpeg(img) for img in imgs[:3]]


@pytest.fixture(scope="module")
def mixed_files():
    """One call's worth of every input kind at two sizes: colour and gray
    JPEGs, RGB, RGBA, gray, gray+alpha and 16-bit PNGs, a palette PNG with
    tRNS, P6 and P5 files, and inputs that are 16x16 already."""
    rng = np.random.default_rng(17)

    def noise(h, w, c=None):
        return rng.integers(0, 256, (h, w) if c is None else (h, w, c), dtype=np.uint8)

    return [
        _jpeg(noise(40, 48, 3)),
        write_png(noise(40, 48, 3), 8, 2, filter_mode="cycle"),
        _jpeg(noise(40, 48)),
        write_png(noise(40, 48, 4), 8, 6, filter_mode=4),
        write_png(noise(40, 48), 8, 0),
        write_png(noise(40, 48, 2), 8, 4, interlace=1),
        _pnm(noise(40, 48, 3)),
        _pnm(noise(40, 48)),
        write_png(rng.integers(0, 65536, (16, 16, 3)), 16, 2),
        write_png(rng.integers(0, 9, (16, 16)), 4, 3, palette=rng.integers(0, 256, (9, 3)),
                  trns=bytes(rng.integers(0, 255, 9, dtype=np.uint8))),
        _jpeg(noise(16, 16, 3)),
        _pnm(noise(16, 16, 3)),
    ]


def test_thumbnail_pipeline(batch_files):
    got = thumbnail_pipeline(batch_files, thumb_size=16, quality=85, device="cpu")
    assert got == jax_thumbnail_pipeline(batch_files, thumb_size=16, quality=85)
    assert len(got) == 3
    for t in got:
        assert t[:2] == b"\xff\xd8" and t[-2:] == b"\xff\xd9"


def test_thumbnail_pipeline_mixed_shapes_and_stats():
    """Chunks of 2 over mixed input shapes, as
    test_thumbnail_pipeline_matches_sequential."""
    rng = np.random.default_rng(3)
    encoded = [_jpeg(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
               for w, h in [(32, 32), (48, 24), (32, 32), (48, 24), (40, 40)]]
    stats, jstats = {}, {}
    got = thumbnail_pipeline(encoded, thumb_size=16, quality=85, chunk_size=2, device="cpu",
                             stats=stats)
    want = jax_thumbnail_pipeline(encoded, thumb_size=16, quality=85, chunk_size=2, stats=jstats)
    assert got == want
    assert set(stats) == set(jstats) == {"decode_wait_s", "device_s", "pack_s"}
    assert all(v > 0 for v in stats.values())


def test_thumbnail_pipeline_single_shape_chunks():
    """The reference's fused-dispatch case: 5 images of 40x48, chunks of 3."""
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (5, 40, 48, 3), dtype=np.uint8)
    encoded = [_jpeg(imgs[i]) for i in range(5)]
    got = thumbnail_pipeline(encoded, thumb_size=16, quality=85, chunk_size=3, device="cpu")
    assert got == jax_thumbnail_pipeline(encoded, thumb_size=16, quality=85, chunk_size=3)


@pytest.mark.parametrize("chunk_size", [1, 2, 5, 64])
def test_thumbnail_pipeline_every_input_kind(mixed_files, chunk_size):
    """PNG (RGB, RGBA, gray, gray+alpha, 16-bit, palette), gray JPEG, PPM and
    PGM inputs, and inputs that are thumb-size square already, in chunks of
    1, 2, 5 and more than there are inputs."""
    got = thumbnail_pipeline(mixed_files, thumb_size=16, quality=85, chunk_size=chunk_size,
                             device="cpu", host_workers=3)
    want = jax_thumbnail_pipeline(mixed_files, thumb_size=16, quality=85, chunk_size=chunk_size)
    assert got == want


def test_thumb_size_square_input_goes_through_the_resize(mixed_files):
    """The Lanczos pass at scale 1 runs (it is not a copy), as in the
    reference; held to the composition decode -> resize -> encode."""
    data = mixed_files[10]  # the 16x16 JPEG
    px = np.ascontiguousarray(jax_load_image(data)[0])
    thumb = resize_lanczos3_np(px, dst_w=16, dst_h=16)
    want = jax_jpeg.encode(thumb, JaxJpegOptions(width=16, height=16, quality=85,
                                                 color_type=JaxColorType.RGB))
    assert thumbnail_pipeline([data], thumb_size=16, quality=85, device="cpu") == [want]
    assert lanczos_taps(16, 16)[1].shape[1] > 1  # a window of several taps, not the identity


def test_quality_and_size_options(batch_files):
    got = thumbnail_pipeline(batch_files, thumb_size=24, quality=60, device="cpu", chunk_size=2)
    assert got == jax_thumbnail_pipeline(batch_files, thumb_size=24, quality=60, chunk_size=2)


def test_empty_call_and_no_kernel_on_the_cpu(batch_files):
    assert thumbnail_pipeline([], device="cpu") == []
    before = [f.launches for f in (kernels.resize_lanczos3, kernels.coeffs, kernels.compact_padded,
                                   kernels.idct_planes)]
    thumbnail_pipeline(batch_files[:1], thumb_size=16, device="cpu")
    assert before == [f.launches for f in (kernels.resize_lanczos3, kernels.coeffs,
                                           kernels.compact_padded, kernels.idct_planes)]


@pytest.mark.parametrize("kind", ["jpeg", "png", "unknown"])
def test_first_failing_input_raises_its_error(mixed_files, kind):
    """A corrupt file raises the reference's error class and message, and
    of two corrupt inputs the earlier one's, whatever their formats."""
    bad = {"jpeg": mixed_files[0][:200], "png": mixed_files[1][:100], "unknown": b"GIF89a" + b"\0" * 40}
    files = mixed_files[:4] + [bad[kind]] + mixed_files[4:6] + [mixed_files[1][:60], mixed_files[0][:90]]
    with pytest.raises(Exception) as want:
        jax_thumbnail_pipeline(files, thumb_size=16, chunk_size=16)
    with pytest.raises(Exception) as got:
        thumbnail_pipeline(files, thumb_size=16, chunk_size=16, device="cpu")
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    if kind == "unknown":
        assert isinstance(got.value, ValueError)
    else:
        assert isinstance(got.value, errors.InvalidDecode)
        assert isinstance(want.value, jax_errors.InvalidDecode)


def test_load_image_equal_on_each_format(mixed_files):
    for data in mixed_files:
        px, w, h, ct = load_image(data, device="cpu")
        jpx, jw, jh, jct = jax_load_image(data)
        assert (w, h, int(ct)) == (jw, jh, int(jct))
        assert px.ndim == 3
        np.testing.assert_array_equal(px, jpx)
    assert [detect_format_from_bytes(d) for d in mixed_files[:2] + mixed_files[6:8]] == \
        ["jpeg", "png", "ppm", "pgm"]
    with pytest.raises(ValueError, match="unrecognized input format"):
        load_image(b"BM\0\0", device="cpu")
    with pytest.raises(ValueError, match="unsupported PNM maxval"):
        load_image(b"P6 2 2 65535\n" + b"\0" * 24, device="cpu")


def test_to_rgb():
    rng = np.random.default_rng(2)
    for c in (1, 2, 3, 4):
        px = torch.from_numpy(rng.integers(0, 256, (2, 5, 6, c), dtype=np.uint8))
        rgb = pipeline._to_rgb(px)
        assert tuple(rgb.shape) == (2, 5, 6, 3) and rgb.is_contiguous()
        want = px[..., :3] if c >= 3 else px[..., :1].repeat(1, 1, 1, 3)
        assert torch.equal(rgb, want)
