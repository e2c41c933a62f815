"""The port's JPEG encode beyond the standard tables, against the JAX
package, on the CPU: optimized and optimal Huffman (the balanced preset) and
progressive, with and without successive approximation.

Every case encodes the same seeded images with the port's three entry
points, ``jpeg.encode(..., device="cpu")`` (the host library's tier),
``jpeg.encode_batch(..., device="cpu")`` and
``encode_jpeg_batch_sharded(..., device="cpu")`` (the plain coefficient
chain, the plain symbol count, the compaction and the native pack), and
holds each file byte for byte to the JAX package's ``jpeg.encode`` (its
native host tier under the CPU backend; its batch entry's jit coefficients
FMA-contract on XLA:CPU and are not the reference here). The JPEG cases of
``tests/test_oracle_parity.py`` (presets 0 and 1) are held to the pixo WASM
oracle's committed bytes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.jpeg.encoder import encode as jax_encode
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import Subsampling as JaxSubsampling

from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, encode_jpeg_batch_sharded, jpeg
from pixo_tpu_torch.jpeg import encoder as jenc
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.parallel import pipeline

sys.path.insert(0, str(Path(__file__).resolve().parent / "support"))

from pixo_oracle import cached_call  # noqa: E402
from test_oracle_parity import JPEG_CASES  # noqa: E402

jax.config.update("jax_platforms", "cpu")

OPTIONS = {
    "optimize": dict(optimize_huffman=True),
    "optimal": dict(optimal_huffman=True),
    "progressive_sa": dict(progressive=True),
    "progressive_no_sa": dict(progressive=True, progressive_sa=False),
}
MODES = ["420", "422", "444", "gray"]
SIZES = [(8, 8), (17, 23), (64, 48)]


def _jax_options(o: JpegOptions) -> JaxJpegOptions:
    return JaxJpegOptions(
        width=o.width, height=o.height, quality=o.quality,
        color_type=JaxColorType(int(o.color_type)),
        subsampling=JaxSubsampling(o.subsampling.value),
        restart_interval=o.restart_interval,
        optimize_huffman=o.optimize_huffman, optimal_huffman=o.optimal_huffman,
        progressive=o.progressive, progressive_sa=o.progressive_sa,
    )


def _options(mode: str, h: int, w: int, quality: int = 80, **kw) -> JpegOptions:
    gray = mode == "gray"
    return JpegOptions(width=w, height=h, quality=quality,
                       color_type=ColorType.GRAY if gray else ColorType.RGB,
                       subsampling=Subsampling("444" if gray else mode), **kw)


def _images(rng, mode: str, h: int, w: int, b: int = 2):
    """A smooth gradient with noise, b images ([b, h, w] for gray)."""
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)[..., None]
    imgs = (base + rng.normal(0, 12, (b, h, w, 3))).clip(0, 255).astype(np.uint8)
    return np.ascontiguousarray(imgs[..., 0]) if mode == "gray" else imgs


def _all_entries_equal_jax(imgs, opts):
    ref = [jax_encode(im, _jax_options(opts)) for im in imgs]
    assert [jpeg.encode(im, opts, device="cpu") for im in imgs] == ref
    assert jpeg.encode_batch(imgs, opts, device="cpu") == ref
    assert encode_jpeg_batch_sharded(imgs, opts, device="cpu", host_workers=2) == ref
    return ref


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("option", list(OPTIONS))
def test_bytes_equal_jax_package(rng, option, mode, size):
    h, w = size
    opts = _options(mode, h, w, **OPTIONS[option])
    outs = _all_entries_equal_jax(_images(rng, mode, h, w), opts)
    sof = b"\xff\xc2" if opts.progressive else b"\xff\xc0"
    assert all(o[:2] == b"\xff\xd8" and o[-2:] == b"\xff\xd9" and sof in o for o in outs)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_bytes_equal_jax_package_over_2048_blocks(rng, option):
    """400x304 at 4:4:4: 5,700 blocks, so the SA script takes no
    single-table fallback."""
    opts = _options("444", 304, 400, **OPTIONS[option])
    _all_entries_equal_jax(_images(rng, "444", 304, 400, b=1), opts)


@pytest.mark.parametrize("ri", [1, 2, 7])
@pytest.mark.parametrize("mode", ["420", "gray"])
@pytest.mark.parametrize("option", ["optimize", "optimal", "progressive_sa"])
def test_restart_intervals_equal_jax_package(rng, option, mode, ri):
    opts = _options(mode, 40, 56, restart_interval=ri, **OPTIONS[option])
    outs = _all_entries_equal_jax(_images(rng, mode, 40, 56), opts)
    # a progressive file advertises no restart interval (encoder.py's note)
    assert all((b"\xff\xdd" in o) != opts.progressive for o in outs)


def _noisy(rng, sigma, b=2, h=32, w=32):
    base = np.add.outer(np.arange(h) * 4, np.arange(w) * 4)[..., None]
    return (base + rng.normal(0, sigma, (b, h, w, 3))).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("option", ["optimize", "optimal"])
@pytest.mark.parametrize("sigma,quality,tier", [(8, 75, 16), (6, 90, 32), (None, 98, "dense")])
def test_optimized_route_escalates_and_falls_back(rng, option, sigma, quality, tier):
    """Noise that escalates the compaction cap to 16 and 32, and noise that
    falls back to the dense stream, which packs image by image with each
    image's own tables."""
    imgs = (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8) if sigma is None
            else _noisy(rng, sigma))
    opts = JpegOptions(width=32, height=32, quality=quality, **OPTIONS[option])
    zz = pipeline.jpeg_coeffs_sharded(imgs, opts, device="cpu")
    state = pipeline._fetch_compacted(zz, kernels.compact_padded(zz, 8))
    assert (state[3].shape[-1] if state[0] == "padded" else "dense") == tier
    _all_entries_equal_jax(imgs, opts)


def test_flat_and_tiny_images_take_single_symbol_histograms():
    """A flat image has one DC and one AC symbol a class: the one-symbol
    tables (and, in gray, no chroma tables) still equal the reference."""
    for mode in ("420", "gray"):
        imgs = np.full((2, 16, 16) if mode == "gray" else (2, 16, 16, 3), 77, np.uint8)
        for option in OPTIONS:
            _all_entries_equal_jax(imgs, _options(mode, 16, 16, **OPTIONS[option]))


@pytest.mark.parametrize("name,img,ct,q,preset,sub420", JPEG_CASES, ids=[c[0] for c in JPEG_CASES])
def test_jpeg_bytes_identical_to_pixo(name, img, ct, q, preset, sub420):
    """The reference oracle's committed JPEGs of presets 0 and 1, from the
    port's host tier and from its batch entry."""
    h, w = img.shape[:2]
    ref = cached_call("jpeg", img.tobytes(), w, h, ct, q, preset, sub420)
    opts = JpegOptions.from_preset(w, h, q, preset)
    if ct == 0:
        opts.color_type = ColorType.GRAY
    opts.subsampling = Subsampling.S420 if sub420 else Subsampling.S444
    assert jpeg.encode(img, opts, device="cpu") == bytes(ref)
    px = np.ascontiguousarray(img[..., 0]) if ct == 0 else img
    assert encode_jpeg_batch_sharded(px[None], opts, device="cpu") == [bytes(ref)]


def test_small_sa_image_keeps_the_smaller_file(rng):
    """At most 2048 blocks, the SA encode also emits the single-table
    variant and keeps the smaller file."""
    imgs = _images(rng, "420", 24, 24, b=1)
    sa = _options("420", 24, 24, progressive=True)
    out = jpeg.encode(imgs[0], sa, device="cpu")
    quant = jenc.QuantizationTables(sa.quality)
    _, pattern = jenc._pattern(sa)
    zz = jenc.compute_coefficients_host(imgs[0], sa, quant)
    both = [jenc._emit_jpeg(zz, None, o, quant, pattern)
            for o in (sa, sa.replace(progressive_sa=False))]
    assert out == min(both, key=len)


def test_progressive_python_fallback_equals_native(rng, monkeypatch):
    """Where the host library declines a scan, the Python scan coders and
    counters emit the same bytes."""
    imgs = _images(rng, "420", 40, 40, b=1)
    declined = []

    def decline(answer):
        return lambda *a, **k: declined.append(answer) or answer

    for kw in (OPTIONS["progressive_sa"], OPTIONS["progressive_no_sa"]):
        opts = _options("420", 40, 40, **kw)
        native = jpeg.encode(imgs[0], opts, device="cpu")
        with monkeypatch.context() as m:
            m.setattr("pixo_tpu_torch.native.native_encode_progressive_scan", decline(None))
            m.setattr("pixo_tpu_torch.native.native_count_progressive_scan", decline(False))
            assert jpeg.encode(imgs[0], opts, device="cpu") == native
    assert None in declined and False in declined


def test_entry_points_on_a_cpu_tensor_and_flat_bytes(rng):
    imgs = _images(rng, "420", 17, 23)
    opts = _options("420", 17, 23, optimize_huffman=True)
    want = jpeg.encode_batch(imgs, opts, device="cpu")
    assert encode_jpeg_batch_sharded(torch.from_numpy(imgs), opts, device="cpu") == want
    assert jpeg.encode(imgs[0].tobytes(), opts, device="cpu") == want[0]
    assert jpeg.encode_batch(imgs[:0], opts, device="cpu") == []


def test_max_preset_is_served(rng):
    """The ``max`` preset (progressive, optimized tables, trellis) from every
    entry point: progressive files equal to the JAX package's
    (``tests/test_torch_trellis.py`` holds the trellis in depth)."""
    opts = JpegOptions.max(16, 16, 80)
    imgs = _images(rng, "420", 16, 16)
    ref = [jax_encode(im, _jax_options(opts).replace(trellis_quant=True)) for im in imgs]
    assert [jpeg.encode(im, opts, device="cpu") for im in imgs] == ref
    assert jpeg.encode_batch(imgs, opts, device="cpu") == ref
    assert encode_jpeg_batch_sharded(imgs, opts, device="cpu") == ref
    assert all(b"\xff\xc2" in o for o in ref)
