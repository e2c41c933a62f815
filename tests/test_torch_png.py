"""The port's batched lossless PNG encode against the JAX package, on the CPU.

The same seeded numpy inputs go through the JAX package and the port:

- the filter bank: the port's plain version (what ``ops/kernels.py::
  filter_bank`` runs for CPU tensors) against ``filter_bank_pallas`` in
  interpret mode and against ``candidates_np``/``scores_np``;
- the filter selection (``filter_image_batch``, ``_select_adaptive``,
  ``_select_adaptive_fast``) against the JAX functions, ties included;
- the reduction analysis and the group layout transform;
- ``encode_png_batch_sharded(device="cpu")`` against the JAX package's
  ``encode_png_batch_sharded`` and ``png.encode``, byte for byte.

Every comparison is for equality: the filters are integer arithmetic.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixo_tpu import errors as jax_errors
from pixo_tpu import png as jax_png
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.decode import decode_png
from pixo_tpu.ops import png_filters as jax_filters
from pixo_tpu.ops import reduce_analysis as jax_analysis
from pixo_tpu.ops.pallas_kernels import filter_bank_pallas
from pixo_tpu.options import FilterStrategy as JaxFilterStrategy
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.options import QuantizationMode as JaxQuantizationMode
from pixo_tpu.options import QuantizationOptions as JaxQuantizationOptions
from pixo_tpu.parallel.pipeline import encode_png_batch_sharded as jax_encode_batch

import chip_smoke
from pixo_tpu_torch import ColorType, FilterStrategy, PngOptions, encode_png_batch_sharded, errors
from pixo_tpu_torch import png
from pixo_tpu_torch.native import native_png_filter
from pixo_tpu_torch.ops import kernels, png_filters, reduce_analysis
from pixo_tpu_torch.options import QuantizationMode, QuantizationOptions
from pixo_tpu_torch.parallel import pipeline
from pixo_tpu_torch.utils.synthetic import synth_gradient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(REPO, "tests", "fixtures", f"corpus_{n}_512.png")
            for n in ("browser", "playground", "rocket", "web")]
STRATEGIES = [s for s in FilterStrategy if s != FilterStrategy.BIGRAMS]

jax.config.update("jax_platforms", "cpu")


def _jax_options(o: PngOptions) -> JaxPngOptions:
    q = o.quantization
    return JaxPngOptions(
        width=o.width, height=o.height, color_type=JaxColorType(int(o.color_type)),
        compression_level=o.compression_level,
        filter_strategy=JaxFilterStrategy(o.filter_strategy.value),
        optimize_alpha=o.optimize_alpha, reduce_color_type=o.reduce_color_type,
        strip_metadata=o.strip_metadata, reduce_palette=o.reduce_palette,
        optimal_compression=o.optimal_compression, interlace=o.interlace, bit_depth=o.bit_depth,
        quantization=JaxQuantizationOptions(mode=JaxQuantizationMode[q.mode.name],
                                            max_colors=q.max_colors, dithering=q.dithering),
    )


def _assert_bytes_equal_jax(imgs, opts, **kwargs):
    outs = encode_png_batch_sharded(imgs, opts, device="cpu", **kwargs)
    jopts = _jax_options(opts)
    assert outs == jax_encode_batch(imgs, jopts)
    for img, out in zip(imgs, outs):
        assert out == jax_png.encode(img, jopts)
        assert out == png.encode(img, opts)
    return outs


def _tied_rows(b, h, rb):
    """A diagonal ramp: Sub, Up and Paeth all score rb on every row but the
    first, and None and Average differ."""
    y, x = np.mgrid[0:h, 0:rb]
    return np.broadcast_to(((y + x) % 256).astype(np.uint8), (b, h, rb)).copy()


# ---------------------------------------------------------------- filter bank

@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("shape", [(16, 64), (9, 37), (5, "bpp"), (3, "half")])
def test_filter_bank_plain_equals_pallas_interpret(rng, bpp, shape):
    """Shapes with RB = bpp and RB < bpp take the all-zero left neighbours."""
    h, rb = shape
    rb = {"bpp": bpp, "half": max(bpp // 2, 1)}.get(rb, rb)
    rows = rng.integers(0, 256, (2, h, rb), dtype=np.uint8)
    cands, scores = kernels.filter_bank(torch.from_numpy(rows), bpp)
    assert cands.dtype == torch.uint8 and scores.dtype == torch.int32
    for i in range(2):
        x = jnp.asarray(rows[i].astype(np.int32))
        up = jnp.concatenate([jnp.zeros((1, rb), jnp.int32), x[:-1]], axis=0)
        cands_p, scores_p = filter_bank_pallas(x, up, bpp=bpp, interpret=True)
        np.testing.assert_array_equal(cands[i].numpy(), np.asarray(cands_p))
        np.testing.assert_array_equal(scores[i].numpy(), np.asarray(scores_p))
        cands_np = jax_filters.candidates_np(rows[i], bpp)
        np.testing.assert_array_equal(cands[i].numpy(), cands_np)
        np.testing.assert_array_equal(scores[i].numpy(), jax_filters.scores_np(cands_np))


@pytest.mark.parametrize("sticky", [False, True])
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
def test_filter_image_batch_equals_jax(rng, strategy, small, sticky):
    noise = rng.integers(0, 256, (2, 12, 48), dtype=np.uint8)
    smooth = (np.cumsum(rng.integers(-3, 4, (2, 12, 48)), axis=2) % 256).astype(np.uint8)
    flat = np.zeros((1, 12, 48), np.uint8)
    for rows, bpp in ((noise, 3), (smooth, 4), (_tied_rows(2, 12, 48), 1), (flat, 2)):
        kw = dict(bpp=bpp, strategy=strategy.value, small_image=small, sticky_fast=sticky)
        filt, ids = png_filters.filter_image_batch(torch.from_numpy(rows), **kw)
        jfilt, jids = jax_filters.filter_image_batch(jnp.asarray(rows), **kw)
        np.testing.assert_array_equal(filt.numpy(), np.asarray(jfilt))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        one, one_ids = png_filters.filter_image(torch.from_numpy(rows[0]), **kw)
        assert torch.equal(one, filt[0]) and torch.equal(one_ids, ids[0])


@pytest.mark.parametrize("early", [0, 1, 2, 3, 6])
def test_selection_rules_equal_jax_on_ties(rng, early):
    """Scores drawn from 0..4 tie often: the strict-improvement rule and the
    first-extremum argmin/argmax must pick as the JAX functions do."""
    scores = rng.integers(0, 5, (400, 5)).astype(np.int32)
    got = png_filters._select_adaptive(torch.from_numpy(scores), early).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_filters._select_adaptive(jnp.asarray(scores), early)))
    got = png_filters._select_adaptive_fast(torch.from_numpy(scores), early).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_filters._select_adaptive_fast(jnp.asarray(scores), early)))


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
def test_filter_rows_equals_native_host_filter(rng, strategy):
    """The fused stage (plain version on the CPU) against the port's native
    host filter, image by image, sticky (H <= 32) and not."""
    for h, w, bpp in ((20, 70, 3), (40, 110, 4), (33, 1, 2)):
        rows = rng.integers(0, 256, (2, h, w * bpp), dtype=np.uint8)
        small = w * h <= 4096
        out = kernels.filter_rows(torch.from_numpy(rows), bpp=bpp, strategy=strategy,
                                  small_image=small, sticky_fast=h <= 32)
        assert out.shape == (2, h, w * bpp + 1) and out.dtype == torch.uint8
        mode = png_filters.native_mode(png_filters.resolve_strategy(strategy, small))
        for i in range(2):
            host = native_png_filter(rows[i], bpp, mode, h <= 32 and mode == 6)
            np.testing.assert_array_equal(out[i].numpy(), host)


# the strategies held against the JAX package at the edge shapes: the two
# selection rules and the widest fixed filter; the host filter holds them all
JAX_HELD = (FilterStrategy.ADAPTIVE, FilterStrategy.ADAPTIVE_FAST, FilterStrategy.PAETH)


@pytest.mark.parametrize("bpp", range(1, 9))
def test_filter_rows_at_the_kernel_edge_shapes_equals_jax_and_host(bpp):
    """The shapes the card checks the strip and long-row kernels at (rows of
    1, bpp - 1, bpp, 15, 16, 17 bytes, heights around a strip and the sticky
    limit, all-0 and all-255 rows, rows at the shared-memory budget), here
    through the wrapper's plain version: every strategy against the native
    host filter, and ``JAX_HELD`` against the JAX package's
    ``filter_image_batch``."""
    for label, rows in chip_smoke.filter_edge_cases(np.random.default_rng(40 + bpp), bpp):
        t = torch.from_numpy(rows)
        for strategy in STRATEGIES:
            mode = png_filters.native_mode(strategy)
            for sticky in ((False, True) if mode == png_filters.MODE_ADAPTIVE_FAST else (False,)):
                kw = dict(bpp=bpp, strategy=strategy.value, small_image=False, sticky_fast=sticky)
                out = kernels.filter_rows(t, **kw).numpy()
                for i in range(len(rows)):
                    np.testing.assert_array_equal(
                        out[i], native_png_filter(rows[i], bpp, mode, sticky), err_msg=label)
                if strategy not in JAX_HELD:  # each shape compiles anew under JAX
                    continue
                jfilt, jids = jax_filters.filter_image_batch(jnp.asarray(rows), **kw)
                np.testing.assert_array_equal(out[..., 1:], np.asarray(jfilt), err_msg=label)
                np.testing.assert_array_equal(out[..., 0], np.asarray(jids), err_msg=label)


def _strip_smem(strip, rb, sticky):
    """Shared memory of a strip of ``strip`` rows, as csrc/filter_bank.cu
    lays it out: the rows and the row above, the output rows, and row 0
    under the sticky rule, each region with room for any alignment."""
    region = lambda n: (n + 63) // 16 * 16  # noqa: E731
    return region((strip + 1) * rb) + region(strip * (rb + 1)) + (region(rb) if sticky else 0)


@pytest.mark.parametrize("sticky", [False, True])
def test_filter_rows_plan_depends_on_the_shape_alone(sticky):
    budget, most = kernels.FILTER_SMEM_BUDGET, kernels.FILTER_STRIP_ROWS
    assert kernels.filter_rows_plan(512, 1536, sticky) == most  # the main path's rows
    for h in (1, 2, 3, 4, 7, 8, 9, 32, 33, 512):
        last = most
        for rb in (1, 2, 15, 16, 17, 1536, 5000, 11000, 12288, 14000, 20000, 22733, 22734,
                   30000, 60000, 70000, 262140, 65535 * 8):
            plan = kernels.filter_rows_plan(h, rb, sticky)
            assert 0 <= plan <= min(most, h) and plan <= last  # fewer rows as they grow
            last = plan
            fits = [s for s in range(1, min(most, h) + 1) if _strip_smem(s, rb, sticky) <= budget]
            if plan:  # the most rows that fit, and at least 4 of an image that has them
                assert plan == fits[-1] and plan >= min(4, h)
            else:  # the long-row kernel: fewer than 4 (or than the image has) fit
                assert not fits or fits[-1] < min(4, h)


def test_filter_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="bpp"):
        kernels.filter_bank(torch.zeros((1, 2, 8), dtype=torch.uint8), 9)
    with pytest.raises(ValueError, match=r"\[B, H, RB\]"):
        kernels.filter_bank(torch.zeros((2, 8), dtype=torch.uint8), 1)
    with pytest.raises(TypeError, match="uint8"):
        kernels.filter_rows(torch.zeros((1, 2, 8), dtype=torch.int32), bpp=1,
                            strategy=FilterStrategy.SUB, small_image=False, sticky_fast=False)


# ------------------------------------------------------ analysis and transform

def _analysis_batch(rng, n, c):
    imgs = [rng.integers(0, 256, (n, c), dtype=np.uint8) for _ in range(2)]
    g = rng.integers(0, 256, (n, 1), dtype=np.uint8)
    gray = np.concatenate([g, g, g] + ([rng.integers(0, 256, (n, 1), dtype=np.uint8)] if c == 4 else []), 1)
    few = np.zeros((n, c), np.uint8)
    few[:, 0] = np.arange(n) % 7 * 30
    imgs += [gray, few]
    if c == 4:
        imgs[1][:, 3] = 255  # colorful and opaque
        few[:, 3] = 255
        imgs.append(np.concatenate([g, g, g, np.full((n, 1), 255, np.uint8)], 1))
    return np.stack(imgs)


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("n", [600, 12288])
def test_analysis_equals_jax(rng, n, c):
    """n = 12288 samples with stride 3, as the host's palette screen does."""
    px = _analysis_batch(rng, n, c)
    got = reduce_analysis.analyze_png_batch(torch.from_numpy(px))
    want = jax_analysis.analyze_png_batch(px)
    for g, w in zip(got, want):
        assert g.dtype == np.bool_
        np.testing.assert_array_equal(g, w)
    assert got[2][3] and not got[2][0]


@pytest.mark.parametrize("opt_alpha", [False, True])
@pytest.mark.parametrize("mode", ["pass", "strip", "ga"])
def test_transform_equals_jax(rng, mode, opt_alpha):
    px = rng.integers(0, 256, (3, 500, 4), dtype=np.uint8)
    px[:, ::5, 3] = 0
    got = reduce_analysis.transform_png_group(torch.from_numpy(px), mode, opt_alpha)
    np.testing.assert_array_equal(got.numpy(), jax_analysis.transform_png_group(px, mode, opt_alpha))


# ------------------------------------------------------------- batch encode

def _routing_batch(w=80, h=64):
    """tests/test_parallel.py:72-116: one image per route of the balanced
    RGBA batch (pass, strip, ga) and one per fallback (gray, palette)."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    a[::7, ::3, 3] = 0
    b = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    b[..., 3] = 255
    g = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    ga = np.concatenate([g, g, g, rng.integers(0, 255, (h, w, 1), dtype=np.uint8)], axis=-1)
    gg = np.concatenate([g, g, g, np.full((h, w, 1), 255, np.uint8)], axis=-1)
    p = np.zeros((h, w, 4), np.uint8)
    p[..., 0] = (np.arange(w) % 7 * 30).astype(np.uint8)
    p[..., 3] = 255
    return np.stack([a, b, ga, gg, p] + [rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
                                         for _ in range(3)])


def test_fast_rgb_batch_equals_jax():
    """tests/test_parallel.py:63-70."""
    rng = np.random.default_rng(0)
    imgs = [synth_gradient(32, 32, 3), rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)]
    imgs += [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8) for _ in range(6)]
    _assert_bytes_equal_jax(np.stack(imgs), PngOptions.fast(32, 32).replace(color_type=ColorType.RGB))


def test_balanced_rgba_routing_batch_equals_jax():
    batch = _routing_batch()
    opts = PngOptions.balanced(80, 64)
    groups, fallback = pipeline._png_route_batch(torch.from_numpy(batch.reshape(8, -1, 4)), opts)
    assert set(groups) == {("pass", ColorType.RGBA), ("strip", ColorType.RGB),
                           ("ga", ColorType.GRAY_ALPHA)}
    assert sorted(fallback.tolist()) == [3, 4]
    _assert_bytes_equal_jax(batch, opts)


@pytest.mark.parametrize("preset", ["fast", "balanced"])
@pytest.mark.parametrize("ct", [ColorType.GRAY, ColorType.GRAY_ALPHA, ColorType.RGB, ColorType.RGBA])
def test_color_types_equal_jax(rng, ct, preset):
    c = ct.bytes_per_pixel
    base = np.add.outer(np.arange(40) * 3, np.arange(72) * 2)[..., None]
    imgs = (base + rng.normal(0, 6, (3, 40, 72, c))).clip(0, 255).astype(np.uint8)
    opts = getattr(PngOptions, preset)(72, 40).replace(color_type=ct)
    _assert_bytes_equal_jax(imgs, opts)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_levels_equal_jax(rng, level):
    imgs = _routing_batch()[:3, :, :, :3].copy()
    opts = PngOptions.fast(80, 64).replace(color_type=ColorType.RGB, compression_level=level)
    _assert_bytes_equal_jax(imgs, opts)


@pytest.mark.parametrize("level", [2, 6])
def test_deflate_parity_mode_equals_jax(monkeypatch, level):
    monkeypatch.setenv("PIXO_TPU_DEFLATE_PARITY", "1")
    batch = _routing_batch()
    opts = PngOptions.balanced(80, 64).replace(compression_level=level)
    outs = _assert_bytes_equal_jax(batch, opts)
    monkeypatch.delenv("PIXO_TPU_DEFLATE_PARITY")
    assert outs != encode_png_batch_sharded(batch, opts, device="cpu")


@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
@pytest.mark.parametrize("size", [(48, 40), (96, 72)], ids=["small_sticky", "large"])
def test_strategies_equal_jax(rng, strategy, size):
    """48x40 is a small image (Sub override) of height > 32; 96x72 neither."""
    w, h = size
    imgs = (np.add.outer(np.arange(h), np.arange(w))[..., None]
            + rng.integers(0, 9, (2, h, w, 4))).astype(np.uint8)
    _assert_bytes_equal_jax(imgs, PngOptions.fast(w, h).replace(filter_strategy=strategy))


def test_sticky_adaptive_fast_equals_jax(rng):
    imgs = rng.integers(0, 40, (2, 20, 300, 3), dtype=np.uint8)
    opts = PngOptions.fast(300, 20).replace(color_type=ColorType.RGB)
    _assert_bytes_equal_jax(imgs, opts)


def test_corpus_fixtures_equal_jax():
    imgs = np.stack([decode_png(open(f, "rb").read()).pixels for f in FIXTURES])
    assert imgs.shape == (4, 512, 512, 3)
    _assert_bytes_equal_jax(imgs, PngOptions.balanced(512, 512).replace(color_type=ColorType.RGB))


def test_chip_smoke_reader_equals_the_decoder():
    """chip_smoke.py reads the fixtures with zlib and a numpy unfilter of its own."""
    for f in FIXTURES:
        np.testing.assert_array_equal(chip_smoke.read_png(f), decode_png(open(f, "rb").read()).pixels)


def test_accepts_a_cpu_tensor_and_one_worker():
    batch = _routing_batch()
    opts = PngOptions.balanced(80, 64)
    assert encode_png_batch_sharded(torch.from_numpy(batch), opts, device="cpu", host_workers=1) \
        == encode_png_batch_sharded(batch, opts, device="cpu")


def test_empty_batch():
    assert encode_png_batch_sharded(np.zeros((0, 8, 8, 4), np.uint8), PngOptions.fast(8, 8),
                                    device="cpu") == []


UNPORTED = {
    "interlace": dict(interlace=True),
    "bit_depth_16": dict(bit_depth=16),
    "quantization_auto": dict(quantization=QuantizationOptions(mode=QuantizationMode.AUTO),
                              bit_depth=16),
    "quantization_force": dict(quantization=QuantizationOptions(mode=QuantizationMode.FORCE),
                               interlace=True),
    "bigrams": dict(filter_strategy=FilterStrategy.BIGRAMS),
    "optimal_compression": dict(optimal_compression=True),
}


def _encoded_or_error(encode):
    try:
        return encode()
    except (errors.PixoError, jax_errors.PixoError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("name", list(UNPORTED))
def test_unported_options_raise(name):
    """The option sets that raised ``NotImplementedError`` until the rest of
    lossless PNG was ported (ROADMAP.md queue 1 item 8, closed) give the JAX
    package's files now, or its error where it raises one (16-bit with AUTO
    quantization: ``CompressionError``): ``png.encode``, the batch encode
    and ``png.encode_batch`` on the CPU, also under the max preset."""
    opts = PngOptions.fast(8, 8).replace(**UNPORTED[name])
    dtype = np.uint16 if opts.bit_depth == 16 else np.uint8
    noise = np.random.default_rng(5).integers(0, 256, (8, 8, 4)).astype(dtype)
    for img in (np.zeros((8, 8, 4), dtype), noise):
        for o in (opts, PngOptions.max(8, 8).replace(**UNPORTED[name])):
            ref = _encoded_or_error(lambda: jax_png.encode(img, _jax_options(o)))
            assert _encoded_or_error(lambda: png.encode(img, o)) == ref
            for batch in (lambda: encode_png_batch_sharded(img[None], o, device="cpu"),
                          lambda: png.encode_batch(img[None], o, device="cpu")):
                out = _encoded_or_error(batch)
                assert out == (ref if isinstance(ref, tuple) else [ref])
    if name == "quantization_auto":
        assert ref[0] == "CompressionError"


def test_invalid_options_raise():
    imgs = np.zeros((1, 8, 8, 4), np.uint8)
    with pytest.raises(errors.InvalidCompressionLevel):
        encode_png_batch_sharded(imgs, PngOptions.fast(8, 8).replace(compression_level=0), device="cpu")
    with pytest.raises(errors.InvalidDataLength):
        encode_png_batch_sharded(imgs, PngOptions.fast(8, 9), device="cpu")
    with pytest.raises(errors.InvalidDimensions):
        png.encode(b"", PngOptions.fast(0, 8))
    with pytest.raises(TypeError, match="uint8"):
        encode_png_batch_sharded(imgs.astype(np.int16), PngOptions.fast(8, 8), device="cpu")


def test_verbose_filter_log(capsys):
    img = np.random.default_rng(0).integers(0, 256, (70, 70, 4), dtype=np.uint8)
    opts = PngOptions.balanced(70, 70).replace(verbose_filter_log=True)
    assert png.encode(img, opts) == jax_png.encode(img, _jax_options(opts))
    err = capsys.readouterr().err
    assert "PNG filters: strategy=ADAPTIVE, rows=70" in err


def test_host_library_keeps_its_own_checksums_when_zlib_is_loaded_first():
    """The port's core.cpp exports its checksums as pixo_crc32/pixo_adler32,
    not under zlib's names, and its build binds the library's own calls to
    its own definitions (``-Wl,-Bsymbolic``): with libz.so.1 already loaded
    in the process, as it is next to torch's CUDA libraries, DEFLATE's
    Adler-32 call and the bindings still reach the library's own code. When
    the exports shared zlib's names, that call landed in zlib and crashed."""
    code = (
        "import ctypes, zlib\n"
        "ctypes.CDLL('libz.so.1', mode=ctypes.RTLD_GLOBAL)\n"
        "from pixo_tpu_torch import native\n"
        "d = bytes(range(256)) * 100\n"
        "assert zlib.decompress(native.native_deflate(d, 6, True)) == d\n"
        "assert native.native_crc32(d) == zlib.crc32(d)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
