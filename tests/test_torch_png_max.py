"""The port's PNG max preset against the JAX package's, byte for byte, on the
CPU: the Bigrams filter (``filter_rows``' plain version, the host library's
mode 7), the optimal DEFLATE and the rest of ``compress/``, the max-preset
files of every colour type and reduction, the files of pixo's own oracle in
parity mode, mode 7's shared-memory plan, and the device default of every
entry point.

Inputs come from a numpy seed; images are small. Bigrams runs only on images
of more than 4096 pixels (smaller ones take Sub, as in the reference), so the
max-preset images here are 72x60.
"""

import inspect
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from pixo_tpu import compress as jax_compress
from pixo_tpu import png as jax_png
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.compress import huffman as jax_huffman
from pixo_tpu.ops import png_filters as jax_filters
from pixo_tpu.options import FilterStrategy as JaxFilterStrategy
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.parallel.pipeline import encode_png_batch_sharded as jax_encode_batch

from chip_smoke import bigram_edge_cases
from pixo_tpu_torch import ColorType, FilterStrategy, PngOptions, compress, encode_png_batch_sharded, png
from pixo_tpu_torch.compress import huffman
from pixo_tpu_torch.native import native_png_filter
from pixo_tpu_torch.ops import kernels, png_filters

sys.path.insert(0, str(Path(__file__).resolve().parent / "support"))

from pixo_oracle import cached_call  # noqa: E402
from test_oracle_parity import _grad, _mix24, _noise, _pal4, _text24  # noqa: E402

jax.config.update("jax_platforms", "cpu")

BIGRAMS = FilterStrategy.BIGRAMS


def _jax_max(w, h, ct: ColorType) -> JaxPngOptions:
    return JaxPngOptions.max(w, h).replace(color_type=JaxColorType(int(ct)))


# ------------------------------------------------------------- the filter

def _bigram_rows(rng, bpp):
    """(label, [B, H, RB] uint8) for ``bpp``: rows of 1, 2 and bpp bytes,
    noise and low noise, constant rows (every candidate counts one pair) and
    identical ramp rows (Up and Paeth tie)."""
    ramp = (np.arange(3 * bpp + 20) % 256).astype(np.uint8)
    return [
        ("rb 1", rng.integers(0, 256, (2, 5, 1), dtype=np.uint8)),
        ("rb 2", rng.integers(0, 256, (2, 5, 2), dtype=np.uint8)),
        ("rb bpp", rng.integers(0, 256, (2, 5, bpp), dtype=np.uint8)),
        ("noise", rng.integers(0, 256, (2, 9, 37), dtype=np.uint8)),
        ("low noise", rng.integers(0, 5, (2, 9, 41), dtype=np.uint8)),
        ("constant", np.full((2, 6, 3 * bpp + 1), 77, np.uint8)),
        ("tied ramp", np.broadcast_to(ramp, (2, 7, ramp.size)).copy()),
    ]


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("bpp", range(1, 9))
def test_bigrams_plain_equals_jax_and_host(bpp, small):
    """``filter_rows_plain`` and the ``filter_rows`` wrapper under Bigrams
    against the JAX package's ``filter_image_batch`` with strategy
    "bigrams" and against the host library's mode 7 (on a small image:
    Sub, for all three)."""
    rng = np.random.default_rng(100 + bpp)
    mode = png_filters.native_mode(png_filters.resolve_strategy(BIGRAMS, small))
    assert mode == (1 if small else 7)
    for label, host in _bigram_rows(rng, bpp):
        rows = torch.from_numpy(host)
        kw = dict(bpp=bpp, strategy=BIGRAMS, small_image=small, sticky_fast=False)
        got = png_filters.filter_rows_plain(rows, **kw).numpy()
        assert np.array_equal(kernels.filter_rows(rows, **kw).numpy(), got), label
        filt, ids = jax_filters.filter_image_batch(host, bpp=bpp, strategy="bigrams",
                                                    small_image=small, sticky_fast=False)
        assert np.array_equal(got[..., 0], np.asarray(ids)), label
        assert np.array_equal(got[..., 1:], np.asarray(filt)), label
        for i in range(len(host)):
            assert np.array_equal(got[i], native_png_filter(host[i], bpp, mode, False)), label


def test_bigram_ties_take_the_lowest_filter_id():
    """Constant rows: every candidate counts one pair, None wins. Identical
    ramp rows: Up and Paeth count one pair, Up wins; on row 0 Sub and Paeth
    tie, Sub wins. Rows of one byte count no pair: None."""
    bpp = 3
    kw = dict(bpp=bpp, strategy=BIGRAMS, small_image=False, sticky_fast=False)
    const = png_filters.filter_rows_plain(torch.zeros((1, 4, 10), dtype=torch.uint8), **kw)
    assert const[0, :, 0].tolist() == [0, 0, 0, 0]
    ramp = torch.from_numpy(np.broadcast_to(np.arange(30, dtype=np.uint8), (1, 4, 30)).copy())
    scores = png_filters._bigram_scores(png_filters._candidates(ramp, bpp))[0]
    assert scores[1, 2] == scores[1, 4] == scores[1].min() and scores[1, :2].min() > scores[1, 2]
    assert scores[0, 1] == scores[0, 4] == scores[0].min() and scores[0, 0] > scores[0, 1]
    assert png_filters.filter_rows_plain(ramp, **kw)[0, :, 0].tolist() == [1, 2, 2, 2]
    one = png_filters.filter_rows_plain(torch.full((1, 3, 1), 200, dtype=torch.uint8), **kw)
    assert one[0, :, 0].tolist() == [0, 0, 0]


@pytest.mark.parametrize("bpp", [1, 4, 8])
def test_bigram_edge_cases_equal_the_host_filter(bpp):
    """chip_smoke's mode-7 edge shapes (the card holds the kernel to them):
    the plain version equals the host library's mode 7 on each."""
    kw = dict(bpp=bpp, strategy=BIGRAMS, small_image=False, sticky_fast=False)
    for label, host in bigram_edge_cases(np.random.default_rng(40 + bpp), bpp):
        got = png_filters.filter_rows_plain(torch.from_numpy(host), **kw).numpy()
        for i in range(len(host)):
            assert np.array_equal(got[i], native_png_filter(host[i], bpp, 7, False)), label


def _strip_smem(strip, rb, bigrams):
    region = lambda n: (n + 63) // 16 * 16  # noqa: E731
    return region((strip + 1) * rb) + region(strip * (rb + 1)) + (strip * 8192 if bigrams else 0)


@pytest.mark.parametrize("h", [1, 3, 4, 8, 9, 512])
def test_filter_rows_plan_under_mode_7_stays_within_the_budget(h):
    """Every row width up to the long-row switch: the strip's rows, output
    rows and 8 KB bitmaps fit ``FILTER_SMEM_BUDGET``; past the switch the
    long-row kernel takes the rows; mode 7 takes no more rows than the
    other modes at the same width."""
    budget, most = kernels.FILTER_SMEM_BUDGET, kernels.FILTER_STRIP_ROWS
    assert kernels.FILTER_BIGRAM_BYTES == 8192
    assert kernels.filter_rows_plan(512, 1536, False, True) == most  # PNG (a)'s rows
    assert _strip_smem(most, 1536, True) < 92 * 1024  # two strips fit an SM
    switched = False
    for rb in range(1, 25000):
        plan = kernels.filter_rows_plan(h, rb, False, True)
        assert plan <= kernels.filter_rows_plan(h, rb, False)
        if plan:
            assert not switched  # one switch, then long rows for every wider row
            assert _strip_smem(plan, rb, True) <= budget and plan >= min(4, h)
            assert plan == most or plan == h or _strip_smem(plan + 1, rb, True) > budget
        else:
            switched = True
            fits = [s for s in range(1, min(most, h) + 1) if _strip_smem(s, rb, True) <= budget]
            assert not fits or fits[-1] < min(4, h)
    assert switched or h < 4


# ------------------------------------------------------------- the encode

def _image(rng, ct: ColorType, h=60, w=72):
    base = np.add.outer(np.arange(h), 2 * np.arange(w))[..., None] % 256
    c = ct.bytes_per_pixel
    img = (base + rng.integers(0, 30, (h, w, c))).astype(np.uint8)
    if ct == ColorType.RGBA:
        img[..., 3] = rng.integers(100, 256, (h, w), dtype=np.uint8)
    return img


def _reduced(rng, kind, h=60, w=72):
    """Images that the max preset's reductions rewrite: (colour type, image)."""
    if kind == "gray as RGB":
        g = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
        return ColorType.RGB, np.repeat(g, 3, axis=-1)
    if kind == "4 gray levels (2-bit)":
        return ColorType.GRAY, (rng.integers(0, 4, (h, w, 1)) * 85).astype(np.uint8)
    if kind == "opaque RGBA":
        img = _image(rng, ColorType.RGBA, h, w)
        img[..., 3] = 255
        return ColorType.RGBA, img
    colours = rng.integers(0, 256, (int(kind.split()[0]), 4), dtype=np.uint8)
    colours[:, 3] = 255
    return ColorType.RGBA, colours[rng.integers(0, len(colours), (h, w))]


@pytest.mark.parametrize("ct", list(ColorType), ids=lambda c: c.name)
def test_max_preset_equals_jax(ct):
    rng = np.random.default_rng(int(ct))
    img = _image(rng, ct)
    opts = PngOptions.max(72, 60).replace(color_type=ct)
    assert png.encode(img, opts) == jax_png.encode(img, _jax_max(72, 60, ct))


@pytest.mark.parametrize("kind", ["gray as RGB", "4 gray levels (2-bit)", "opaque RGBA",
                                  "3 colours (2-bit palette)", "14 colours (4-bit palette)",
                                  "200 colours (8-bit palette)"])
def test_max_preset_reductions_equal_jax(kind):
    ct, img = _reduced(np.random.default_rng(7), kind)
    opts = PngOptions.max(72, 60).replace(color_type=ct)
    out = png.encode(img, opts)
    assert out == jax_png.encode(img, _jax_max(72, 60, ct))


def test_max_preset_batch_equals_jax():
    """The batch encode (device route: routing, layout, ``filter_rows`` in
    mode 7, then the optimal DEFLATE on the pool; per-image for the palette
    image) and ``png.encode_batch`` against the JAX package's batch."""
    rng = np.random.default_rng(11)
    _, pal = _reduced(rng, "14 colours (4-bit palette)")
    imgs = np.stack([_image(rng, ColorType.RGBA), _image(rng, ColorType.RGBA), pal])
    opts = PngOptions.max(72, 60).replace(color_type=ColorType.RGBA)
    want = jax_encode_batch(imgs, _jax_max(72, 60, ColorType.RGBA))
    assert encode_png_batch_sharded(imgs, opts, device="cpu") == want
    assert encode_png_batch_sharded(imgs, opts, device="cpu", host_workers=1) == want
    assert png.encode_batch(imgs, opts, device="cpu") == want
    assert png.encode_batch(torch.from_numpy(imgs), opts, device="cpu") == want


@pytest.mark.parametrize("preset", ["fast", "balanced"])
def test_bigrams_under_other_presets_equals_jax(preset):
    rng = np.random.default_rng(3)
    img = _image(rng, ColorType.RGB)
    opts = getattr(PngOptions, preset)(72, 60).replace(color_type=ColorType.RGB, filter_strategy=BIGRAMS)
    ref = getattr(JaxPngOptions, preset)(72, 60).replace(
        color_type=JaxColorType.RGB, filter_strategy=JaxFilterStrategy.BIGRAMS)
    assert png.encode(img, opts) == jax_png.encode(img, ref)
    assert encode_png_batch_sharded(img[None], opts, device="cpu") == [jax_png.encode(img, ref)]


ORACLE_CASES = [
    ("grad12", _grad(12, 12), 2),
    ("grad20", _grad(20, 20), 2),
    ("pal16", _pal4(16, 16), 2),
    ("text24", _text24(), 2),
    ("mix24", _mix24(), 2),
    ("noise24", _noise(24, 24, seed=2), 2),
    ("noise16", _noise(16, 16, seed=1), 2),
    ("rgba20", _grad(20, 20, 4), 3),
    ("gray20", _grad(20, 20, 1), 0),
    ("noisy_rgba20", _noise(20, 20, 4, seed=6), 3),
]
_PNG_CT = {0: ColorType.GRAY, 1: ColorType.GRAY_ALPHA, 2: ColorType.RGB, 3: ColorType.RGBA}


@pytest.mark.parametrize("name,img,code", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_max_preset_bytes_identical_to_pixo(name, img, code, monkeypatch):
    """pixo's own max-preset files (``tests/test_oracle_parity.py``'s cases,
    committed under ``tests/golden/oracle/``): under
    ``PIXO_TPU_DEFLATE_PARITY=1`` the port's ``png.encode`` and its batch
    encode give them byte for byte."""
    monkeypatch.setenv("PIXO_TPU_DEFLATE_PARITY", "1")
    monkeypatch.setenv("PIXO_TPU_ORACLE_NO_RUN", "1")
    h, w = img.shape[:2]
    ref = bytes(cached_call("png", img.tobytes(), w, h, code, 2, False))
    opts = PngOptions.from_preset(w, h, 2).replace(color_type=_PNG_CT[code])
    assert png.encode(img, opts) == ref
    assert encode_png_batch_sharded(img[None], opts, device="cpu") == [ref]


def test_max_preset_default_path_equals_jax(monkeypatch):
    """Out of parity mode the optimal DEFLATE is the performance path's
    parse, or the greedy level-9 stream where that is shorter, as in the
    JAX package."""
    monkeypatch.delenv("PIXO_TPU_DEFLATE_PARITY", raising=False)
    img = _grad(12, 12)
    opts = PngOptions.from_preset(12, 12, 2).replace(color_type=ColorType.RGB)
    out = png.encode(img, opts)
    assert out == jax_png.encode(img, _jax_max(12, 12, ColorType.RGB))


# ------------------------------------------------------------- compress

PAYLOADS = {
    "empty": b"",
    "one byte": b"\x07",
    "text": b"the quick brown fox jumps over the lazy dog. " * 200,
    "noise": np.random.default_rng(9).integers(0, 256, 5000, dtype=np.uint8).tobytes(),
    "runs": bytes(np.repeat(np.arange(40, dtype=np.uint8), 300)),
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_checksums_equal_jax_and_zlib(name):
    data = PAYLOADS[name]
    assert compress.crc32(data) == jax_compress.crc32(data) == zlib.crc32(data)
    assert compress.adler32(data) == jax_compress.adler32(data) == zlib.adler32(data)
    assert compress.crc32(data, 0x1234) == zlib.crc32(data, 0x1234)
    assert compress.adler32(data, 0x1234) == zlib.adler32(data, 0x1234)
    inc, ref = compress.Crc32(), jax_compress.Crc32()
    for part in (data[:7], data[7:100], data[100:]):
        inc.update(part)
        ref.update(part)
    assert inc.finalize() == ref.finalize() == zlib.crc32(data)


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_deflate_equals_jax_and_inflates(name, monkeypatch):
    data = PAYLOADS[name]
    for parity in ("0", "1"):
        monkeypatch.setenv("PIXO_TPU_DEFLATE_PARITY", parity)
        for level in (1, 6, 9):
            raw = compress.deflate_raw(data, level)
            assert raw == jax_compress.deflate_raw(data, level)
            assert zlib.decompress(raw, -15) == data
            assert compress.inflate_raw(raw, len(data)) == data
        optimal = compress.deflate_optimal_zlib(data)
        assert optimal == jax_compress.deflate_optimal_zlib(data)
        assert zlib.decompress(optimal) == data
        assert compress.deflate_optimal_zlib(data, 2) == jax_compress.deflate_optimal_zlib(data, 2)
        if parity == "0":
            assert len(optimal) <= len(compress.deflate_zlib(data, 9))


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_device_lz77_route_equals_jax(name, monkeypatch):
    """Under PIXO_TPU_LZ77=device the optimal DEFLATE reads its first chain
    steps from ``chain_candidates`` (its plain version for ``device="cpu"``):
    the JAX package's bytes under the same variable, which inflate back."""
    data = PAYLOADS[name]
    monkeypatch.delenv("PIXO_TPU_DEFLATE_PARITY", raising=False)
    monkeypatch.setenv("PIXO_TPU_LZ77", "device")
    out = compress.deflate_optimal_zlib(data, device="cpu")
    assert out == jax_compress.deflate_optimal_zlib(data)
    assert zlib.decompress(out) == data


@pytest.mark.parametrize("seed", range(4))
def test_huffman_codes_equal_jax(seed):
    rng = np.random.default_rng(seed)
    freqs = rng.integers(0, 1000, 286) * (rng.random(286) < 0.6)
    lengths, codes = huffman.build_codes(freqs)
    ref_lengths, ref_codes = jax_huffman.build_codes(freqs)
    assert np.array_equal(lengths, ref_lengths) and np.array_equal(codes, ref_codes)
    assert np.array_equal(huffman.generate_canonical_codes(lengths),
                          jax_huffman.generate_canonical_codes(lengths))
    assert np.array_equal(compress.build_codes(freqs, 7)[0], jax_compress.build_codes(freqs, 7)[0])


def test_huffman_tables_equal_jax():
    for code in range(64):
        for length in (1, 5, 6, 9, 15):
            assert huffman.reverse_bits(code, length) == jax_huffman.reverse_bits(code, length)
    assert np.array_equal(huffman.fixed_literal_lengths(), jax_huffman.fixed_literal_lengths())
    assert np.array_equal(huffman.fixed_distance_lengths(), jax_huffman.fixed_distance_lengths())
    assert sorted(compress.__all__) == sorted(jax_compress.__all__)


# ------------------------------------------------------------- device defaults

ENTRY_POINTS = [
    "pixo_tpu_torch.parallel.pipeline.encode_png_batch_sharded",
    "pixo_tpu_torch.parallel.pipeline.encode_png_row_sharded",
    "pixo_tpu_torch.parallel.pipeline.encode_jpeg_batch_sharded",
    "pixo_tpu_torch.parallel.pipeline.jpeg_coeffs_sharded",
    "pixo_tpu_torch.parallel.pipeline.trellis_coeffs_sharded",
    "pixo_tpu_torch.parallel.pipeline.decode_jpeg_batch",
    "pixo_tpu_torch.parallel.pipeline.thumbnail_pipeline",
    "pixo_tpu_torch.decode.batch.decode_jpeg_batch",
    "pixo_tpu_torch.decode.jpeg_decoder.decode_jpeg",
    "pixo_tpu_torch.resize.resize",
    "pixo_tpu_torch.resize.resize_into",
    "pixo_tpu_torch.cli.load_image",
    "pixo_tpu_torch.png.quantize.quantize_batch",
    "pixo_tpu_torch.png.encoder.encode_batch",
    "pixo_tpu_torch.png.encoder.encode",
    "pixo_tpu_torch.png.encoder.encode_indexed",
    "pixo_tpu_torch.compress.deflate.deflate_optimal_zlib",
    "pixo_tpu_torch.parallel.pipeline.png_frame",
    "pixo_tpu_torch.jpeg.encoder.encode",
    "pixo_tpu_torch.jpeg.encoder.encode_batch",
    "pixo_tpu_torch.ops.huffman_device.count_symbols",
]


@pytest.mark.parametrize("path", ENTRY_POINTS, ids=lambda p: p.split("pixo_tpu_torch.")[1])
def test_entry_points_default_to_the_card(path):
    import importlib

    module, name = path.rsplit(".", 1)
    param = inspect.signature(getattr(importlib.import_module(module), name)).parameters["device"]
    assert param.default == "cuda"
