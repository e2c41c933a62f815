"""The port's host library against the JAX package's, export by export.

The port compiles its own ``native/core.cpp``; the JAX package compiles
``pixo_tpu/native/core.cpp``. Every export of the port's source gets a
seeded case here that goes through the port's binding and through the JAX
package's binding of the same entry point, and the results must be equal.
This is what lets a change to the port's copy be checked: the outputs stay
the JAX package's. The checksums, which the port's library exports as
``pixo_crc32`` and ``pixo_adler32``, are also held to ``zlib``.

The decode entry points take their arguments from real files: the port's
decoder runs on JPEGs the port encodes, with spies that record what it hands
each binding (and the coefficient planes as they were before each
progressive scan), and each recorded call is then replayed through both
bindings on fresh planes.
"""

import ctypes
import re
import zlib

import numpy as np
import pytest
import torch

from pixo_tpu import native as jnative

from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, jpeg, native
from pixo_tpu_torch.decode import jpeg_decoder
from pixo_tpu_torch.jpeg.tables import ZIGZAG, HuffmanTables, QuantizationTables
from pixo_tpu_torch.ops import lz77_assist, sparse_pack
from pixo_tpu_torch.ops.resize_kernels import lanczos_taps

PATTERNS = {"gray": (0,), "444": (0, 1, 2), "420": (0, 0, 0, 0, 1, 2), "422": (0, 0, 1, 2)}
SCANS = [(0, 0, 0, 1), (0, 0, 1, 0), (1, 5, 0, 2), (1, 5, 2, 1), (6, 63, 0, 0), (1, 63, 0, 0)]


def exports():
    """The names the port's source exports, each once (``deflate_compress``
    is declared ahead of its definition)."""
    with open(native.SOURCE) as f:
        names = re.findall(r"^EXPORT\s+[\w\s\*]*?\b(\w+)\s*\(", f.read(), re.M)
    return sorted(set(names))


def _zz(rng, n, density=0.15):
    """[n, 64] int16 zigzag blocks in the baseline tables' range."""
    zz = np.zeros((n, 64), np.int16)
    zz[:, 0] = rng.integers(-1000, 1001, n)
    mask = rng.random((n, 63)) < density
    zz[:, 1:] = np.where(mask, rng.integers(-1000, 1001, (n, 63)), 0)
    zz[0, 1:] = 0
    if n > 1:
        zz[1, 1:] = rng.integers(-3, 4, 63)
    return zz


def _bytes(rng, n):
    """Compressible bytes: runs, repeats and noise."""
    parts, size = [], 0
    while size < n:
        kind = rng.integers(0, 3)
        if kind == 0:
            part = bytes([int(rng.integers(0, 256))]) * int(rng.integers(1, 300))
        elif kind == 1 and parts:
            part = parts[int(rng.integers(0, len(parts)))][: int(rng.integers(1, 200))]
        else:
            part = rng.integers(0, 256, int(rng.integers(1, 100))).astype(np.uint8).tobytes()
        parts.append(part)
        size += len(part)
    return b"".join(parts)[:n]


def _image(rng, h, w, c=3):
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)
    img = (base[..., None] + rng.normal(0, 20, (h, w, c))).clip(0, 255).astype(np.uint8)
    return img[..., 0].copy() if c == 1 else img


def _tables():
    return HuffmanTables.default()


def _eq(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


# ---------------------------------------------------------------- checksums

def _checksum_inputs(rng):
    return [b"", b"\x00", bytes(range(256)), _bytes(rng, 100_000),
            rng.integers(0, 256, 5553).astype(np.uint8).tobytes()]


def case_pixo_crc32(rng):
    for data in _checksum_inputs(rng):
        for start in (0, 0xDEADBEEF):
            got = native.native_crc32(data, start)
            assert got == jnative.native_crc32(data, start) == zlib.crc32(data, start)


def case_pixo_adler32(rng):
    for data in _checksum_inputs(rng):
        for start in (1, 0x1234ABCD % 65521 | (77 << 16)):
            got = native.native_adler32(data, start)
            assert got == jnative.native_adler32(data, start) == zlib.adler32(data, start)


# ---------------------------------------------------------------- JPEG encode

def case_jpeg_pack_scan(rng):
    for mode, pattern in PATTERNS.items():
        zz = _zz(rng, len(pattern) * 10)
        for restart in (None, 1, 3):
            assert native.native_pack_scan(zz, pattern, _tables(), restart) == \
                jnative.native_pack_scan(zz, pattern, _tables(), restart)


def case_jpeg_pack_scan_batch(rng):
    pattern = PATTERNS["420"]
    zz = np.stack([_zz(rng, 36) for _ in range(5)])
    for restart, threads in ((None, 1), (2, 3)):
        got = native.native_pack_scan_batch(zz, pattern, _tables(), restart, threads)
        assert got == jnative.native_pack_scan_batch(zz, pattern, _tables(), restart, threads)


def case_jpeg_pack_scan_padded(rng):
    pattern = PATTERNS["444"]
    zz = _zz(rng, 60, density=0.1)
    zz[:, 33:] = 0
    dc, counts, poss, vals, _, maxcount = (a.numpy() for a in sparse_pack.sparsify_blocks_padded(
        torch.from_numpy(zz), sparse_pack.PADDED_CAP_MAX))
    assert int(maxcount) <= sparse_pack.PADDED_CAP_MAX
    for restart in (None, 4):
        assert native.native_pack_scan_padded(dc, counts, poss, vals, pattern, _tables(), restart) == \
            jnative.native_pack_scan_padded(dc, counts, poss, vals, pattern, _tables(), restart)


def case_jpeg_pack_scan_sparse(rng):
    pattern = PATTERNS["420"]
    zz = _zz(rng, 60)
    dc, counts, poss, vals, _ = (a.numpy() for a in sparse_pack.sparsify_blocks(
        torch.from_numpy(zz), 64))
    for restart in (None, 2):
        assert native.native_pack_scan_sparse(dc, counts, poss, vals, pattern, _tables(), restart) == \
            jnative.native_pack_scan_sparse(dc, counts, poss, vals, pattern, _tables(), restart)


def case_jpeg_count_symbols(rng):
    for mode, pattern in PATTERNS.items():
        zz = _zz(rng, len(pattern) * 12)
        for restart in (None, 2):
            _eq(native.native_count_symbols(zz, pattern, restart),
                jnative.native_count_symbols(zz, pattern, restart))


def _prog_tables():
    t = _tables()
    return t.dc_lum_codes, t.dc_lum_lengths, t.ac_lum_codes, t.ac_lum_lengths


def case_jpeg_encode_progressive_scan(rng):
    blocks = _zz(rng, 50, density=0.3)
    blocks[:, 1:] //= 4
    done = 0
    for ss, se, ah, al in SCANS:
        for eobn in (None, False, True):
            got = native.native_encode_progressive_scan(blocks, ss, se, ah, al, *_prog_tables(),
                                                        eobn_ok=eobn)
            assert got == jnative.native_encode_progressive_scan(blocks, ss, se, ah, al,
                                                                 *_prog_tables(), eobn_ok=eobn)
            done += got is not None
    assert done


def case_jpeg_count_progressive_scan(rng):
    blocks = _zz(rng, 50, density=0.3)
    blocks[:, 1:] //= 4
    for ss, se, ah, al in SCANS:
        counts = [[np.zeros(12, np.int64), np.zeros(256, np.int64)] for _ in range(2)]
        ok = native.native_count_progressive_scan(blocks, ss, se, ah, al, *counts[0])
        assert ok == jnative.native_count_progressive_scan(blocks, ss, se, ah, al, *counts[1])
        _eq(tuple(counts[0]), tuple(counts[1]))


def _qtables(quality):
    q = QuantizationTables(quality)
    return q.luminance_table, q.chrominance_table


def case_jpeg_coefficients(rng):
    for mode in PATTERNS:
        img = _image(rng, 19, 37, 1 if mode == "gray" else 3)
        for quality in (30, 90):
            _eq(native.native_jpeg_coefficients(img, mode, *_qtables(quality)),
                jnative.native_jpeg_coefficients(img, mode, *_qtables(quality)))


def case_jpeg_dct_zz(rng):
    for mode in PATTERNS:
        img = _image(rng, 23, 29, 1 if mode == "gray" else 3)
        _eq(native.native_jpeg_dct_zz(img, mode), jnative.native_jpeg_dct_zz(img, mode))


def case_jpeg_encode_scan_fused(rng):
    # not 4:2:2: the fused call counts its blocks as 4:2:0's, and no path takes it there
    for mode in ("gray", "444", "420"):
        img = _image(rng, 21, 35, 1 if mode == "gray" else 3)
        for restart in (None, 2):
            got = native.native_jpeg_encode_scan(img, mode, *_qtables(75), PATTERNS[mode], _tables(),
                                                 restart)
            assert got == jnative.native_jpeg_encode_scan(img, mode, *_qtables(75), PATTERNS[mode],
                                                          _tables(), restart)


def case_jpeg_trellis_quantize(rng):
    img = _image(rng, 32, 48)
    dct_zz = native.native_jpeg_dct_zz(img, "420")
    lum, chrom = (t[ZIGZAG].astype(np.float32) for t in _qtables(80))
    for lam, threads in ((1.0, 1), (0.5, 3)):
        _eq(native.native_trellis_quantize(dct_zz, PATTERNS["420"], lum, chrom, lam, threads),
            jnative.native_trellis_quantize(dct_zz, PATTERNS["420"], lum, chrom, lam, threads))


def case_huffman_build_lengths(rng):
    for n, max_len in ((12, 16), (19, 7), (256, 16), (288, 15), (30, 15), (1, 15), (2, 1)):
        freqs = rng.integers(0, 1000, n) * (rng.random(n) < 0.7)
        freqs[rng.integers(0, n)] = 10**6
        _eq(native.native_build_code_lengths(freqs, max_len),
            jnative.native_build_code_lengths(freqs, max_len))


# ---------------------------------------------------------------- DEFLATE and PNG

def case_deflate_compress(rng):
    for n in (0, 1, 1000, 70_000):
        data = _bytes(rng, n)
        for level in (1, 6, 9):
            for wrap in (False, True):
                assert native.native_deflate(data, level, wrap) == jnative.native_deflate(data, level, wrap)


def case_deflate_compress_parity(rng):
    for n in (0, 500, 20_000):
        data = _bytes(rng, n)
        for level in (1, 6, 9):
            for wrap, packed in ((True, False), (True, True), (False, False)):
                got = native.native_deflate(data, level, wrap, parity=True, packed=packed)
                assert got == jnative.native_deflate(data, level, wrap, parity=True, packed=packed)


def case_deflate_compress_optimal(rng):
    for n in (0, 3000):
        data = _bytes(rng, n)
        for wrap in (False, True):
            assert native.native_deflate_optimal(data, 3, wrap) == \
                jnative.native_deflate_optimal(data, 3, wrap)


def case_deflate_compress_optimal_assisted(rng):
    data = _bytes(rng, 3000)
    cand, lens = lz77_assist.chain_candidates(torch.from_numpy(np.frombuffer(data, np.uint8).copy()), k=8)
    cand, lens = cand.numpy(), lens.numpy()
    got = native.native_deflate_optimal_assisted(data, 3, True, cand, lens)
    assert got == jnative.native_deflate_optimal_assisted(data, 3, True, cand, lens)
    assert got == native.native_deflate_optimal(data, 3, True)


def case_deflate_optimal_parity(rng):
    for n, iterations in ((0, 5), (2500, 5), (2500, 2)):
        data = _bytes(rng, n)
        assert native.native_deflate_optimal_parity(data, iterations) == \
            jnative.native_deflate_optimal_parity(data, iterations)


def case_inflate_decompress(rng):
    for n in (0, 1, 5000, 60_000):
        data = _bytes(rng, n)
        for level in (0, 1, 9):
            wrapped = zlib.compress(data, level)
            for stream, wrap in ((wrapped, True), (wrapped[2:-4], False)):
                got = native.native_inflate(stream, n, wrap)
                assert got == jnative.native_inflate(stream, n, wrap) == data
    bad = zlib.compress(_bytes(rng, 2000))[:-40]
    with pytest.raises(native.NativeInflateError):
        native.native_inflate(bad, 2000, True)
    assert jnative.native_inflate(bad, 2000, True) is None


def case_png_filter_apply(rng):
    for h, rb, bpp in ((1, 3, 3), (13, 60, 3), (9, 64, 4), (17, 40, 1), (6, 96, 8)):
        rows = rng.integers(0, 256, (h, rb)).astype(np.uint8)
        rows[h // 2:] //= 16
        for mode in range(8):
            for sticky in (False, True):
                _eq(native.native_png_filter(rows, bpp, mode, sticky),
                    jnative.native_png_filter(rows, bpp, mode, sticky))


def case_png_unfilter(rng):
    for h, rb, bpp in ((1, 3, 3), (12, 48, 3), (7, 64, 4), (20, 17, 1), (5, 48, 6)):
        rows = np.concatenate([rng.integers(0, 5, (h, 1)), rng.integers(0, 256, (h, rb))], axis=1)
        rows = rows.astype(np.uint8)
        _eq(native.native_png_unfilter(rows, bpp), jnative.native_png_unfilter(rows, bpp))


def case_png_palette_expand(rng):
    lut = rng.integers(0, 256, (256, 4)).astype(np.uint8)
    for shape in ((1,), (37, 23), (1000,)):
        samples = rng.integers(0, 256, shape).astype(np.uint8)
        for channels in (3, 4):
            got = native.native_palette_expand(samples, lut, channels)
            ref = jnative.native_palette_expand(samples, lut, channels)
            np.testing.assert_array_equal(got.reshape(-1), np.asarray(ref).reshape(-1))


def case_nearest_palette_batch(rng):
    for n, k in ((1, 1), (777, 16), (5000, 256)):
        colors = rng.integers(0, 256, (n, 4)).astype(np.uint8)
        palette = rng.integers(0, 256, (k, 4)).astype(np.uint8)
        palette[-1] = palette[0]  # a tie
        _eq(native.native_nearest_palette(colors, palette), jnative.native_nearest_palette(colors, palette))


def case_palette_lut_build(rng):
    for k in (1, 7, 256):
        palette = rng.integers(0, 256, (k, 4)).astype(np.uint8)
        _eq(native.native_palette_lut(palette), jnative.native_palette_lut(palette))


def case_dither_fs(rng):
    for h, w, k in ((1, 1, 2), (17, 23, 16), (40, 64, 256)):
        rgba = _image(rng, h, w, 4).reshape(-1, 4)
        palette = rng.integers(0, 256, (k, 4)).astype(np.uint8)
        lut = native.native_palette_lut(palette)
        _eq(native.native_dither_fs(rgba, w, h, palette, lut),
            jnative.native_dither_fs(rgba, w, h, palette, lut))


def case_resize_lanczos3_host(rng):
    for (h, w, c), (dh, dw) in (((40, 56, 3), (16, 20)), ((17, 9, 4), (34, 30)), ((8, 8, 1), (8, 8)),
                                ((30, 31, 2), (1, 7))):
        img = _image(rng, h, w, c) if c > 1 else _image(rng, h, w, 1)[..., None]  # [h, w, 1]
        sx, wx = lanczos_taps(w, dw)
        sy, wy = lanczos_taps(h, dh)
        _eq(native.native_resize_lanczos3(img, sx, wx, sy, wy),
            jnative.native_resize_lanczos3(img, sx, wx, sy, wy))


# ---------------------------------------------------------------- JPEG decode

@pytest.fixture(scope="module")
def decode_calls():
    """What the port's decoder hands each decode binding, on baseline
    (gray, 4:4:4, 4:2:0 and 4:2:2, with and without restarts) and
    progressive (with and without successive approximation) files, under
    both pixel tiers and both upsamplings."""
    rng = np.random.default_rng(7)
    files = []
    for sub, gray, progressive, sa, restart in (
            ("444", True, False, False, None), ("444", False, False, False, 1),
            ("420", False, False, False, 2), ("422", False, False, False, None),
            ("420", False, True, True, None), ("444", False, True, False, None),
            ("420", True, True, True, None)):
        img = _image(rng, 27, 42, 1 if gray else 3)
        opts = JpegOptions(width=42, height=27, quality=80, subsampling=Subsampling(sub),
                           color_type=ColorType.GRAY if gray else ColorType.RGB,
                           restart_interval=restart, optimize_huffman=progressive,
                           progressive=progressive, progressive_sa=sa)
        files.append(jpeg.encode(img, opts, device="cpu"))
    calls = {"scan": [], "baseline": [], "pixels": [], "dc": [], "ac": []}

    def spy(kind, fn, snapshot):
        def call(*args, **kw):
            calls[kind].append((args, kw, snapshot(args)))
            return fn(*args, **kw)
        return call

    none = lambda args: None  # noqa: E731
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpeg_decoder, "native_jpeg_decode_scan_call",
                   spy("scan", jpeg_decoder.native_jpeg_decode_scan_call, lambda a: [p.shape for p in a[8]]))
        mp.setattr(jpeg_decoder, "native_jpeg_decode_baseline_call",
                   spy("baseline", jpeg_decoder.native_jpeg_decode_baseline_call, none))
        mp.setattr(jpeg_decoder, "native_jpeg_decode_pixels_call",
                   spy("pixels", jpeg_decoder.native_jpeg_decode_pixels_call,
                       lambda a: [np.array(c) for c in a[0]]))
        mp.setattr(jpeg_decoder, "native_jpeg_prog_dc_scan",
                   spy("dc", jpeg_decoder.native_jpeg_prog_dc_scan, lambda a: [p.copy() for p in a[-1]]))
        mp.setattr(jpeg_decoder, "native_jpeg_prog_ac_scan",
                   spy("ac", jpeg_decoder.native_jpeg_prog_ac_scan, lambda a: a[-1].copy()))
        for tier in ("host", "device"):
            mp.setenv("PIXO_TPU_DECODE_PIXELS", tier)
            for data in files:
                for fancy in (False, True):
                    jpeg_decoder.decode_jpeg(data, fancy, device="cpu")
    assert all(calls.values()), {k: len(v) for k, v in calls.items()}
    return calls


def case_jpeg_decode_scan(rng, calls):
    for args, _, shapes in calls["scan"]:
        mine = [np.zeros(s, np.int16) for s in shapes]
        theirs = [np.zeros(s, np.int16) for s in shapes]
        assert native.native_jpeg_decode_scan_call(*args[:8], mine)()
        assert jnative.native_jpeg_decode_scan(*args[:8], theirs, np.zeros(len(shapes), np.int32))
        assert any(p.any() for p in mine)
        _eq(tuple(mine), tuple(theirs))


def case_jpeg_decode_baseline(rng, calls):
    for args, kw, _ in calls["baseline"]:
        got = native.native_jpeg_decode_baseline_call(*args, **kw)()
        assert got is not None
        _eq(got, jnative.native_jpeg_decode_baseline(*args, **kw))


def case_jpeg_decode_pixels(rng, calls):
    for args, kw, coeffs in calls["pixels"]:
        got = native.native_jpeg_decode_pixels_call(coeffs, *args[1:], **kw)()
        assert got is not None
        _eq(got, jnative.native_jpeg_decode_pixels(coeffs, *args[1:], **kw))


def case_jpeg_prog_dc_segment(rng, calls):
    changed = 0
    for args, _, before in calls["dc"]:
        segments, ranges, rest = args[0], args[1], args[2:-1]
        mine = [p.copy() for p in before]
        theirs = [p.copy() for p in before]
        native.native_jpeg_prog_dc_scan(segments, ranges, *rest, mine)
        for seg, (u0, u1) in zip(segments, ranges):
            if u0 < u1:
                jnative.native_jpeg_prog_dc_segment(seg, u0, u1, *rest, theirs,
                                                    np.zeros(len(before), np.int32))
        _eq(tuple(mine), tuple(theirs))
        changed += any(not np.array_equal(m, b) for m, b in zip(mine, before))
    assert changed


def case_jpeg_prog_ac_segment(rng, calls):
    changed = 0
    for args, _, before in calls["ac"]:
        segments, ranges, rest = args[0], args[1], args[2:-1]
        mine, theirs = before.copy(), before.copy()
        native.native_jpeg_prog_ac_scan(segments, ranges, *rest, mine)
        for seg, (u0, u1) in zip(segments, ranges):
            if u0 < u1:
                jnative.native_jpeg_prog_ac_segment(seg, u0, u1, *rest, theirs, np.zeros(1, np.int64))
        _eq(mine, theirs)
        changed += not np.array_equal(mine, before)
    assert changed


DECODE = {"jpeg_decode_scan", "jpeg_decode_baseline", "jpeg_decode_pixels", "jpeg_prog_dc_segment",
          "jpeg_prog_ac_segment"}
CASES = {name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")}


def test_every_export_has_a_case():
    assert sorted(CASES) == exports()


def test_every_export_is_bound():
    lib = native.load()
    for name in exports():
        assert getattr(lib, name).argtypes is not None, name


def test_no_export_carries_zlibs_names():
    with open(native.SOURCE) as f:
        text = f.read()
    assert not re.search(r"^EXPORT\s+\w+\s+(crc32|adler32)\s*\(", text, re.M)
    lib = native.load()
    for name in ("crc32", "adler32"):
        with pytest.raises(AttributeError):
            ctypes.CDLL(native.library_path)[name]
    assert lib.pixo_crc32 and lib.pixo_adler32


@pytest.mark.parametrize("name", sorted(set(CASES) - DECODE))
def test_export_equals_jax_package(name):
    CASES[name](np.random.default_rng(sorted(CASES).index(name)))


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_export_equals_jax_package(name, decode_calls):
    CASES[name](np.random.default_rng(0), decode_calls)
