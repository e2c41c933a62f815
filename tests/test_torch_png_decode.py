"""The port's PNG decode against the JAX package's, on the CPU.

Every case decodes the same file with ``pixo_tpu_torch.decode.decode_png``
and ``pixo_tpu.decode.decode_png`` and holds pixels, width, height and
colour type equal (exact: the decode is integer work), or holds both to the
same error class and message. Files: the four corpus PNGs, the golden oracle
set's PNGs, files the JAX package encodes in every colour type, and files of
an independent writer (``tests/support/png_writer.py``) in every valid colour
type x bit depth, plain and Adam7, with every filter, palettes with and
without tRNS. Inputs come from numpy seeds.
"""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from pixo_tpu import ColorType as JaxColorType
from pixo_tpu import PngOptions as JaxPngOptions
from pixo_tpu import errors as jax_errors
from pixo_tpu import png as jax_png
from pixo_tpu.compress.deflate import inflate_raw as jax_inflate_raw
from pixo_tpu.compress.deflate import inflate_zlib as jax_inflate_zlib
from pixo_tpu.decode import decode_png as jax_decode_png
from pixo_tpu.decode.png_decoder import strip_metadata_chunks as jax_strip

from pixo_tpu_torch import decode_png_batch, errors
from pixo_tpu_torch.compress.deflate import inflate_raw, inflate_zlib
from pixo_tpu_torch.decode import PngImage, decode_png
from pixo_tpu_torch.decode import decode_png_batch as decode_png_batch_workers
from pixo_tpu_torch.decode import png_decoder
from tests.support.png_writer import _chunk, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO, "tests", "fixtures", "corpus_*_512.png")))
ORACLE = sorted(glob.glob(os.path.join(REPO, "tests", "golden", "oracle", "png-*.bin")))
VALID_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _same(data, **kw):
    got, want = decode_png(data, **kw), jax_decode_png(data, **kw)
    assert isinstance(got, PngImage)
    assert (got.width, got.height) == (want.width, want.height)
    assert int(got.color_type) == int(want.color_type)
    assert got.pixels.dtype == want.pixels.dtype and got.pixels.shape == want.pixels.shape
    np.testing.assert_array_equal(got.pixels, want.pixels)
    assert got.data == want.data
    return got


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p) for p in CORPUS])
def test_corpus_pngs(path):
    img = _same(_read(path))
    assert img.pixels.shape[:2] == (512, 512)


@pytest.mark.parametrize("path", ORACLE, ids=[os.path.basename(p)[4:12] for p in ORACLE])
def test_oracle_pngs(path):
    _same(_read(path))


@pytest.mark.parametrize("ct", ["GRAY", "GRAY_ALPHA", "RGB", "RGBA"])
@pytest.mark.parametrize("preset", ["fast", "balanced"])
def test_files_the_jax_package_encodes(ct, preset):
    jct = JaxColorType[ct]
    rng = np.random.default_rng(11 + int(jct))
    h, w = 23, 37
    img = rng.integers(0, 256, (h, w, jct.bytes_per_pixel), dtype=np.uint8)
    opts = getattr(JaxPngOptions, preset)(w, h).replace(color_type=jct)
    _same(jax_png.encode(img, opts))


def _samples(rng, h, w, color_type, depth, palette_size=None):
    top = palette_size if palette_size else 1 << depth
    shape = (h, w) if CHANNELS[color_type] == 1 else (h, w, CHANNELS[color_type])
    return rng.integers(0, top, shape)


DEPTH_CASES = [(ct, d) for ct, depths in VALID_DEPTHS.items() for d in depths]


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("color_type,depth", DEPTH_CASES)
def test_every_color_type_and_depth(color_type, depth, interlace):
    """Every valid colour type x bit depth (1/2/4-bit gray and indexed, 16-bit
    with ``keep_bit_depth`` off and on), rows cycling through all five
    filters, plain and Adam7, at a width that ends inside a byte."""
    rng = np.random.default_rng(100 * color_type + depth + interlace)
    h, w = 11, 13
    palette = rng.integers(0, 256, (min(1 << depth, 256), 3)) if color_type == 3 else None
    data = write_png(_samples(rng, h, w, color_type, depth), depth, color_type, palette=palette,
                     interlace=interlace, filter_mode="cycle")
    _same(data)
    if depth == 16:
        assert _same(data, keep_bit_depth=True).pixels.dtype == np.uint16


@pytest.mark.parametrize("trns", [None, "opaque", "partial", "longer"])
@pytest.mark.parametrize("depth", [2, 8])
def test_palette_with_and_without_trns(depth, trns):
    """tRNS upgrades the output to RGBA only with a non-opaque entry; a
    palette shorter than the indices gives opaque black; a tRNS longer than
    the palette is cut."""
    rng = np.random.default_rng(depth)
    n = 3 if depth == 2 else 40
    palette = rng.integers(0, 256, (n, 3))
    idx = rng.integers(0, 1 << depth if depth == 2 else 64, (9, 14))  # some beyond the palette
    payload = {None: None, "opaque": bytes([255] * n),
               "partial": bytes(rng.integers(0, 256, max(n - 1, 1), dtype=np.uint8)),
               "longer": bytes(rng.integers(0, 255, n + 5, dtype=np.uint8))}[trns]
    img = _same(write_png(idx, depth, 3, palette=palette, trns=payload))
    assert img.pixels.shape[2] == (4 if trns in ("partial", "longer") else 3)


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (7, 13), (9, 10), (8, 8), (1, 40), (40, 1)])
def test_adam7_shapes(h, w):
    """Sizes where some passes are empty."""
    rng = np.random.default_rng(h * 50 + w)
    for color_type, depth in ((2, 8), (0, 1), (6, 16)):
        _same(write_png(_samples(rng, h, w, color_type, depth), depth, color_type, interlace=1,
                        filter_mode="cycle"))


@pytest.mark.parametrize("bpp", range(1, 9))
@pytest.mark.parametrize("ftype", range(5))
def test_unfilter_equals_plain_reference(ftype, bpp):
    """The library's row reconstruction against ``_unfilter_py`` on random
    rows of one filter id, and of all five mixed."""
    rng = np.random.default_rng(10 * bpp + ftype)
    for h, rb in ((6, 5 * bpp + 3), (3, bpp), (9, 64 + bpp)):
        rows = rng.integers(0, 256, (h, rb + 1), dtype=np.uint8)
        rows[:, 0] = ftype
        rows[h // 2:, 0] = rng.integers(0, 5, h - h // 2)
        got = png_decoder.unfilter(rows.tobytes(), h, rb, bpp)
        np.testing.assert_array_equal(got, png_decoder._unfilter_py(rows, bpp))


def _good():
    rng = np.random.default_rng(5)
    return write_png(rng.integers(0, 256, (6, 7, 3)), 8, 2, filter_mode="cycle")


def _rechunk(data, edit):
    """``data`` with ``edit(type, body)`` -> body, a list of (type, body), or
    None (drop) applied to every chunk, CRCs made anew."""
    out, pos = bytearray(data[:8]), 8
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        new = edit(ctype, body)
        if new is None:
            continue
        for t, b in (new if isinstance(new, list) else [(ctype, new)]):
            out += _chunk(t, b)
    return bytes(out)


def _ihdr(**fields):
    names = ("width", "height", "depth", "color_type", "comp", "filt", "interlace")

    def edit(ctype, body):
        if ctype != b"IHDR":
            return body
        vals = dict(zip(names, struct.unpack(">IIBBBBB", body)))
        vals.update(fields)
        return struct.pack(">IIBBBBB", *[vals[n] for n in names])

    return _rechunk(_good(), edit)


def _idat(raw_edit):
    """The good file with its inflated rows passed through ``raw_edit``."""
    return _rechunk(_good(), lambda t, b: zlib.compress(raw_edit(zlib.decompress(b)))
                    if t == b"IDAT" else b)


def _bad_filter(raw):
    raw = bytearray(raw)
    raw[0] = 5
    return bytes(raw)


def _corrupt_crc():
    data = bytearray(_good())
    data[8 + 8 + 13] ^= 0xFF  # the first byte of IHDR's CRC
    return bytes(data)


MALFORMED = {
    "bad signature": lambda: b"\x89PNX" + _good()[4:],
    "too short": lambda: b"\x89PNG",
    "truncated chunk": lambda: _good()[:-20],
    "CRC mismatch": _corrupt_crc,
    "IHDR of 12 bytes": lambda: _rechunk(_good(), lambda t, b: b[:12] if t == b"IHDR" else b),
    "zero width": lambda: _ihdr(width=0),
    "zero height": lambda: _ihdr(height=0),
    "too wide": lambda: _ihdr(width=65536),
    "bad depth": lambda: _ihdr(depth=4),
    "bad color type": lambda: _ihdr(color_type=5),
    "bad compression method": lambda: _ihdr(comp=1),
    "bad interlace": lambda: _ihdr(interlace=2),
    "missing PLTE": lambda: _ihdr(color_type=3),
    "bad PLTE length": lambda: _rechunk(
        _good(), lambda t, b: [(b"IHDR", b), (b"PLTE", b"\x00" * 4)] if t == b"IHDR" else b),
    "missing IDAT": lambda: _rechunk(_good(), lambda t, b: None if t == b"IDAT" else b),
    "missing IEND": lambda: _rechunk(_good(), lambda t, b: None if t == b"IEND" else b),
    "missing IHDR": lambda: _rechunk(_good(), lambda t, b: None if t == b"IHDR" else b),
    "filter id 5": lambda: _idat(_bad_filter),
    "inflated size too small": lambda: _idat(lambda raw: raw[:-3]),
    "inflated size too large": lambda: _idat(lambda raw: raw + b"\x00" * 9),
    "trailing compressed input": lambda: _rechunk(
        _good(), lambda t, b: zlib.compress(zlib.decompress(b) + b"\x01" * 4000) if t == b"IDAT" else b),
    "corrupt deflate stream": lambda: _rechunk(
        _good(), lambda t, b: b[:6] + bytes(x ^ 0x55 for x in b[6:]) if t == b"IDAT" else b),
    "not a zlib stream": lambda: _rechunk(
        _good(), lambda t, b: b"\x00" * len(b) if t == b"IDAT" else b),
    "decoded size above the cap": lambda: _ihdr(width=65535, height=65535, color_type=6, depth=16),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_inputs_raise_the_same_error(case):
    data = MALFORMED[case]()
    with pytest.raises(jax_errors.PixoError) as want:
        jax_decode_png(data)
    with pytest.raises(errors.PixoError) as got:
        decode_png(data)
    assert type(got.value).__name__ == type(want.value).__name__ == "InvalidDecode"
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("wrap", ["zlib", "raw"])
def test_inflate_equals_jax_package(wrap):
    """With and without the size cap; an oversize or trailing stream raises
    the same message."""
    rng = np.random.default_rng(8)
    payload = bytes(rng.integers(0, 7, 5000, dtype=np.uint8))
    if wrap == "zlib":
        packed, mine, theirs = zlib.compress(payload), inflate_zlib, jax_inflate_zlib
    else:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        packed, mine, theirs = co.compress(payload) + co.flush(), inflate_raw, jax_inflate_raw
    assert mine(packed, len(payload)) == theirs(packed, len(payload)) == payload
    assert mine(packed) == payload
    assert mine(b"" if wrap == "raw" else zlib.compress(b""), 0) == b""
    for size in (len(payload) - 1, 10):
        with pytest.raises(jax_errors.InvalidDecode) as want:
            theirs(packed, size)
        with pytest.raises(errors.InvalidDecode) as got:
            mine(packed, size)
        assert str(got.value) == str(want.value)


def test_decode_png_batch_keeps_order():
    rng = np.random.default_rng(21)
    files = [write_png(rng.integers(0, 256, (5 + k, 9 - k, 3)), 8, 2, filter_mode=k % 5)
             for k in range(7)]
    files.append(write_png(rng.integers(0, 65536, (4, 4)), 16, 0))
    singles = [decode_png(f) for f in files]
    for batch in (decode_png_batch(files, host_workers=3), decode_png_batch_workers(files, workers=2),
                  decode_png_batch_workers(files[:1])):
        for got, want in zip(batch, singles):
            np.testing.assert_array_equal(got.pixels, want.pixels)
    kept = decode_png_batch_workers(files, keep_bit_depth=True)
    assert kept[-1].pixels.dtype == np.uint16 and kept[0].pixels.dtype == np.uint8
    assert decode_png_batch([]) == []
    with pytest.raises(errors.InvalidDecode, match="bad signature"):
        decode_png_batch(files[:2] + [b"nope"] + files[2:])


def test_strip_metadata_chunks_equal_bytes():
    text = [(b"tEXt", b"Comment\x00hello"), (b"tIME", b"\x07\xe8\x01\x02\x03\x04\x05"),
            (b"zTXt", b"k\x00\x00" + zlib.compress(b"v")), (b"iTXt", b"k\x00\x00\x00\x00\x00v"),
            (b"gAMA", struct.pack(">I", 45455))]
    data = _rechunk(_good(), lambda t, b: [(t, b)] + text if t == b"IHDR" else b)
    got = png_decoder.strip_metadata_chunks(data)
    assert got == jax_strip(data)
    assert b"tEXt" not in got and b"tIME" not in got and b"gAMA" in got
    np.testing.assert_array_equal(decode_png(got).pixels, decode_png(_good()).pixels)
    for odd in (b"not a png", data[:40], _good()):
        assert png_decoder.strip_metadata_chunks(odd) == jax_strip(odd)
