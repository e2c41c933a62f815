"""The port's JPEG decode against the JAX package's, on the CPU.

Every comparison is bit-exact (tolerance 0): the integer IDCT, the
upsampling and the colour conversion are integer arithmetic, and the port
holds the reference's int32 wraparound. Inputs come from seeded numpy
generators; files come from the golden oracle set, the port's own encoder,
Pillow, and a small writer below that frames random coefficients under any
sampling factors (Pillow cannot write h1v2). Both packages pick their pixel
tier by ``PIXO_TPU_DECODE_PIXELS``, and a file's decode runs under each
(``TIERS``, set by ``monkeypatch``), the port's against the reference's
under the same tier: the host tier (the host library's tail, the default of
both on the CPU) and the device tier (the reference's jnp tail, the port's
plain PyTorch tail).
"""

import glob
import io
import os
import struct

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from pixo_tpu import errors as jerrors
from pixo_tpu.decode import decode_jpeg as ref_decode_jpeg
from pixo_tpu.ops import jpeg_decode as jdec
from pixo_tpu.ops.pallas_kernels import idct8x8_int_pallas

import chip_smoke
from chip_smoke import host_decode
from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded, errors
from pixo_tpu_torch.color import ColorType
from pixo_tpu_torch.decode import decode_jpeg, decode_jpeg_batch, jpeg_decoder
from pixo_tpu_torch.jpeg import markers
from pixo_tpu_torch.jpeg.tables import HuffmanTables, QuantizationTables
from pixo_tpu_torch.native import native_pack_scan
from pixo_tpu_torch.ops import jpeg_decode, kernels
from pixo_tpu_torch.parallel import pipeline

ORACLE = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "oracle", "jpeg-*.bin")))
I16 = np.array([-32768, -32767, -1024, -1, 0, 1, 1023, 32766, 32767], np.int16)


# ------------------------------------------------------------------ inputs


def _coeff_blocks(rng, n, kind):
    """[n, 64] int16 zigzag blocks: "conforming" (a photo's range) or
    "extreme" (int16 extremes, which overflow int32 once dequantized)."""
    if kind == "conforming":
        zz = np.zeros((n, 64), np.int16)
        zz[:, 0] = rng.integers(-1024, 1024, n)
        zz[:, 1:] = np.where(rng.random((n, 63)) < 0.3, rng.integers(-200, 201, (n, 63)), 0)
        return zz
    return rng.choice(I16, (n, 64))


def _qtable(rng, which):
    if which == "q255":
        return np.full(64, 255, np.uint16)
    if which == "q65535":
        return np.full(64, 65535, np.uint16)
    return rng.integers(1, 256, 64).astype(np.uint16)


def _port_jpeg(img, subsampling=Subsampling.S420, quality=85, restart=None):
    h, w = img.shape[:2]
    gray = img.ndim == 2
    opts = JpegOptions(width=w, height=h, quality=quality, subsampling=subsampling,
                       color_type=ColorType.GRAY if gray else ColorType.RGB,
                       restart_interval=restart)
    return encode_jpeg_batch_sharded(img[None], opts, device="cpu")[0]


def _pillow_jpeg(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _synth_jpeg(rng, width, height, sampling, restart=None, quality=75):
    """A baseline JPEG of random coefficients under ``sampling``, one (h, v)
    per component (1 or 3 components), with the standard tables: the
    blocks go through the native packer in MCU order and get their own SOF."""
    ncomp = len(sampling)
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcus = -(-width // (8 * max_h)) * -(-height // (8 * max_v))
    pattern = [ci for ci, (h, v) in enumerate(sampling) for _ in range(h * v)]
    zz = np.zeros((mcus * len(pattern), 64), np.int16)
    zz[:, 0] = rng.integers(-60, 60, len(zz))
    zz[:, 1:16] = np.where(rng.random((len(zz), 15)) < 0.4, rng.integers(-30, 31, (len(zz), 15)), 0)
    scan = native_pack_scan(zz, pattern, HuffmanTables.default(), restart)
    out = bytearray()
    markers.write_soi(out)
    markers.write_dqt(out, QuantizationTables(quality))
    out += struct.pack(">HHBHHB", markers.SOF0, 8 + 3 * ncomp, 8, height, width, ncomp)
    for ci, (h, v) in enumerate(sampling):
        out += bytes([ci + 1, (h << 4) | v, int(ci > 0)])
    markers.write_dht(out, HuffmanTables.default())
    if restart:
        markers.write_dri(out, restart)
    markers.write_sos(out, ColorType.GRAY if ncomp == 1 else ColorType.RGB)
    out += scan
    markers.write_eoi(out)
    return bytes(out)


def _photo(rng, h, w, c=3):
    """A smooth image with noise: realistic coefficient statistics."""
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 7.0) * 60 + np.cos(y / 5.0) * 50 + 128)[..., None]
    img = base + rng.normal(0, 12, (h, w, c)) + np.arange(c) * 20
    img = img.clip(0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


# ------------------------------------------------------------------ comparisons


def _outcome(fn):
    """Pixels, or the error's class name and message."""
    try:
        return fn()
    except (errors.PixoError, jerrors.PixoError) as e:
        return type(e).__name__, str(e)


def _same(a, b) -> bool:
    if isinstance(a, tuple) or isinstance(b, tuple):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


TIERS = ["host", "device"]


def _reference(monkeypatch, data, fancy, tier):
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    return _outcome(lambda: ref_decode_jpeg(data, fancy).pixels)


def _check_decode(monkeypatch, data, fancy, tier, ref_tier=None):
    """The port's decode with ``device="cpu"`` under pixel tier ``tier``
    against the reference's under the same tier (or ``ref_tier``)."""
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    got = _outcome(lambda: decode_jpeg(data, fancy, device="cpu").pixels)
    ref = _reference(monkeypatch, data, fancy, ref_tier or tier)
    assert _same(got, ref), (tier, got if isinstance(got, tuple) else "pixels",
                             ref if isinstance(ref, tuple) else "pixels")
    return got


# ------------------------------------------------------------------ the tail alone


@pytest.mark.parametrize("kind", ["conforming", "extreme"])
@pytest.mark.parametrize("table", ["q255", "q65535", "random"])
def test_dequant_idct_blocks_equals_jnp(kind, table):
    """The extremes wrap int32 on every block: the NumPy mirror differs
    there, the jnp tier and the port do not."""
    rng = np.random.default_rng(11)
    zz, q = _coeff_blocks(rng, 600, kind), _qtable(rng, table)
    ref = np.asarray(jdec.dequant_idct_blocks(jnp.asarray(zz), jnp.asarray(q.astype(np.int32))[None]))
    got = jpeg_decode.dequant_idct_blocks(torch.from_numpy(zz), torch.from_numpy(q.astype(np.int32))[None])
    np.testing.assert_array_equal(got.numpy(), ref)
    if kind == "extreme":
        assert not np.array_equal(jdec.dequant_idct_blocks_np(zz, q.astype(np.int32)[None]), ref)


@pytest.mark.parametrize("kind", ["conforming", "extreme"])
@pytest.mark.parametrize("table", ["q255", "q65535"])
def test_idct8x8_int_equals_jnp_and_pallas(kind, table):
    """The TPU kernel's own contract, natural-order int32 blocks, against
    its jnp twin and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(12)
    zz, q = _coeff_blocks(rng, 513, kind), _qtable(rng, table)
    deq = zz.astype(np.int32) * q.astype(np.int32)
    natural = np.ascontiguousarray(deq[:, np.argsort(jdec.ZIGZAG)].reshape(-1, 8, 8))
    pallas = np.asarray(idct8x8_int_pallas(jnp.asarray(natural), interpret=True))
    np.testing.assert_array_equal(pallas, np.asarray(jdec.idct8x8_int(jnp.asarray(natural))))
    blocks = torch.from_numpy(natural)
    np.testing.assert_array_equal(jpeg_decode.idct8x8_int(blocks).numpy(), pallas)
    np.testing.assert_array_equal(kernels.idct8x8_int(blocks).numpy(), pallas)


def test_idct8x8_int_full_int32_range():
    rng = np.random.default_rng(13)
    natural = rng.integers(-2**31, 2**31, (300, 8, 8)).astype(np.int32)
    ref = np.asarray(idct8x8_int_pallas(jnp.asarray(natural), interpret=True))
    np.testing.assert_array_equal(jpeg_decode.idct8x8_int(torch.from_numpy(natural)).numpy(), ref)


def _planes_case(rng, kind):
    """Three planes with a gap of blocks between two of them, one pitch
    wider than its row, and output offsets out of block order."""
    dims = [(3, 2), (4, 3), (1, 5)]
    planes, first = [], 0
    offs = [4096, 0, 2048]
    for (bw, bh), off, pad in zip(dims, offs, (0, 16, 0)):
        planes.append((first, bw, bh, off, 8 * bw + pad))
        first += bw * bh + (2 if bw == 3 else 0)
    zz = _coeff_blocks(rng, first, kind)
    q = np.stack([_qtable(rng, t) for t in ("random", "q65535", "q255")])
    return zz, q, np.asarray(planes, np.int64)


@pytest.mark.parametrize("kind", ["conforming", "extreme"])
def test_idct_planes_plain_equals_assembled_jnp_planes(kind):
    rng = np.random.default_rng(14)
    zz, q, planes = _planes_case(rng, kind)
    out = kernels.idct_planes(torch.from_numpy(zz), q, planes).numpy()
    written = np.zeros(out.shape, bool)
    for (first, bw, bh, off, pitch), qt in zip(planes, q):
        blocks = jdec.dequant_idct_blocks(jnp.asarray(zz[first: first + bw * bh]),
                                          jnp.asarray(qt.astype(np.int32))[None])
        plane = np.asarray(jdec.assemble_plane(blocks, int(bw), int(bh)))
        raster = out[off: off + 8 * bh * pitch].reshape(8 * bh, pitch)
        np.testing.assert_array_equal(raster[:, :8 * bw], plane)
        written[off: off + 8 * bh * pitch].reshape(8 * bh, pitch)[:, :8 * bw] = True
    assert not out[~written].any()  # bytes outside every plane are zero


def _assembled(zz, q, planes, out):
    """Checks ``out`` plane by plane against the JAX package's tail, and that
    every byte outside the planes is zero."""
    written = np.zeros(out.shape, bool)
    for (first, bw, bh, off, pitch), qt in zip(planes, q):
        blocks = jdec.dequant_idct_blocks(jnp.asarray(zz[first: first + bw * bh]),
                                          jnp.asarray(qt.astype(np.int32))[None])
        plane = np.asarray(jdec.assemble_plane(blocks, int(bw), int(bh)))
        raster = out[off: off + 8 * bh * pitch].reshape(8 * bh, pitch)
        np.testing.assert_array_equal(raster[:, :8 * bw], plane)
        written[off: off + 8 * bh * pitch].reshape(8 * bh, pitch)[:, :8 * bw] = True
    assert not out[~written].any()


def test_idct_planes_at_the_kernel_edge_layout_equals_jnp_and_pallas():
    """The layout the card checks the kernel at (three planes in one thread
    block's 128 coefficient blocks, a plane of one block, gaps, pitches wider
    than their planes, blocks before the first plane and after the last,
    int16 extremes with tables of 255 and 65535): the wrapper on the CPU
    against the JAX package's dequant + IDCT + assembly, and its blocks
    against the Pallas kernel in interpret mode."""
    zz, q, planes = chip_smoke.plane_edge_case(np.random.default_rng(15))
    out = kernels.idct_planes(torch.from_numpy(zz), q, planes).numpy()
    _assembled(zz, q, planes, out)
    table = kernels.PlaneTable(planes, len(zz), q)
    assert not table.tiled
    np.testing.assert_array_equal(kernels.idct_planes_table(torch.from_numpy(zz), table).numpy(), out)
    for (first, bw, bh, off, pitch), qt in zip(planes, q):
        deq = zz[first: first + bw * bh].astype(np.int32) * qt.astype(np.int32)
        natural = np.ascontiguousarray(deq[:, np.argsort(jdec.ZIGZAG)].reshape(-1, 8, 8))
        pallas = np.asarray(idct8x8_int_pallas(jnp.asarray(natural), interpret=True))
        raster = out[off: off + 8 * bh * pitch].reshape(bh, 8, pitch)[:, :, :8 * bw]
        got = raster.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
        np.testing.assert_array_equal(got, pallas)


def _descriptors_as_the_wrapper_packed_them(qtables, planes, n):
    """The plane table as ``idct_planes`` checked and packed it on every
    call before the decoder's layout took that over: 38 int64 a plane, the
    int32 zigzag table in the first 32, then the five geometry fields."""
    planes = np.ascontiguousarray(np.asarray(planes, dtype=np.int64))
    q = np.ascontiguousarray(np.asarray(qtables).astype(np.int32))
    first, bpr, brows, off, pitch = planes.T
    nb = bpr * brows
    assert first[0] >= 0 and (first[1:] >= first[:-1] + nb[:-1]).all() and first[-1] + nb[-1] <= n
    packed = np.zeros((len(planes), 38), np.int64)
    packed[:, :32] = q.view(np.int64)
    packed[:, 32:37] = planes
    out_size = int((off + 8 * brows * pitch).max())
    return packed, out_size, int((64 * nb).sum()) == out_size


def test_layout_packs_the_plane_table_once_as_the_wrapper_did():
    """A mixed batch (4:2:0, 4:4:4, gray, a progressive file): the table the
    layout packs, with the tables the entropy stage read, equals the
    wrapper's packing of the same planes, and a call with it equals a call
    with the numpy tables."""
    rng = np.random.default_rng(16)
    files = [_port_jpeg(_photo(rng, 40, 56)), _port_jpeg(_photo(rng, 24, 24), Subsampling.S444),
             _port_jpeg(_photo(rng, 33, 17, 1)), _port_jpeg(_photo(rng, 40, 56), quality=60),
             open(FIXTURES[0], "rb").read()]
    batch = jpeg_decoder._host_stage(files, 1)
    assert batch.staging is None  # nothing is pinned for the CPU
    table = batch.layout.table
    scans = [jpeg_decoder._parse(f) for f in files]
    qtables = np.stack([jpeg_decoder._qtables(scans[i])[ci] for i, ci in batch.layout.qtable_of])
    packed, out_size, tiled = _descriptors_as_the_wrapper_packed_them(
        qtables, batch.layout.planes, len(batch.coeffs))
    np.testing.assert_array_equal(table.packed, packed)
    assert table.packed.dtype == np.int64 and table.packed.flags.c_contiguous
    assert (table.out_size, table.tiled, table.n) == (out_size, tiled, len(batch.coeffs))
    np.testing.assert_array_equal(batch.qtables, qtables.astype(np.int32))
    coeffs, desc = batch.to_device(torch.device("cpu"))
    assert desc is None
    np.testing.assert_array_equal(
        kernels.idct_planes_table(coeffs, table).numpy(),
        kernels.idct_planes(coeffs, qtables, batch.layout.planes.copy()).numpy())


def test_plane_table_refuses_another_batch():
    table = kernels.PlaneTable(np.asarray([[0, 1, 1, 0, 8]]), 4, np.ones((1, 64)))
    with pytest.raises(ValueError, match="checked for 4 blocks"):
        kernels.idct_planes_table(torch.zeros((5, 64), dtype=torch.int16), table)
    with pytest.raises(ValueError, match="qtables"):
        table.set_qtables(np.ones((2, 64)))


def test_idct_planes_refuses_bad_tables():
    zz = torch.zeros((10, 64), dtype=torch.int16)
    q = np.ones((1, 64), np.uint16)
    for planes, match in (
        ([[0, 2, 3, 0, 15]], "multiples of 8"),
        ([[0, 2, 3, 0, 8]], "full row"),
        ([[5, 2, 3, 0, 16]], "inside the coefficients"),
        ([[0, 0, 3, 0, 16]], "at least one block"),
    ):
        with pytest.raises(ValueError, match=match):
            kernels.idct_planes(zz, q, np.asarray(planes))
    with pytest.raises(ValueError, match="sorted"):
        kernels.idct_planes(zz, np.ones((2, 64)), np.asarray([[4, 1, 1, 0, 8], [0, 1, 1, 64, 8]]))
    with pytest.raises(ValueError, match="qtables"):
        kernels.idct_planes(zz, np.ones((2, 64)), np.asarray([[0, 1, 1, 0, 8]]))
    with pytest.raises(TypeError):
        kernels.idct_planes(zz.int(), q, np.asarray([[0, 1, 1, 0, 8]]))


# ------------------------------------------------------------------ upsampling and colour


@pytest.mark.parametrize("h_ratio", [1, 2, 3, 4])
@pytest.mark.parametrize("v_ratio", [1, 2, 3, 4])
def test_upsample_nearest_equals_jnp(h_ratio, v_ratio):
    plane = np.random.default_rng(15).integers(0, 256, (13, 11)).astype(np.int32)
    ref = np.asarray(jdec.upsample_nearest(jnp.asarray(plane), h_ratio, v_ratio))
    got = jpeg_decode.upsample_nearest(torch.from_numpy(plane), h_ratio, v_ratio)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ratios", [(1, 2), (2, 1), (2, 2), (1, 1), (3, 1), (2, 4)],
                         ids=lambda r: f"h{r[0]}v{r[1]}")
@pytest.mark.parametrize("shape", [(13, 11), (1, 7), (9, 1)])
def test_upsample_triangle_equals_jnp(ratios, shape):
    """Odd plane sizes and one-row/one-column planes; (3, 1) and (2, 4) fall
    back to nearest, as the reference's does. A batch of planes equals the
    planes one by one."""
    planes = np.random.default_rng(16).integers(0, 256, (3,) + shape).astype(np.int32)
    got = jpeg_decode.upsample_triangle(torch.from_numpy(planes), *ratios).numpy()
    for plane, g in zip(planes, got):
        np.testing.assert_array_equal(g, np.asarray(jdec.upsample_triangle(jnp.asarray(plane), *ratios)))


def test_ycbcr_to_rgb_int_equals_jnp():
    rng = np.random.default_rng(17)
    y = rng.integers(0, 256, (2, 33, 17)).astype(np.int32)
    cb, cr = (rng.integers(-128, 128, (2, 33, 17)).astype(np.int32) for _ in range(2))
    cb[0, 0, :2] = cr[0, 1, :2] = -128
    cb[0, 2, :2] = cr[0, 3, :2] = 127
    ref = np.asarray(jdec.ycbcr_to_rgb_int(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr)))
    got = jpeg_decode.ycbcr_to_rgb_int(*(torch.from_numpy(a) for a in (y, cb, cr)))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_assemble_plane_equals_jnp():
    blocks = np.random.default_rng(18).integers(0, 256, (2, 12, 8, 8)).astype(np.uint8)
    got = jpeg_decode.assemble_plane(torch.from_numpy(blocks), 4, 3).numpy()
    for b, g in zip(blocks, got):
        np.testing.assert_array_equal(g, np.asarray(jdec.assemble_plane(jnp.asarray(b), 4, 3)))


# ------------------------------------------------------------------ whole decodes


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
@pytest.mark.parametrize("path", ORACLE, ids=lambda p: os.path.basename(p)[5:13])
@pytest.mark.parametrize("tier", TIERS)
def test_oracle_files_equal_reference(monkeypatch, path, fancy, tier):
    """The 16 golden oracle JPEGs, baseline and progressive, up to
    3220x1812. The 7 progressive ones are the pixo encoder's output, which
    the reference decoder rejects: the port raises the same error."""
    with open(path, "rb") as f:
        data = f.read()
    _check_decode(monkeypatch, data, fancy, tier)


def test_oracle_set_is_whole():
    assert len(ORACLE) == 16


PORT_CASES = [
    ("gray", Subsampling.S444, (37, 29)),
    ("444", Subsampling.S444, (23, 45)),
    ("420", Subsampling.S420, (61, 47)),
    ("422", Subsampling.S422, (50, 19)),
    ("420-one-mcu", Subsampling.S420, (5, 3)),
]


@pytest.mark.parametrize("restart", [None, 1, 3], ids=["no-rst", "rst1", "rst3"])
@pytest.mark.parametrize("label,sub,size", PORT_CASES, ids=[c[0] for c in PORT_CASES])
@pytest.mark.parametrize("tier", TIERS)
def test_port_encoded_files_equal_reference(monkeypatch, label, sub, size, restart, tier):
    h, w = size
    img = _photo(np.random.default_rng(19), h, w, 1 if label == "gray" else 3)
    data = _port_jpeg(img, sub, restart=restart)
    for fancy in (False, True):
        _check_decode(monkeypatch, data, fancy, tier)


PILLOW_CASES = [
    ("prog-420-rst-rows", dict(progressive=True, subsampling=2, restart_marker_rows=1, quality=80)),
    ("prog-444-rst-blocks", dict(progressive=True, subsampling=0, restart_marker_blocks=3, quality=92)),
    ("prog-422", dict(progressive=True, subsampling=1, quality=70)),
    ("prog-gray-rst", dict(progressive=True, restart_marker_rows=2, quality=85)),
    ("base-optimized-420", dict(optimize=True, subsampling=2, quality=60)),
]


@pytest.mark.parametrize("label,kw", PILLOW_CASES, ids=[c[0] for c in PILLOW_CASES])
@pytest.mark.parametrize("tier", TIERS)
def test_pillow_files_equal_reference(monkeypatch, label, kw, tier):
    img = _photo(np.random.default_rng(20), 45, 61, 1 if "gray" in label else 3)
    data = _pillow_jpeg(img, **kw)
    for fancy in (False, True):
        _check_decode(monkeypatch, data, fancy, tier)


FIXTURES = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "fixtures", "progressive_*.jpg")))


@pytest.mark.parametrize("path", FIXTURES, ids=lambda p: os.path.basename(p)[12:-4])
@pytest.mark.parametrize("tier", TIERS)
def test_progressive_fixtures_equal_reference(monkeypatch, path, tier):
    """Progressive photos that the card's checks decode (it has no Pillow):
    Pillow 12.1 saves of the corpus fixtures, cropped to (h, w), with
    progressive=True and: browser 512x512 4:2:0 q85 restart_marker_rows=1;
    rocket 509x383 4:4:4 q90; playground 512x512 4:2:2 q80
    restart_marker_blocks=7; web 497x511 gray q85."""
    with open(path, "rb") as f:
        data = f.read()
    assert b"\xff\xc2" in data  # SOF2
    for fancy in (False, True):
        assert not isinstance(_check_decode(monkeypatch, data, fancy, tier), tuple)


def test_progressive_fixtures_are_all_there():
    assert [os.path.basename(p) for p in FIXTURES] == [
        f"progressive_{n}.jpg" for n in ("browser", "playground", "rocket", "web")]


SYNTH_CASES = [
    ("h1v2", ((1, 2), (1, 1), (1, 1))),
    ("h2v1", ((2, 1), (1, 1), (1, 1))),
    ("h3v1", ((3, 1), (1, 1), (1, 1))),
    ("h4v2", ((4, 2), (1, 1), (1, 1))),
    ("h2v2-cr-h1v2", ((2, 2), (1, 1), (1, 2))),
    ("luma-subsampled", ((1, 1), (2, 2), (2, 2))),
]


@pytest.mark.parametrize("restart", [None, 2], ids=["no-rst", "rst2"])
@pytest.mark.parametrize("label,sampling", SYNTH_CASES, ids=[c[0] for c in SYNTH_CASES])
@pytest.mark.parametrize("tier", TIERS)
def test_sampling_factors_equal_reference(monkeypatch, label, sampling, restart, tier):
    """Sampling factors past the port's encoder: h1v2, the ratio 3 that the
    host library declines, ratio 4, chroma planes of different sizes, and
    luma smaller than chroma."""
    data = _synth_jpeg(np.random.default_rng(21), 53, 35, sampling, restart)
    for fancy in (False, True):
        assert not isinstance(_check_decode(monkeypatch, data, fancy, tier), tuple)


def _progressive_small():
    return _pillow_jpeg(_photo(np.random.default_rng(22), 30, 41), progressive=True,
                        subsampling=2, restart_marker_rows=1, quality=85)


def _declined(*args):
    """A native baseline scan call that declines, as it does a corrupt stream."""
    return lambda: False


def _decline_baseline(monkeypatch):
    """Both native baseline decodes of the port decline: the scan call of the
    device tier, and the fused call that the host tier takes first."""
    monkeypatch.setattr(jpeg_decoder, "native_jpeg_decode_scan_call", _declined)
    monkeypatch.setattr(jpeg_decoder, "native_jpeg_decode_baseline_call", lambda *a, **k: lambda: None)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("kind", ["baseline", "baseline-rst"])
def test_python_entropy_tier_equals_reference(monkeypatch, kind, tier):
    """With the native baseline decoder declined, the port's Python bit
    reader equals the reference's Python tier (native library disabled),
    under either of the port's pixel tiers."""
    rng = np.random.default_rng(23)
    data = {
        "baseline": lambda: _port_jpeg(_photo(rng, 21, 34)),
        "baseline-rst": lambda: _synth_jpeg(rng, 30, 20, ((1, 2), (1, 1), (1, 1)), restart=2),
    }[kind]()
    _decline_baseline(monkeypatch)
    monkeypatch.setenv("PIXO_TPU_DISABLE_NATIVE", "1")
    for fancy in (False, True):
        _check_decode(monkeypatch, data, fancy, tier, ref_tier="host")


@pytest.mark.parametrize("tier", TIERS)
def test_python_entropy_tier_in_a_threaded_batch(monkeypatch, tier):
    """A batch whose baseline calls all decline: the Python tier decodes
    each (the device tier's on the calling thread, beside the progressive
    files; the host tier's on the pool), and every image equals its decode
    through the native calls."""
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    files = _mixed_batch()
    want = decode_jpeg_batch(files, workers=4, device="cpu")
    _decline_baseline(monkeypatch)
    got = decode_jpeg_batch(files, workers=4, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pixels, w.pixels)


# ------------------------------------------------------------------ errors


def _drop_restart_segments(data: bytes) -> bytes:
    """End the file at the scan's first RST marker: one segment is left."""
    return data[: data.index(b"\xff\xd0", data.index(b"\xff\xda"))] + b"\xff\xd9"


def _ones_in_last_scan(data: bytes) -> bytes:
    """All one bits (stuffed) through the middle of the last scan's entropy
    data: no Huffman code is all ones, so the native decoder fails there."""
    start = data.rindex(b"\xff\xda")
    start += 2 + int.from_bytes(data[start + 2: start + 4], "big")
    mid, n = (start + len(data) - 2) // 2, 8
    return data[:mid] + b"\xff\x00" * n + data[mid + 2 * n:]


def _error_cases():
    rng = np.random.default_rng(24)
    base = _port_jpeg(_photo(rng, 40, 48), Subsampling.S444)
    prog = _progressive_small()
    rst = _port_jpeg(_photo(rng, 64, 64), Subsampling.S444, restart=1)
    sof = base.index(b"\xff\xc0")
    four_three = bytearray(base)
    four_three[sof + 11], four_three[sof + 14], four_three[sof + 17] = 0x41, 0x31, 0x31
    twelve_bit = bytearray(base)
    twelve_bit[sof + 4] = 12
    sof1 = bytearray(base)
    sof1[sof + 1] = 0xC1
    zero = bytearray(base)
    zero[sof + 5: sof + 7] = b"\x00\x00"
    return {
        "garbage": b"this is not a JPEG file",
        "empty": b"",
        "truncated-baseline": base[: len(base) // 2],
        "truncated-progressive": prog[: len(prog) // 2],
        "progressive-no-eoi": prog[:-2],
        "progressive-invalid-code": _ones_in_last_scan(prog),
        "missing-restart-segment": _drop_restart_segments(rst),
        "fractional-4:3": bytes(four_three),
        "12-bit": bytes(twelve_bit),
        "sof1": bytes(sof1),
        "zero-height": bytes(zero),
        "headers-only": base[: base.index(b"\xff\xda")] + b"\xff\xd9",
        "sos-before-sof": b"\xff\xd8\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00\xff\xd9",
    }


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", list(_error_cases()))
def test_errors_equal_reference(monkeypatch, name, tier):
    data = _error_cases()[name]
    got = _check_decode(monkeypatch, data, False, tier)
    assert isinstance(got, tuple), "the case must fail"


@pytest.mark.parametrize("tier", TIERS)
def test_missing_restart_segment_is_named(monkeypatch, tier):
    data = _error_cases()["missing-restart-segment"]
    assert _check_decode(monkeypatch, data, False, tier) == (
        "InvalidDecode", "invalid encoded data: missing restart segment")
    assert _check_decode(monkeypatch, _error_cases()["fractional-4:3"], False, tier) == (
        "UnsupportedDecode", "unsupported feature: fractional sampling ratios")


# ------------------------------------------------------------------ batches


def _mixed_batch():
    rng = np.random.default_rng(25)
    a = _photo(rng, 40, 56)
    return [
        _port_jpeg(a),
        _port_jpeg(_photo(rng, 37, 29, 1), Subsampling.S444),
        _port_jpeg(np.roll(a, 5, axis=1)),  # same geometry as the first
        _progressive_small(),
        _synth_jpeg(rng, 33, 17, ((1, 2), (1, 1), (1, 1)), restart=3),
        _port_jpeg(_photo(rng, 19, 70), Subsampling.S422, restart=2),
        _pillow_jpeg(_photo(rng, 45, 61, 1), progressive=True),
        _port_jpeg(np.roll(a, 9, axis=0)),
    ]


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
def test_batch_equals_per_image_decode(monkeypatch, fancy, workers, tier):
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    files = _mixed_batch()
    got = decode_jpeg_batch(files, fancy_upsampling=fancy, workers=workers, device="cpu")
    assert len(got) == len(files)
    for img, data in zip(got, files):
        one = decode_jpeg(data, fancy, device="cpu")
        assert (img.width, img.height, img.color_type) == (one.width, one.height, one.color_type)
        np.testing.assert_array_equal(img.pixels, one.pixels)
    if not fancy:
        alias = pipeline.decode_jpeg_batch(files, host_workers=workers, device="cpu")
        assert all(np.array_equal(a.pixels, g.pixels) for a, g in zip(alias, got))


@pytest.mark.parametrize("tier", TIERS)
def test_batch_raises_the_first_failing_file(monkeypatch, tier):
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    files = _mixed_batch()
    cases = _error_cases()
    # an entropy error (second host stage) before a header error (first stage)
    batch = files[:2] + [cases["missing-restart-segment"]] + files[2:4] + [cases["12-bit"]]
    with pytest.raises(errors.InvalidDecode, match="missing restart segment"):
        decode_jpeg_batch(batch, device="cpu")
    with pytest.raises(errors.UnsupportedDecode, match="non-8-bit precision"):
        decode_jpeg_batch(files[:3] + [cases["12-bit"], cases["garbage"]], device="cpu")
    assert decode_jpeg_batch([], device="cpu") == []


def test_batch_runs_one_tail(monkeypatch):
    """The device tier's batch: one tail launch for every file."""
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", "device")
    calls = []
    real = jpeg_decoder.idct_planes_table  # the launch with the batch's packed table

    def counting(*a):
        calls.append(a[0].shape[0])
        return real(*a)

    monkeypatch.setattr(jpeg_decoder, "idct_planes_table", counting)
    decode_jpeg_batch(_mixed_batch(), device="cpu")
    assert len(calls) == 1


# ------------------------------------------------------------------ the host library


FUSED_CASES = [
    ("gray", Subsampling.S444, True),
    ("444", Subsampling.S444, False),
    ("420", Subsampling.S420, False),
    ("422", Subsampling.S422, False),
]


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
@pytest.mark.parametrize("restart", [None, 1, 5], ids=["no-rst", "rst1", "rst5"])
@pytest.mark.parametrize("size", [(33, 47), (8, 8), (97, 15)], ids=["33x47", "8x8", "97x15"])
@pytest.mark.parametrize("label,sub,gray", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_native_fused_decode_equals_two_stage(monkeypatch, label, sub, gray, size, restart, fancy):
    """The test that core.cpp's jpeg_decode_baseline comment promises: the
    fused host decode equals the two-stage jpeg_decode_scan +
    jpeg_decode_pixels, through the port's bindings; and both equal the
    port's decode under each of its pixel tiers."""
    h, w = size
    data = _port_jpeg(_photo(np.random.default_rng(26), h, w, 1 if gray else 3), sub,
                      quality=90, restart=restart)
    fused = host_decode(data, fancy, fused=True)
    two_stage = host_decode(data, fancy)
    assert fused is not None and two_stage is not None
    np.testing.assert_array_equal(fused, two_stage)
    for tier in TIERS:
        monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
        np.testing.assert_array_equal(decode_jpeg(data, fancy, device="cpu").pixels, two_stage)
