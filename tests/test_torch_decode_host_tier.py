"""The JPEG decode's two pixel tiers against the JAX package's, on the CPU.

``PIXO_TPU_DECODE_PIXELS`` picks the tier in both packages: ``host`` (the
host library's fused baseline decode, or its pixel tail after the entropy
stage: the default of both on the CPU) and ``device`` (the reference's jnp
tail, the port's plain PyTorch tail on the CPU). Each port tier is held to
the JAX decoder under the same tier, pixel for pixel (tolerance 0: integer
arithmetic throughout) and error for error, on baseline files with and
without restarts, progressive, gray, 4:2:0, 4:2:2, fancy upsampling, the
geometries the library declines, corrupt and truncated streams, and a
batch in file order. Inputs come from numpy seeds and the port's encoder.

``test_dc_only_shortcut_*`` frames luma blocks whose only coefficient is a
DC that, times its table entry, passes 2^16 (where the jidctint algebra's
int32 products wrap), coded with a plain EOB or with a ZRL then an EOB. The
fused sink of ``core.cpp`` (``:6728``) takes its DC-only shortcut by the
entropy index (a plain EOB only), the library's two-stage tail by the
block's last nonzero coefficient (both codings).
"""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from pixo_tpu import errors as jerrors
from pixo_tpu.decode import decode_jpeg as ref_decode_jpeg

from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded, errors
from pixo_tpu_torch.color import ColorType
from pixo_tpu_torch.decode import decode_jpeg, decode_jpeg_batch, jpeg_decoder
from pixo_tpu_torch.jpeg import markers
from pixo_tpu_torch.jpeg.tables import HuffmanTables, QuantizationTables
from pixo_tpu_torch.native import native_pack_scan

TIERS = ["host", "device"]


def _photo(rng, h, w, c=3):
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 6.0) * 60 + np.cos(y / 4.0) * 50 + 128)[..., None]
    img = (base + rng.normal(0, 14, (h, w, c)) + np.arange(c) * 25).clip(0, 255).astype(np.uint8)
    return img[..., 0] if c == 1 else img


def _port_jpeg(img, sub=Subsampling.S420, restart=None, quality=85):
    h, w = img.shape[:2]
    opts = JpegOptions(width=w, height=h, quality=quality, subsampling=sub,
                       color_type=ColorType.GRAY if img.ndim == 2 else ColorType.RGB,
                       restart_interval=restart)
    return encode_jpeg_batch_sharded(img[None], opts, device="cpu")[0]


def _pillow(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _synth(rng, width, height, sampling, restart=None):
    """Random coefficients under any sampling factors, through the host
    packer, framed with the standard tables."""
    max_h = max(h for h, _ in sampling)
    max_v = max(v for _, v in sampling)
    mcus = -(-width // (8 * max_h)) * -(-height // (8 * max_v))
    pattern = [ci for ci, (h, v) in enumerate(sampling) for _ in range(h * v)]
    zz = np.zeros((mcus * len(pattern), 64), np.int16)
    zz[:, 0] = rng.integers(-60, 60, len(zz))
    zz[:, 1:12] = np.where(rng.random((len(zz), 11)) < 0.4, rng.integers(-30, 31, (len(zz), 11)), 0)
    return _frame(native_pack_scan(zz, pattern, HuffmanTables.default(), restart), sampling, width,
                  height, restart=restart)


def _frame(scan, sampling, width, height, restart=None, dqt=None):
    """A baseline file around the entropy-coded ``scan``: ``dqt`` (8-bit q85
    tables by default), SOF0 with ``sampling``, the standard Huffman tables."""
    ncomp = len(sampling)
    out = bytearray()
    markers.write_soi(out)
    if dqt is None:
        markers.write_dqt(out, QuantizationTables(85))
    else:
        out += dqt
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


def _outcome(fn):
    try:
        return fn()
    except (errors.PixoError, jerrors.PixoError) as e:
        return type(e).__name__, str(e)


def _reference(monkeypatch, data, fancy, tier):
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    return _outcome(lambda: ref_decode_jpeg(data, fancy).pixels)


def _port(monkeypatch, data, fancy, tier):
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    return _outcome(lambda: decode_jpeg(data, fancy, device="cpu").pixels)


def _same(a, b) -> bool:
    if isinstance(a, tuple) or isinstance(b, tuple):
        return a == b
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _cases():
    rng = np.random.default_rng(51)
    a = _photo(rng, 37, 53)
    base = _port_jpeg(a)
    return {
        "baseline 420": base,
        "baseline 420 rst1": _port_jpeg(a, restart=1),
        "baseline 444 rst3": _port_jpeg(_photo(rng, 29, 31), Subsampling.S444, restart=3),
        "baseline 422": _port_jpeg(_photo(rng, 19, 45), Subsampling.S422),
        "gray": _port_jpeg(_photo(rng, 23, 17, 1), Subsampling.S444),
        "gray rst2": _port_jpeg(_photo(rng, 40, 24, 1), Subsampling.S444, restart=2),
        "progressive 420 rst": _pillow(_photo(rng, 33, 41), progressive=True, subsampling=2,
                                       restart_marker_rows=1, quality=85),
        "progressive 444": _pillow(_photo(rng, 26, 19), progressive=True, subsampling=0, quality=90),
        "progressive gray": _pillow(_photo(rng, 21, 30, 1), progressive=True, quality=80),
        "pillow optimized 422": _pillow(_photo(rng, 30, 50), optimize=True, subsampling=1, quality=70),
        "h1v2": _synth(rng, 27, 35, ((1, 2), (1, 1), (1, 1))),
        "h3v1 (declined)": _synth(rng, 41, 18, ((3, 1), (1, 1), (1, 1)), restart=2),
        "luma subsampled (declined)": _synth(rng, 22, 29, ((1, 1), (2, 2), (2, 2))),
        "h4v2": _synth(rng, 45, 26, ((4, 2), (1, 1), (1, 1))),
        "truncated baseline": base[: len(base) // 2],
        "corrupt baseline": base[: len(base) // 2] + b"\xff\x00" * 8 + base[len(base) // 2 + 16:],
        "missing restart segment": (lambda d: d[: d.index(b"\xff\xd0")] + b"\xff\xd9")(
            _port_jpeg(_photo(rng, 48, 48), Subsampling.S444, restart=1)),
        "truncated progressive": (lambda d: d[: len(d) // 2])(
            _pillow(_photo(rng, 30, 30), progressive=True, quality=85)),
        "not a jpeg": b"\x89PNG\r\n\x1a\n",
    }


CASES = _cases()


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", list(CASES))
def test_tier_equals_reference_tier(monkeypatch, name, tier, fancy):
    data = CASES[name]
    got = _port(monkeypatch, data, fancy, tier)
    ref = _reference(monkeypatch, data, fancy, tier)
    assert _same(got, ref), (got if isinstance(got, tuple) else "pixels",
                             ref if isinstance(ref, tuple) else "pixels")
    if any(w in name for w in ("truncated", "corrupt", "missing", "not a")):
        assert isinstance(got, tuple), "the case must fail"


def _counting(monkeypatch, name):
    calls = []
    real = getattr(jpeg_decoder, name)

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(jpeg_decoder, name, counted)
    return calls


def test_default_cpu_decode_reaches_the_fused_call(monkeypatch):
    """``device="cpu"`` with the variable unset takes the host tier: a
    baseline file goes through the fused library call and no tail of the
    device tier runs; a progressive file through the library's pixel tail."""
    monkeypatch.delenv("PIXO_TPU_DECODE_PIXELS", raising=False)
    fused = _counting(monkeypatch, "native_jpeg_decode_baseline_call")
    pixels = _counting(monkeypatch, "native_jpeg_decode_pixels_call")
    tails = _counting(monkeypatch, "idct_planes_table")
    decode_jpeg(CASES["baseline 420"], device="cpu")
    assert (len(fused), len(pixels), len(tails)) == (1, 0, 0)
    decode_jpeg(CASES["progressive 444"], device="cpu")
    assert (len(fused), len(pixels), len(tails)) == (1, 1, 0)
    files = [CASES[k] for k in ("baseline 420", "gray", "progressive gray", "baseline 422")]
    decode_jpeg_batch(files, workers=4, device="cpu")
    assert (len(fused), len(pixels), len(tails)) == (4, 2, 0)
    assert jpeg_decoder._pixel_tier(__import__("torch").device("cpu")) == "host"
    assert jpeg_decoder._pixel_tier(__import__("torch").device("cuda")) == "device"


def test_device_variable_takes_the_batch_tail(monkeypatch):
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", "device")
    fused = _counting(monkeypatch, "native_jpeg_decode_baseline_call")
    tails = _counting(monkeypatch, "idct_planes_table")
    decode_jpeg_batch([CASES["baseline 420"], CASES["progressive 444"]], device="cpu")
    assert (len(fused), len(tails)) == (0, 1)


def test_declined_geometry_takes_the_plain_tail(monkeypatch):
    """Where the library declines the geometry, the host tier's file takes
    the plain PyTorch tail on the CPU; its pixels equal the reference's
    host tier (its NumPy or jnp fallback)."""
    plain = _counting(monkeypatch, "_plain_tail")
    for fancy in (False, True):
        got = _port(monkeypatch, CASES["h3v1 (declined)"], fancy, "host")
        assert _same(got, _reference(monkeypatch, CASES["h3v1 (declined)"], fancy, "host"))
    assert len(plain) == 2
    _port(monkeypatch, CASES["baseline 420"], False, "host")
    assert len(plain) == 2


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("tier", TIERS)
def test_batch_in_file_order(monkeypatch, tier, workers):
    """A mixed batch: each image equals the reference's decode of its file
    under the same tier; a batch with failing files raises the first
    failing file's error, with its index."""
    names = ["baseline 420", "gray", "progressive 420 rst", "h3v1 (declined)", "baseline 422",
             "progressive gray", "h1v2", "baseline 420 rst1"]
    files = [CASES[n] for n in names]
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    got = decode_jpeg_batch(files, workers=workers, device="cpu")
    for name, img in zip(names, got):
        want = _reference(monkeypatch, CASES[name], False, tier)
        assert np.array_equal(img.pixels, want), name
        assert (img.height, img.width) == want.shape[:2]
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", tier)
    bad = files[:3] + [CASES["truncated baseline"]] + files[3:5] + [CASES["not a jpeg"]]
    with pytest.raises(errors.InvalidDecode) as info:
        decode_jpeg_batch(bad, workers=workers, device="cpu")
    want = _reference(monkeypatch, CASES["truncated baseline"], False, tier)
    assert (type(info.value).__name__, str(info.value)) == want
    assert info.value.file_index == 3


# ---------------------------------------------------------------- the DC-only shortcut

class _BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> None:
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def bytes(self) -> bytes:
        bits = self.bits + [1] * (-len(self.bits) % 8)
        raw = bytes(int("".join(map(str, bits[i: i + 8])), 2) for i in range(0, len(bits), 8))
        return raw.replace(b"\xff", b"\xff\x00")


def _dqt16(dc_q: int) -> bytes:
    """Two 16-bit DQT tables: ``dc_q`` at the DC, 1 elsewhere."""
    out = bytearray()
    for tq in (0, 1):
        table = np.ones(64, ">u2")
        table[0] = dc_q
        out += struct.pack(">HHB", markers.DQT, 2 + 1 + 128, 0x10 | tq) + table.tobytes()
    return bytes(out)


DC_ONLY_TAILS = {"eob": [0x00], "zrl eob": [0xF0, 0x00], "zrl zrl eob": [0xF0, 0xF0, 0x00]}


def _dc_only_file(dc_q: int, dcs, tail: str) -> bytes:
    """A 16x16 h1v2 file whose luma blocks hold only the DC values ``dcs``
    (four of them, two MCUs) and then the AC symbols of ``tail``; chroma
    blocks are flat."""
    tables = HuffmanTables.default()
    w = _BitWriter()
    prev = [0, 0, 0]
    blocks = [(0, dcs[0]), (0, dcs[1]), (1, 0), (2, 0), (0, dcs[2]), (0, dcs[3]), (1, 0), (2, 0)]
    for comp, dc in blocks:
        dc_codes, dc_lens, ac_codes, ac_lens = (
            (tables.dc_lum_codes, tables.dc_lum_lengths, tables.ac_lum_codes, tables.ac_lum_lengths)
            if comp == 0 else
            (tables.dc_chrom_codes, tables.dc_chrom_lengths, tables.ac_chrom_codes, tables.ac_chrom_lengths))
        diff, prev[comp] = dc - prev[comp], dc
        size = abs(diff).bit_length()
        assert size <= 11
        w.put(int(dc_codes[size]), int(dc_lens[size]))
        if size:
            w.put(diff if diff >= 0 else diff + (1 << size) - 1, size)
        for sym in (DC_ONLY_TAILS[tail] if comp == 0 else [0x00]):
            w.put(int(ac_codes[sym]), int(ac_lens[sym]))
    return _frame(w.bytes(), ((1, 2), (1, 1), (1, 1)), 16, 16, dqt=_dqt16(dc_q))


DC_ONLY_CASES = {
    "q65535 dc 3 4 5 -5": (65535, (3, 4, 5, -5)),  # |DC q| 196605, 262140, 327675: around 2^18
    "q65535 dc 64 -64 1024 -1000": (65535, (64, -64, 1024, -1000)),
    "q4096 dc 63 64 65 -64": (4096, (63, 64, 65, -64)),
    "q255 dc 1000 1100 -900 1100": (255, (1000, 1100, -900, 1100)),
    "q85 dc 30 -30 100 -100": (85, (30, -30, 100, -100)),  # below 2^16
}


@pytest.mark.parametrize("tail", list(DC_ONLY_TAILS))
@pytest.mark.parametrize("name", list(DC_ONLY_CASES))
def test_dc_only_shortcut_each_tier_equals_reference(monkeypatch, name, tail):
    dc_q, dcs = DC_ONLY_CASES[name]
    data = _dc_only_file(dc_q, dcs, tail)
    for tier in TIERS:
        got = _port(monkeypatch, data, False, tier)
        ref = _reference(monkeypatch, data, False, tier)
        assert not isinstance(ref, tuple), ref
        assert _same(got, ref), tier


def test_dc_only_shortcut_where_the_tiers_differ(monkeypatch):
    """What the reference's tiers give on these blocks, pinned: past 2^16
    the host tier (the fused call, the CPU's default) and the device tier
    (the jnp tail, a TPU's default) agree on a ZRL-then-EOB block, where
    the fused sink's general IDCT wraps as the jnp tail does, and differ on
    the same DC with a plain EOB, which the DC-only shortcut saturates;
    the library's two-stage tail saturates both codings, so it differs from
    its fused call on the ZRL-then-EOB block. Below 2^16 all agree."""
    from chip_smoke import host_decode

    for name, (dc_q, dcs) in DC_ONLY_CASES.items():
        wraps = dc_q * max(abs(d) for d in dcs) >= 1 << 16
        for tail in DC_ONLY_TAILS:
            data = _dc_only_file(dc_q, dcs, tail)
            host = _reference(monkeypatch, data, False, "host")
            device = _reference(monkeypatch, data, False, "device")
            fused, two_stage = host_decode(data, fused=True), host_decode(data)
            assert np.array_equal(host, fused), (name, tail)
            assert np.array_equal(host, device) == (not wraps or tail != "eob"), (name, tail)
            assert np.array_equal(fused, two_stage) == (not wraps or tail == "eob"), (name, tail)
