"""JPEG decoder, baseline and progressive, with its pixel tail on a device.

Counterpart of the JAX package's ``decode/jpeg_decoder.py``: the same marker
parse (APP skip, DQT 8/16-bit, SOF0/SOF2, DHT, DRI, SOS), the same errors,
and for every file the same pixels as its device tier. A file goes through
two host stages and one device stage:

1. ``_parse``: the markers up to the first scan, and the checks the
   reference makes before it decodes entropy data; the file's geometry.
2. the entropy-coded scans (baseline, or every scan of a progressive file)
   into int16 zigzag coefficient planes that the caller allocates, through
   the native decoders (``native/core.cpp``), with the Python bit reader as
   the baseline fallback that names a corrupt stream's error. In a batch
   (``_host_stage``) the baseline scans' library calls run on threads.
3. the pixel tail, for a whole batch at once, on ``device``: one
   ``ops/kernels.py::idct_planes`` launch (dequantize, un-zigzag, jidctint
   IDCT and plane assembly, for every plane of every image), then the chroma
   upsampling and the inverse BT.601 (``_upsample_colour``, with
   ``ops/jpeg_decode.py``), grouped by image geometry, then one copy of all
   pixels to the host.

``decode_files`` runs the stages for a batch; ``decode_jpeg`` is a batch of
one, and ``_decode_entropy`` the entropy stage of one file.
A caller whose next stage runs on the same device (the thumbnail pipeline)
takes the stages apart: ``_host_stage``, then ``_device_tail``, which leaves
the pixels on the device, laid out as ``_pixel_groups`` says.

``decode_files`` picks the pixel tier as the reference does
(``_pixel_tier``), keyed on the call's device where the reference reads
JAX's backend: ``PIXO_TPU_DECODE_PIXELS=host`` or ``=device`` where set,
else the host tier for ``device="cpu"`` and the device tier for a card. The
device tier is the batch's tail above: the kernel on a card, plain PyTorch
for "cpu". The host tier, the reference's CPU latency tier
(``_host_tier``), decodes each file on its own, its Python work on the
calling thread and its library calls, which release the GIL, on the
``workers`` threads: a baseline file through the
host library's fused decode (entropy, IDCT, upsampling and colour in one
call), a progressive one through its scans, then the library's pixel tail;
where a fused call fails (a corrupt stream, a geometry it declines) the
file takes the two-stage route, so the reference's error surfaces, and
where the library declines the geometry the plain PyTorch tail on the CPU
gives the pixels of the reference's NumPy and jnp fallbacks.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import errors
from ..color import ColorType
from ..native import (
    NativeDecodeError,
    native_jpeg_decode_baseline_call,
    native_jpeg_decode_pixels_call,
    native_jpeg_decode_scan_call,
    native_jpeg_prog_ac_scan,
    native_jpeg_prog_dc_scan,
)
from ..ops.jpeg_decode import upsample_nearest, upsample_triangle, ycbcr_to_rgb_int
from ..ops.kernels import PlaneTable, idct_planes_table

SOF_UNSUPPORTED = {0xC1, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB,
                   0xCD, 0xCE, 0xCF}


@dataclasses.dataclass
class JpegImage:
    width: int
    height: int
    color_type: ColorType
    pixels: np.ndarray  # [H, W, 3] RGB or [H, W] gray

    @property
    def data(self) -> bytes:
        return self.pixels.tobytes()


@dataclasses.dataclass
class _Component:
    comp_id: int
    h: int
    v: int
    quant_id: int
    dc_table: int = 0
    ac_table: int = 0


class _HuffTable:
    """Canonical decode table: per-length (min_code, max_code, value offset)."""

    __slots__ = ("min_code", "max_code", "val_idx", "vals", "lut", "spec")

    LUT_BITS = 8

    def __init__(self, bits: bytes, vals: bytes):
        if len(bits) != 16:
            raise errors.InvalidDecode("truncated DHT segment")
        if len(vals) < sum(bits):
            raise errors.InvalidDecode("truncated DHT value list")
        self.vals = vals
        self.spec = (bytes(bits), bytes(vals))  # for the native decoders
        self.min_code = [0] * 17
        self.max_code = [-1] * 17
        self.val_idx = [0] * 17
        code = 0
        k = 0
        for ln in range(1, 17):
            count = bits[ln - 1]
            if count:
                self.val_idx[ln] = k
                self.min_code[ln] = code
                self.max_code[ln] = code + count - 1
                k += count
                code += count
            if code > (1 << ln):
                # over-subscribed canonical code space (Kraft sum > 1)
                raise errors.InvalidDecode("invalid DHT code counts")
            code <<= 1
        self.lut = None  # built on the first Python-tier decode only

    def _build_lut(self):
        bits, vals = self.spec
        # fast 8-bit lookahead: (symbol, length) or (-1, 0)
        self.lut = [(-1, 0)] * (1 << self.LUT_BITS)
        code = 0
        k = 0
        for ln in range(1, self.LUT_BITS + 1):
            for _ in range(bits[ln - 1]):
                prefix = code << (self.LUT_BITS - ln)
                for fill in range(1 << (self.LUT_BITS - ln)):
                    self.lut[prefix | fill] = (vals[k], ln)
                code += 1
                k += 1
            code <<= 1

    def decode(self, reader: "_MsbReader") -> int:
        if self.lut is None:
            self._build_lut()
        peek = reader.peek(self.LUT_BITS)
        sym, ln = self.lut[peek]
        if ln and reader.has_bits(ln):
            reader.consume(ln)
            return sym
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | reader.read_bit()
            if self.max_code[ln] >= 0 and code <= self.max_code[ln] and code >= self.min_code[ln]:
                return self.vals[self.val_idx[ln] + code - self.min_code[ln]]
        raise errors.InvalidDecode("invalid Huffman code")


class _MsbReader:
    """MSB-first bit reader over unstuffed entropy bytes."""

    __slots__ = ("data", "pos", "acc", "nbits")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self) -> None:
        while self.nbits <= 48 and self.pos < len(self.data):
            self.acc = (self.acc << 8) | self.data[self.pos]
            self.pos += 1
            self.nbits += 8

    def has_bits(self, n: int) -> bool:
        if self.nbits < n:
            self._fill()
        return self.nbits >= n

    def peek(self, n: int) -> int:
        if self.nbits < n:
            self._fill()
        if self.nbits >= n:
            return (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        # zero-pad past the end
        avail = self.nbits
        return (self.acc << (n - avail)) & ((1 << n) - 1) if avail else 0

    def consume(self, n: int) -> None:
        self.nbits -= n
        self.acc &= (1 << self.nbits) - 1 if self.nbits else 0

    def read_bit(self) -> int:
        if not self.has_bits(1):
            raise errors.InvalidDecode("out of entropy data")
        self.nbits -= 1
        bit = (self.acc >> self.nbits) & 1
        self.acc &= (1 << self.nbits) - 1 if self.nbits else 0
        return bit

    def read_bits(self, n: int) -> int:
        if n == 0:
            return 0
        if not self.has_bits(n):
            raise errors.InvalidDecode("out of entropy data")
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1 if self.nbits else 0
        return v


def _extend(bits: int, size: int) -> int:
    """JPEG EXTEND: map `size`-bit magnitude bits to signed value."""
    if size == 0:
        return 0
    if bits < (1 << (size - 1)):
        return bits - (2 << (size - 1)) + 1
    return bits


@dataclasses.dataclass
class _Scan:
    """One file after its marker parse, up to its first scan."""

    data: bytes
    pos: int  # just past the first SOS segment
    sos_seg: bytes
    width: int
    height: int
    components: List[_Component]
    qtables: Dict[int, np.ndarray]
    dc_tables: Dict[int, _HuffTable]
    ac_tables: Dict[int, _HuffTable]
    dc_specs: Dict[int, tuple]
    ac_specs: Dict[int, tuple]
    restart_interval: int
    progressive: bool

    @property
    def max_h(self) -> int:
        return max(c.h for c in self.components)

    @property
    def max_v(self) -> int:
        return max(c.v for c in self.components)

    @property
    def mcu_cols(self) -> int:
        return (self.width + 8 * self.max_h - 1) // (8 * self.max_h)

    @property
    def mcu_rows(self) -> int:
        return (self.height + 8 * self.max_v - 1) // (8 * self.max_v)

    def plane_blocks(self) -> List[Tuple[int, int]]:
        """(blocks per row, block rows) of each component's MCU-padded grid."""
        return [(self.mcu_cols * c.h, self.mcu_rows * c.v) for c in self.components]

    def geometry(self) -> tuple:
        """What decides the shapes of the file's planes and pixels."""
        return self.width, self.height, tuple((c.h, c.v) for c in self.components)


def _parse_dqt(seg: bytes, qtables: Dict[int, np.ndarray]) -> None:
    i = 0
    while i < len(seg):
        pq = seg[i] >> 4
        tq = seg[i] & 0x0F
        i += 1
        nbytes = 128 if pq else 64
        if i + nbytes > len(seg):
            raise errors.InvalidDecode("truncated DQT segment")
        if pq == 0:
            qtables[tq] = np.frombuffer(seg[i : i + 64], np.uint8).astype(np.uint16)
        else:
            qtables[tq] = np.frombuffer(seg[i : i + 128], ">u2").astype(np.uint16)
        i += nbytes


def _parse(data: bytes) -> _Scan:
    """Host stage 1: the markers up to the first SOS, and every check the
    reference makes before it reads entropy data, in its order."""
    if len(data) < 4 or data[0] != 0xFF or data[1] != 0xD8:
        raise errors.InvalidDecode("not a JPEG file (missing SOI)")
    pos = 2
    qtables: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, _HuffTable] = {}
    ac_tables: Dict[int, _HuffTable] = {}
    dc_specs: Dict[int, tuple] = {}
    ac_specs: Dict[int, tuple] = {}
    components: List[_Component] = []
    width = height = 0
    restart_interval = 0
    sof_seen = False
    progressive = False

    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            raise errors.InvalidDecode("expected marker")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            raise errors.InvalidDecode("no scan data before EOI")
        if marker == 0x01 or 0xD0 <= marker <= 0xD7:
            continue
        if pos + 2 > len(data):
            raise errors.InvalidDecode("truncated marker segment")
        seg_len = (data[pos] << 8) | data[pos + 1]
        if seg_len < 2 or pos + seg_len > len(data):
            raise errors.InvalidDecode("invalid segment length")
        seg = data[pos + 2 : pos + seg_len]
        pos += seg_len

        if marker == 0xDB:  # DQT
            _parse_dqt(seg, qtables)
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc = seg[i] >> 4
                th = seg[i] & 0x0F
                bits = seg[i + 1 : i + 17]
                total = sum(bits)
                if len(bits) < 16 or i + 17 + total > len(seg):
                    raise errors.InvalidDecode("truncated DHT segment")
                vals = seg[i + 17 : i + 17 + total]
                table = _HuffTable(bits, vals)
                if tc == 0:
                    dc_tables[th] = table
                    dc_specs[th] = (bits, vals)
                else:
                    ac_tables[th] = table
                    ac_specs[th] = (bits, vals)
                i += 17 + total
        elif marker in (0xC0, 0xC2):  # SOF0 baseline / SOF2 progressive
            sof_seen = True
            progressive = marker == 0xC2
            if len(seg) < 6:
                raise errors.InvalidDecode("truncated SOF segment")
            height = (seg[1] << 8) | seg[2]
            width = (seg[3] << 8) | seg[4]
            ncomp = seg[5]
            if seg[0] != 8:
                raise errors.UnsupportedDecode("non-8-bit precision")
            if ncomp not in (1, 3):
                raise errors.UnsupportedDecode(f"{ncomp} components")
            if len(seg) < 6 + 3 * ncomp:
                raise errors.InvalidDecode("truncated SOF segment")
            components = []
            for c in range(ncomp):
                off = 6 + c * 3
                comp = _Component(seg[off], seg[off + 1] >> 4, seg[off + 1] & 0x0F,
                                  seg[off + 2])
                if not (1 <= comp.h <= 4 and 1 <= comp.v <= 4):
                    raise errors.InvalidDecode("invalid sampling factors")
                components.append(comp)
            # fractional-ratio sampling (e.g. 3:2) has no integer upsample;
            # reject like libjpeg's "fractional sampling not implemented"
            sof_max_h = max(c.h for c in components)
            sof_max_v = max(c.v for c in components)
            for comp in components:
                if sof_max_h % comp.h or sof_max_v % comp.v:
                    raise errors.UnsupportedDecode("fractional sampling ratios")
        elif marker in SOF_UNSUPPORTED:
            raise errors.UnsupportedDecode(f"SOF marker 0xFF{marker:02X} (non-baseline)")
        elif marker == 0xDD:  # DRI
            if len(seg) < 2:
                raise errors.InvalidDecode("truncated DRI segment")
            restart_interval = (seg[0] << 8) | seg[1]
        elif marker == 0xDA:  # SOS
            if not sof_seen:
                raise errors.InvalidDecode("SOS before SOF")
            if not seg:
                raise errors.InvalidDecode("truncated SOS segment")
            if not progressive:
                ns = seg[0]
                if not 1 <= ns <= 4 or len(seg) < 1 + 2 * ns + 3:
                    raise errors.InvalidDecode("truncated SOS segment")
                for c in range(ns):
                    cid = seg[1 + c * 2]
                    tsel = seg[2 + c * 2]
                    for comp in components:
                        if comp.comp_id == cid:
                            comp.dc_table = tsel >> 4
                            comp.ac_table = tsel & 0x0F
            if width == 0 or height == 0:
                raise errors.InvalidDecode("zero dimensions")
            max_h = max(c.h for c in components)
            max_v = max(c.v for c in components)
            if max_h == 0 or max_v == 0 or max_h > 4 or max_v > 4:
                raise errors.InvalidDecode("invalid sampling factors")
            for comp in components:
                if comp.quant_id not in qtables:
                    raise errors.InvalidDecode("missing quantization table")
                if not progressive and (comp.dc_table not in dc_tables
                                        or comp.ac_table not in ac_tables):
                    raise errors.InvalidDecode("missing Huffman table")
            return _Scan(data, pos, seg, width, height, components, qtables, dc_tables,
                         ac_tables, dc_specs, ac_specs, restart_interval, progressive)
    raise errors.InvalidDecode("no SOS marker found")


def _split_entropy(scan_data: bytes) -> Tuple[List[bytes], int]:
    """Split entropy-coded bytes at RST markers; unstuff 0xFF00.

    Returns (segments, consumed_length_up_to_EOI_or_end). Vectorized over
    the 0xFF positions: the Python loop touches only marker and stuffing
    sites, and everything between them is a slice copy.
    """
    arr = np.frombuffer(scan_data, np.uint8)
    n = len(scan_data)
    ff = np.nonzero(arr == 0xFF)[0]
    if len(ff) == 0:
        return [scan_data], n

    # Fast path (no restart markers): classify every 0xFF site at once,
    # truncate at the first real marker, and drop the stuffing zeros with
    # one vectorized delete.
    valid = ff + 1 < n
    nxt = np.full(len(ff), 0xFF, np.uint8)  # trailing 0xFF ends the scan
    nxt[valid] = arr[np.minimum(ff + 1, n - 1)][valid]
    is_stuff = (nxt == 0x00) & valid
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7) & valid
    is_end = ~(is_stuff | is_rst)
    if is_end.any():
        end_i = int(np.argmax(is_end))
        limit = int(ff[end_i])
        consumed_fast = limit
    else:
        end_i = len(ff)
        limit = n
        consumed_fast = n
    if not is_rst[:end_i].any():
        stuff_pos = ff[:end_i][is_stuff[:end_i]]
        seg = np.delete(arr[:limit], stuff_pos + 1).tobytes()
        return [seg], consumed_fast

    segments: List[bytes] = []
    parts: List[bytes] = []
    start = 0
    consumed = n
    for pos in ff:
        pos = int(pos)
        if pos < start:
            continue  # second byte of an already-consumed pair
        if pos + 1 >= n:
            parts.append(scan_data[start:pos])
            consumed = pos
            start = pos
            break
        nxt = arr[pos + 1]
        if nxt == 0x00:
            parts.append(scan_data[start:pos + 1])  # keep the 0xFF
            start = pos + 2
        elif 0xD0 <= nxt <= 0xD7:
            parts.append(scan_data[start:pos])
            segments.append(b"".join(parts))
            parts = []
            start = pos + 2
        else:  # real marker (EOI or otherwise): end of scan
            parts.append(scan_data[start:pos])
            consumed = pos
            start = pos
            break
    else:
        parts.append(scan_data[start:n])
        start = n
    segments.append(b"".join(parts))
    return segments, consumed if start != n else n


def _decode_entropy(scan: _Scan, coeffs: List[np.ndarray]) -> List[np.ndarray]:
    """Host stage 2 of one file: decode its scans into ``coeffs``, one zeroed
    writable int16 [blocks, 64] zigzag array per component over its
    MCU-padded grid (``_Scan.plane_blocks``). Returns each component's
    zigzag dequantization table (uint16 [64]) as the tail must use it."""
    if scan.progressive:
        _decode_progressive(scan, coeffs)
    else:
        segments, call = _baseline_call(scan, coeffs)
        _finish_baseline(scan, segments, coeffs, call())
    return _qtables(scan)


def _qtables(scan: _Scan) -> List[np.ndarray]:
    return [scan.qtables[c.quant_id] for c in scan.components]


def _baseline_call(scan: _Scan, coeffs: List[np.ndarray]) -> Tuple[List[bytes], Callable[[], bool]]:
    """The baseline scan's restart segments, and its native decode into
    ``coeffs`` made ready to run (on any thread: the library call releases
    the GIL). The segment loop, and the DC predictor reset per restart
    segment, run inside the library."""
    components = scan.components
    segments, _ = _split_entropy(scan.data[scan.pos:])
    call = native_jpeg_decode_scan_call(
        segments, scan.restart_interval, scan.mcu_cols * scan.mcu_rows, scan.mcu_cols,
        [c.h for c in components], [c.v for c in components],
        [scan.dc_specs[c.dc_table] for c in components],
        [scan.ac_specs[c.ac_table] for c in components], coeffs,
    )
    return segments, call


def _finish_baseline(scan: _Scan, segments: List[bytes], coeffs: List[np.ndarray],
                     native_ok: bool) -> None:
    """After the native call: the restart segment count, or, where the call
    declined a corrupt stream, the Python bit reader, which raises the
    error by name."""
    components = scan.components
    mcu_cols, restart_interval = scan.mcu_cols, scan.restart_interval
    total_mcus = mcu_cols * scan.mcu_rows
    if native_ok:
        if restart_interval and len(segments) < -(-total_mcus // restart_interval):
            raise errors.InvalidDecode("missing restart segment")
        return

    seg_idx = 0
    reader = _MsbReader(segments[0]) if segments else _MsbReader(b"")
    prev_dc = [0] * len(components)

    for mcu in range(total_mcus):
        if restart_interval and mcu > 0 and mcu % restart_interval == 0:
            seg_idx += 1
            if seg_idx >= len(segments):
                raise errors.InvalidDecode("missing restart segment")
            reader = _MsbReader(segments[seg_idx])
            prev_dc = [0] * len(components)
        my, mx = divmod(mcu, mcu_cols)
        for ci, comp in enumerate(components):
            dc_t = scan.dc_tables[comp.dc_table]
            ac_t = scan.ac_tables[comp.ac_table]
            for by in range(comp.v):
                for bx in range(comp.h):
                    block = np.zeros(64, np.int16)
                    # DC
                    s = dc_t.decode(reader)
                    diff = _extend(reader.read_bits(s), s) if s else 0
                    # wrap like 16-bit coefficient storage would: a corrupt
                    # stream may accumulate past int16 without being invalid
                    # at any single step
                    prev_dc[ci] = ((prev_dc[ci] + diff + 0x8000) & 0xFFFF) - 0x8000
                    block[0] = prev_dc[ci]
                    # AC
                    k = 1
                    while k < 64:
                        rs = ac_t.decode(reader)
                        r, s = rs >> 4, rs & 0x0F
                        if s == 0:
                            if r == 15:
                                k += 16
                                continue
                            break  # EOB
                        k += r
                        if k > 63:
                            raise errors.InvalidDecode("AC index overflow")
                        block[k] = _extend(reader.read_bits(s), s)
                        k += 1
                    row = my * comp.v + by
                    col = mx * comp.h + bx
                    coeffs[ci][row * (mcu_cols * comp.h) + col] = block


# ===================== progressive (SOF2) scan decode ========================
# T.81 G.1.2: spectral selection and successive approximation (DC first and
# refine, AC first and refine with EOB runs), every scan through the native
# segment decoders; a malformed segment raises InvalidDecode.


def _seg_unit_ranges(nsegments, total_units, restart_interval):
    """Unit range [u0, u1) covered by each entropy segment of a scan."""
    if not restart_interval:
        return [(0, total_units)] + [(0, 0)] * (nsegments - 1)
    return [
        (si * restart_interval, min((si + 1) * restart_interval, total_units))
        for si in range(nsegments)
    ]


def _prog_scan(decode: Callable, segments, total_units, restart_interval, *args) -> None:
    """One progressive scan through ``decode`` (a native scan decoder, given
    the segments, their unit ranges and ``args``), with the reference's
    errors: malformed entropy data, or fewer restart segments than units."""
    try:
        decode(segments, _seg_unit_ranges(len(segments), total_units, restart_interval), *args)
    except NativeDecodeError:
        raise errors.InvalidDecode("invalid progressive entropy data")
    if restart_interval and len(segments) < -(-total_units // restart_interval):
        raise errors.InvalidDecode("missing restart segment")


def _decode_progressive(scan: _Scan, coeffs: List[np.ndarray]) -> None:
    """Drive all scans of a progressive stream into the zeroed ``coeffs``,
    with the markers between them, up to EOI."""
    data, pos, sos_seg = scan.data, scan.pos, scan.sos_seg
    width, height, components = scan.width, scan.height, scan.components
    qtables, dc_tables, ac_tables = scan.qtables, scan.dc_tables, scan.ac_tables
    restart_interval = scan.restart_interval
    max_h, max_v, mcu_cols = scan.max_h, scan.max_v, scan.mcu_cols

    comp_by_id = {c.comp_id: i for i, c in enumerate(components)}
    # ceil block dims of each component's *actual* sample area (non-
    # interleaved scans iterate this grid, not the MCU-padded one)
    blk_dims = []
    for c in components:
        cw = -(-width * c.h // max_h)
        ch = -(-height * c.v // max_v)
        blk_dims.append((-(-ch // 8), -(-cw // 8)))

    while True:
        # ---- decode the scan whose header is in sos_seg ----
        if not sos_seg:
            raise errors.InvalidDecode("truncated SOS segment")
        ns = sos_seg[0]
        if not 1 <= ns <= 4 or len(sos_seg) < 1 + 2 * ns + 3:
            raise errors.InvalidDecode("truncated SOS segment")
        scan_comps = []
        for c in range(ns):
            cid = sos_seg[1 + c * 2]
            tsel = sos_seg[2 + c * 2]
            if cid not in comp_by_id:
                raise errors.InvalidDecode("scan references unknown component")
            scan_comps.append((comp_by_id[cid], tsel >> 4, tsel & 0x0F))
        ss = sos_seg[1 + ns * 2]
        se = sos_seg[2 + ns * 2]
        ah_al = sos_seg[3 + ns * 2]
        ah, al = ah_al >> 4, ah_al & 0x0F
        if ss > se or se > 63 or (ss == 0) != (se == 0):
            raise errors.InvalidDecode("invalid spectral selection")
        if ss > 0 and ns != 1:
            raise errors.InvalidDecode("interleaved AC scan")

        segments, consumed = _split_entropy(data[pos:])
        pos += consumed

        if ss == 0:  # DC scan (possibly interleaved)
            dc_ts = []
            for ci, dc_sel, _ in scan_comps:
                if ah == 0 and dc_sel not in dc_tables:
                    raise errors.InvalidDecode("missing Huffman table")
                dc_ts.append(dc_tables.get(dc_sel))
            total_units = mcu_cols * scan.mcu_rows if ns > 1 else (
                blk_dims[scan_comps[0][0]][0] * blk_dims[scan_comps[0][0]][1]
            )
            scan_ci = [ci for ci, _, _ in scan_comps]
            _prog_scan(
                native_jpeg_prog_dc_scan, segments, total_units, restart_interval,
                mcu_cols, ns > 1, [components[ci].h for ci in scan_ci],
                [components[ci].v for ci in scan_ci], [blk_dims[ci][1] for ci in scan_ci],
                [t.spec for t in dc_ts] if ah == 0 else None, ah, al,
                [coeffs[ci] for ci in scan_ci],
            )
        else:  # AC scan: single component, raster over its ceil block grid
            ci, _, ac_sel = scan_comps[0]
            if ac_sel not in ac_tables:
                raise errors.InvalidDecode("missing Huffman table")
            bh, bw = blk_dims[ci]
            _prog_scan(native_jpeg_prog_ac_scan, segments, bh * bw, restart_interval,
                       mcu_cols * components[ci].h, bw, ss, se, ah, al,
                       ac_tables[ac_sel].spec, coeffs[ci])

        # ---- parse markers until the next SOS or EOI ----
        sos_seg = None
        while pos + 2 <= len(data):
            if data[pos] != 0xFF:
                raise errors.InvalidDecode("expected marker between scans")
            marker = data[pos + 1]
            pos += 2
            if marker == 0xD9:  # EOI
                return
            if marker == 0x01 or 0xD0 <= marker <= 0xD7:
                continue
            if pos + 2 > len(data):
                raise errors.InvalidDecode("truncated marker segment")
            seg_len = (data[pos] << 8) | data[pos + 1]
            if seg_len < 2 or pos + seg_len > len(data):
                raise errors.InvalidDecode("invalid segment length")
            seg = data[pos + 2 : pos + seg_len]
            pos += seg_len
            if marker == 0xC4:  # DHT between scans
                i = 0
                while i < len(seg):
                    tc = seg[i] >> 4
                    th = seg[i] & 0x0F
                    bits = seg[i + 1 : i + 17]
                    total = sum(bits)
                    vals = seg[i + 17 : i + 17 + total]
                    if tc == 0:
                        dc_tables[th] = _HuffTable(bits, vals)
                    else:
                        ac_tables[th] = _HuffTable(bits, vals)
                    i += 17 + total
            elif marker == 0xDB:  # DQT between scans
                _parse_dqt(seg, qtables)
            elif marker == 0xDD:  # DRI between scans
                if len(seg) < 2:
                    raise errors.InvalidDecode("truncated DRI segment")
                restart_interval = (seg[0] << 8) | seg[1]
            elif marker == 0xDA:
                sos_seg = seg
                break
            # APPn/COM and others: skipped
        if sos_seg is None:
            raise errors.InvalidDecode("progressive stream missing EOI")


# ============================ the batch's pixel tail ==========================


class _Layout:
    """Where each plane of a batch lives: the files grouped by geometry, and
    within a group component by component, image by image, so that one
    component of one group is a [B, H, W] block of the coefficient rows and
    of the kernel's output alike. The pixels are laid out group by group
    too, so each group's images are one [B, H, W(, 3)] block."""

    def __init__(self, scans: Sequence[_Scan]):
        groups: Dict[tuple, List[int]] = {}
        for i, s in enumerate(scans):
            groups.setdefault(s.geometry(), []).append(i)
        rows = []  # [first block, blocks per row, block rows, output offset, pitch]
        self.views: List[List[Tuple[int, int]]] = [[] for _ in scans]  # (first, count)
        self.qtable_of: List[Tuple[int, int]] = []  # (file, component) of each plane
        self.groups = []  # (members, first block of each component, first pixel byte)
        first = pixel = 0
        for members in groups.values():
            s = scans[members[0]]
            starts = []
            for ci, (bw, bh) in enumerate(s.plane_blocks()):
                starts.append(first)
                for i in members:
                    rows.append((first, bw, bh, 64 * first, 8 * bw))
                    self.views[i].append((first, bw * bh))
                    self.qtable_of.append((i, ci))
                    first += bw * bh
            self.groups.append((members, starts, pixel))
            pixel += len(members) * s.width * s.height * (3 if len(s.components) == 3 else 1)
        self.total_blocks, self.total_pixel_bytes = first, pixel
        # checked and packed for the kernel here, once a batch; the tables
        # follow when the entropy stage has read them
        self.table = PlaneTable(np.asarray(rows, np.int64).reshape(-1, 5), first) if rows else None

    @property
    def planes(self) -> np.ndarray:
        """[planes, 5] int64: first block, blocks per row, block rows, output
        offset and pitch of each plane."""
        return self.table.planes


class _HostBatch(NamedTuple):
    """A batch after its host stages: what the pixel tail reads."""

    scans: List[_Scan]
    layout: _Layout
    coeffs: np.ndarray  # [total blocks, 64] int16 zigzag, every plane of the batch
    qtables: np.ndarray  # [planes, 64] int32 zigzag, one per plane: layout.table's
    # For a batch bound for a card, pinned bytes: the coefficients (coeffs is
    # a view of them), then layout.table.packed. None for the CPU.
    staging: Optional[torch.Tensor]

    def to_device(self, device: torch.device):
        """(coefficients, packed plane table or None) on ``device``: for a
        card, one copy of the pinned staging bytes on the current stream,
        which the host does not wait for."""
        if self.staging is None:
            return torch.from_numpy(self.coeffs).to(device), None
        on = self.staging.to(device, non_blocking=True)
        return (on[: self.coeffs.nbytes].view(torch.int16).view(-1, 64),
                on[self.coeffs.nbytes:].view(torch.int64).view(-1, 38))


def _attempt(fn: Callable, *args):
    """fn(*args), or the exception it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - raised again by the caller, in file order
        return e


_pools: Dict[int, concurrent.futures.ThreadPoolExecutor] = {}
_pools_lock = threading.Lock()


def _pool(workers: int) -> concurrent.futures.ThreadPoolExecutor:
    """The process's pool of ``workers`` threads for the library calls,
    made at first use, so that a batch does not pay for starting them."""
    with _pools_lock:
        if workers not in _pools:
            _pools[workers] = concurrent.futures.ThreadPoolExecutor(
                workers, thread_name_prefix="pixo-jpeg-decode")
        return _pools[workers]


def _host_stage(files: Sequence[bytes], workers: int, pinned: bool = False) -> _HostBatch:
    """Both host stages of a non-empty batch: every file's markers, then
    every file's entropy decode straight into its views of one zeroed
    coefficient buffer; with ``pinned`` (a batch bound for a card) that
    buffer is pinned memory, with the packed plane table behind the
    coefficients, so that both go up in one copy the host need not wait for.
    The Python work runs on the calling thread. With
    ``workers`` > 1 the baseline scans' library calls, which release the
    GIL, go to that many threads once every call is ready, while the
    calling thread decodes the progressive files; with 1 they run inline.
    (Python work on the threads, or beside them while they start, made
    eight threads lose to one: PERF.md section 5.) Raises the error of the
    first file, in order, that fails, with that file's index as the
    exception's ``file_index``."""
    parsed = [_attempt(_parse, data) for data in files]
    scans = [p for p in parsed if isinstance(p, _Scan)]
    layout = _Layout(scans)
    table = layout.table  # None where no file parsed: the first error is raised below
    if pinned and table is not None:
        staging = torch.zeros(128 * layout.total_blocks + table.packed.nbytes, dtype=torch.uint8,
                              pin_memory=True)
        coeffs = staging.numpy()[: 128 * layout.total_blocks].view(np.int16).reshape(-1, 64)
    else:
        staging, coeffs = None, np.zeros((layout.total_blocks, 64), np.int16)
    planes = [[coeffs[f: f + n] for f, n in views] for views in layout.views]
    baseline = {k: _attempt(_baseline_call, s, planes[k])
                for k, s in enumerate(scans) if not s.progressive}
    outcome: List[Optional[Exception]] = [None] * len(scans)
    pool = _pool(workers) if workers > 1 else None
    running = {k: pool.submit(prep[1]) if pool else prep[1]()  # a future, or the call's result
               for k, prep in baseline.items() if not isinstance(prep, Exception)}
    for k, s in enumerate(scans):
        if s.progressive:
            outcome[k] = _attempt(_decode_progressive, s, planes[k])
    for k, prep in baseline.items():
        outcome[k] = prep if isinstance(prep, Exception) else _attempt(
            _finish_baseline, scans[k], prep[0], planes[k],
            running[k].result() if pool else running[k])
    decoded = iter(outcome)
    _raise_first([p if isinstance(p, Exception) else next(decoded) for p in parsed])
    table.set_qtables(np.stack([_qtables(scans[i])[ci] for i, ci in layout.qtable_of]))
    if staging is not None:
        staging.numpy()[coeffs.nbytes:] = table.packed.reshape(-1).view(np.uint8)
    return _HostBatch(scans, layout, coeffs, table.qtables, staging)


def _upsample_colour(planes: torch.Tensor, batch: _HostBatch, fancy_upsampling: bool) -> torch.Tensor:
    """Device stage after the kernel: each geometry group's planes (views of
    ``planes``, the output of ``idct_planes``) upsampled, cropped and
    colour-converted into one uint8 buffer of every image's pixels, group by
    group, on ``planes``' device."""
    ups = upsample_triangle if fancy_upsampling else upsample_nearest
    pixels = torch.empty(batch.layout.total_pixel_bytes, dtype=torch.uint8, device=planes.device)
    for members, starts, pixel in batch.layout.groups:
        s = batch.scans[members[0]]
        b = len(members)
        comps = []
        for comp, (bw, bh), first in zip(s.components, s.plane_blocks(), starts):
            plane = planes[64 * first: 64 * (first + b * bw * bh)].view(b, 8 * bh, 8 * bw)
            plane = ups(plane, s.max_h // comp.h, s.max_v // comp.v)
            comps.append(plane[:, :s.height, :s.width])
        if len(comps) == 1:
            img = comps[0]
        else:
            y, cb, cr = (c.to(torch.int32) for c in comps)
            img = ycbcr_to_rgb_int(y, cb - 128, cr - 128)
        pixels[pixel: pixel + img.numel()].view(img.shape).copy_(img)
    return pixels


def _pixel_groups(batch: _HostBatch) -> List[Tuple[List[int], tuple, int]]:
    """Where each image's pixels lie in ``_upsample_colour``'s buffer: for
    every geometry group its members (file indices, in file order), the shape
    of one image ([H, W, 3], or [H, W] gray) and the byte offset of the
    group's first image; the members follow each other without gaps, so a
    group is one [members, H, W(, 3)] block."""
    groups = []
    for members, _, pixel in batch.layout.groups:
        s = batch.scans[members[0]]
        shape = (s.height, s.width, 3) if len(s.components) == 3 else (s.height, s.width)
        groups.append((members, shape, pixel))
    return groups


def _images(pixels: np.ndarray, groups) -> List[JpegImage]:
    """The batch's images, in file order, as views of ``pixels``, the host
    copy of ``_upsample_colour``'s buffer laid out as ``groups`` says
    (``_pixel_groups``)."""
    images: List[Optional[JpegImage]] = [None] * sum(len(members) for members, _, _ in groups)
    for members, shape, pixel in groups:
        n = int(np.prod(shape))
        color = ColorType.RGB if len(shape) == 3 else ColorType.GRAY
        for k, i in enumerate(members):
            images[i] = JpegImage(shape[1], shape[0], color,
                                  pixels[pixel + k * n: pixel + (k + 1) * n].reshape(shape))
    return images


def _device_tail(batch: _HostBatch, fancy_upsampling: bool, dev: torch.device) -> torch.Tensor:
    """The pixel tail of a batch after its host stages, on ``dev``: one copy
    of the coefficients and the plane table to it, one ``idct_planes`` launch
    for every plane, upsampling and colour per geometry group. Returns every
    image's pixels in one uint8 buffer on ``dev`` (``_pixel_groups`` says
    where)."""
    coeffs, desc = batch.to_device(dev)
    planes = idct_planes_table(coeffs, batch.layout.table, desc)
    return _upsample_colour(planes, batch, fancy_upsampling)


def _pixel_tier(dev: torch.device) -> str:
    """"host" (the host library's pixel tail, file by file) or "device" (the
    batch's tail on ``dev``): ``PIXO_TPU_DECODE_PIXELS`` where it names one,
    else "host" for the CPU and "device" for a card, as the reference keys
    its default on JAX's backend."""
    mode = os.environ.get("PIXO_TPU_DECODE_PIXELS")
    if mode in ("host", "device"):
        return mode
    return "host" if dev.type == "cpu" else "device"


def _image(scan: _Scan, pixels: np.ndarray) -> JpegImage:
    ct = ColorType.GRAY if len(scan.components) == 1 else ColorType.RGB
    return JpegImage(scan.width, scan.height, ct, pixels)


def _plain_tail(scan: _Scan, coeffs: List[np.ndarray], fancy_upsampling: bool) -> JpegImage:
    """The device tier's tail in plain PyTorch on the CPU, for one file whose
    coefficients are ``coeffs`` (one [blocks, 64] array a component)."""
    layout = _Layout([scan])
    layout.table.set_qtables(np.stack(_qtables(scan)))
    batch = _HostBatch([scan], layout, np.concatenate(coeffs), layout.table.qtables, None)
    pixels = _device_tail(batch, fancy_upsampling, torch.device("cpu"))
    return _images(pixels.numpy(), _pixel_groups(batch))[0]


def _fused_call(scan: _Scan, fancy_upsampling: bool) -> Tuple[int, Callable[[], Optional[np.ndarray]]]:
    """A baseline file's restart segment count, and its fused library decode
    (entropy, IDCT, upsampling and colour) made ready to run on any thread."""
    comps = scan.components
    segments, _ = _split_entropy(scan.data[scan.pos:])
    return len(segments), native_jpeg_decode_baseline_call(
        segments, scan.restart_interval, scan.mcu_cols * scan.mcu_rows, scan.mcu_cols,
        scan.mcu_rows, [c.h for c in comps], [c.v for c in comps], scan.max_h, scan.max_v,
        scan.width, scan.height, [scan.dc_specs[c.dc_table] for c in comps],
        [scan.ac_specs[c.ac_table] for c in comps], _qtables(scan), fancy=fancy_upsampling)


def _tail_call(scan: _Scan, coeffs: List[np.ndarray], fancy_upsampling: bool):
    """The library's pixel tail of the file's decoded ``coeffs``, made ready
    to run on any thread."""
    comps = scan.components
    return native_jpeg_decode_pixels_call(
        coeffs, _qtables(scan), [c.h for c in comps], [c.v for c in comps], scan.mcu_cols,
        scan.mcu_rows, scan.max_h, scan.max_v, scan.width, scan.height, fancy=fancy_upsampling)


def _progressive_tail(scan: _Scan, fancy_upsampling: bool):
    """A progressive file's scans decoded, and its pixel tail made ready:
    (coefficients, the library call)."""
    coeffs = [np.zeros((bw * bh, 64), np.int16) for bw, bh in scan.plane_blocks()]
    _decode_progressive(scan, coeffs)
    return coeffs, _tail_call(scan, coeffs, fancy_upsampling)


def _tail_image(scan: _Scan, coeffs: List[np.ndarray], pixels: Optional[np.ndarray],
                fancy_upsampling: bool) -> JpegImage:
    """The file's image from the library's pixel tail, or, where it declined
    the geometry (None), from the plain PyTorch tail."""
    return _plain_tail(scan, coeffs, fancy_upsampling) if pixels is None else _image(scan, pixels)


def _fused_image(scan: _Scan, nsegments: int, pixels: Optional[np.ndarray],
                 fancy_upsampling: bool) -> JpegImage:
    """A baseline file's image after its fused call: the reference's restart
    count on a success; where the call returned None (a corrupt stream, a
    declined geometry), the two-stage route, so that the reference's error
    surfaces: the entropy stage, then the library's pixel tail."""
    if pixels is None:
        coeffs = [np.zeros((bw * bh, 64), np.int16) for bw, bh in scan.plane_blocks()]
        _decode_entropy(scan, coeffs)
        return _tail_image(scan, coeffs, _tail_call(scan, coeffs, fancy_upsampling)(), fancy_upsampling)
    total_mcus, ri = scan.mcu_cols * scan.mcu_rows, scan.restart_interval
    if ri and nsegments < -(-total_mcus // ri):
        raise errors.InvalidDecode("missing restart segment")
    return _image(scan, pixels)


def _raise_first(results: list) -> None:
    """Raise the first exception of ``results`` (in file order), with that
    file's index as its ``file_index``."""
    failed = next((k for k, r in enumerate(results) if isinstance(r, Exception)), None)
    if failed is not None:
        # which file it was, for a caller that orders it among other inputs
        results[failed].file_index = failed
        raise results[failed]


def _host_tier(files: Sequence[bytes], fancy_upsampling: bool, workers: int) -> List[JpegImage]:
    """The host pixel tier of a non-empty batch (the reference's
    ``_decode_scan`` and ``_finish_scan`` under
    ``PIXO_TPU_DECODE_PIXELS=host``): a baseline file through the fused
    library decode (``_fused_image``), a progressive file's scans then the
    library's pixel tail, or the plain PyTorch tail where the library
    declines the geometry. As in ``_host_stage``, the Python work (markers,
    entropy splitting, the progressive scans, each call's arguments, and
    the two-stage route of a file whose fused call returned None) runs on
    the calling thread; with ``workers`` > 1 only the library calls, which
    release the GIL, go to that many threads, the fused calls once every one
    is ready, each pixel tail as its file's scans are done. Raises the error
    of the first file, in order, that fails."""
    parsed = [_attempt(_parse, data) for data in files]
    pool = _pool(workers) if workers > 1 and len(files) > 1 else None
    start = pool.submit if pool else (lambda call: call())  # a future, or the call's result
    fused = {k: _attempt(_fused_call, s, fancy_upsampling) for k, s in enumerate(parsed)
             if isinstance(s, _Scan) and not s.progressive}
    running = {k: start(prep[1]) for k, prep in fused.items() if not isinstance(prep, Exception)}
    tails = {}
    for k, s in enumerate(parsed):
        if isinstance(s, _Scan) and s.progressive:
            tails[k] = _attempt(_progressive_tail, s, fancy_upsampling)
            if not isinstance(tails[k], Exception):
                running[k] = start(tails[k][1])
    results = list(parsed)
    for k, prep in {**fused, **tails}.items():
        finish = _fused_image if k in fused else _tail_image
        results[k] = prep if isinstance(prep, Exception) else _attempt(
            finish, parsed[k], prep[0], running[k].result() if pool else running[k], fancy_upsampling)
    _raise_first(results)
    return results


def decode_files(files: Sequence[bytes], fancy_upsampling: bool, workers: int,
                 device) -> List[JpegImage]:
    """Decode a batch of JPEG files. Under the device tier (``_pixel_tier``):
    the host stages (the baseline scans' library calls on ``workers``
    threads), the pixel tail for the whole batch on ``device``
    (``_device_tail``), then one copy of every pixel back to the host. Under
    the host tier: each file through the host library on ``workers``
    threads (``_host_tier``). Raises the error of the first file, in order,
    that fails."""
    if not files:
        return []
    dev = torch.device(device)
    if _pixel_tier(dev) == "host":
        return _host_tier(files, fancy_upsampling, workers)
    batch = _host_stage(files, workers, pinned=dev.type == "cuda")
    pixels = _device_tail(batch, fancy_upsampling, dev)
    return _images(pixels.cpu().numpy(), _pixel_groups(batch))


def decode_jpeg(data: bytes, fancy_upsampling: bool = False, *, device="cuda") -> JpegImage:
    """Decode one baseline or progressive JPEG, its pixels by the tier that
    ``device`` ("cpu" or a CUDA device) selects (``_pixel_tier``: the host
    library for "cpu", the tail on the card for a card).
    ``fancy_upsampling=True`` uses libjpeg-style triangle chroma
    interpolation; the default nearest matches the pixo reference decoder.
    Pixels equal the JAX package's ``decode_jpeg``."""
    return decode_files([data], fancy_upsampling, 1, device)[0]
