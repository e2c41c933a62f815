"""Baseline JPEG encode with the standard tables, in plain PyTorch and NumPy.

The coefficient chain runs on torch tensors on any device; every float32
operation is its own eager op, so nothing is contracted into a fused
multiply-add, and the order is pixo's (``src/jpeg/dct.rs``: rows, then
columns, 5 multiplies and 29 adds a 1-D pass, post-scale). The entropy
packer is vectorised NumPy: every Huffman symbol of a scan becomes one
(bits, length) item, and the items are laid out bit by bit at once.
"""

from __future__ import annotations

import struct
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]

STD_LUMINANCE = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], dtype=np.int64)
STD_CHROMINANCE = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
] + [99] * 32, dtype=np.int64)

# ZIGZAG[i]: the natural-order index of the i-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# Annex K.3 Huffman specifications: (code counts by length 1..16, symbols)
DC_LUM = (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12)))
DC_CHROM = (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12)))
AC_LUM = (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125]), bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]))
AC_CHROM = (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119]), bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
]))

# MCU layouts: component id (0 = Y, 1 = Cb, 2 = Cr) of each block of an MCU
PATTERNS = {"444": (0, 1, 2), "420": (0, 0, 0, 0, 1, 2)}
MCU_SIZE = {"444": 8, "420": 16}


def quant_tables(quality: int):
    """(luminance, chrominance) natural-order integer tables at ``quality``,
    libjpeg's scaling."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((t * scale + 50) // 100, 1, 255) for t in (STD_LUMINANCE, STD_CHROMINANCE))


def code_table(spec, size: int):
    """Canonical codes and lengths, indexed by symbol, of a (counts, symbols)
    specification."""
    counts, symbols = spec
    codes, lengths = np.zeros(size, np.int64), np.zeros(size, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lengths


_TABLES = [(code_table(DC_LUM, 12), code_table(AC_LUM, 256)),
           (code_table(DC_CHROM, 12), code_table(AC_CHROM, 256))]


# ------------------------------------------------------------ coefficient chain


def _keep(rnd: Rounding):
    return rnd if rnd is not None else (lambda t: t)


def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> [..., 3] uint8: BT.601 in /256 fixed point with an
    arithmetic right shift, clamped."""
    x = rgb.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = (77 * r + 150 * g + 29 * b + 128) >> 8
    cb = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128
    cr = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128
    return torch.stack([y, cb, cr], dim=-1).clamp(0, 255).to(torch.uint8)


def _pad_edges(img: torch.Tensor, mult: int) -> torch.Tensor:
    """Rows and columns repeated at the bottom and right edge up to multiples
    of ``mult``."""
    h, w = img.shape[1], img.shape[2]
    ph, pw = -(-h // mult) * mult, -(-w // mult) * mult
    if ph != h:
        img = img.index_select(1, torch.arange(ph, device=img.device).clamp_(max=h - 1))
    if pw != w:
        img = img.index_select(2, torch.arange(pw, device=img.device).clamp_(max=w - 1))
    return img


def _tiles(plane: torch.Tensor) -> torch.Tensor:
    b, h, w = plane.shape
    return plane.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def blocks(imgs: torch.Tensor, mode: str, rnd: Rounding = None) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, nblocks, 8, 8] float32 level-shifted blocks
    in scan order: per 8x8 MCU Y, Cb, Cr ("444"), or per 16x16 MCU the four
    Y blocks then the 2x2 averages of Cb and Cr, summed (((a + b) + c) + d),
    times 0.25, minus 128 ("420")."""
    r = _keep(rnd)
    img = _pad_edges(imgs, MCU_SIZE[mode])
    b, h, w = img.shape[:3]
    ycc = rgb_to_ycbcr(img).to(torch.float32)
    if mode == "444":
        t = (ycc - 128.0).reshape(b, h // 8, 8, w // 8, 8, 3)
        return t.permute(0, 1, 3, 5, 2, 4).reshape(b, -1, 8, 8)
    y = ycc[..., 0] - 128.0

    def avg(p):
        q = p.reshape(b, h // 2, 2, w // 2, 2)
        s = r(r(r(q[:, :, 0, :, 0] + q[:, :, 0, :, 1]) + q[:, :, 1, :, 0]) + q[:, :, 1, :, 1])
        return r(r(s * 0.25) - 128.0)

    nmy, nmx = h // 16, w // 16
    yt = y.reshape(b, nmy, 2, 8, nmx, 2, 8).permute(0, 1, 4, 2, 5, 3, 6).reshape(b, nmy * nmx, 4, 8, 8)
    cb = _tiles(avg(ycc[..., 1])).reshape(b, nmy * nmx, 1, 8, 8)
    cr = _tiles(avg(ycc[..., 2])).reshape(b, nmy * nmx, 1, 8, 8)
    return torch.cat([yt, cb, cr], dim=2).reshape(b, -1, 8, 8)


_A1 = float(np.float32(0.70710678118654752440))
_A2 = float(np.float32(0.5411961))
_A4 = float(np.float32(1.3065629))
_A5 = float(np.float32(0.38268343))
_S = [float(np.float32(s)) for s in (0.3535534, 0.2548978, 0.2705981, 0.3006724,
                                     0.3535534, 0.4499881, 0.6532815, 1.2814578)]


def _aan(d, r):
    """One AAN 1-D pass over eight float32 tensors, pixo's operation order."""
    t0, t7 = r(d[0] + d[7]), r(d[0] - d[7])
    t1, t6 = r(d[1] + d[6]), r(d[1] - d[6])
    t2, t5 = r(d[2] + d[5]), r(d[2] - d[5])
    t3, t4 = r(d[3] + d[4]), r(d[3] - d[4])
    t10, t13 = r(t0 + t3), r(t0 - t3)
    t11, t12 = r(t1 + t2), r(t1 - t2)
    o0, o4 = r(t10 + t11), r(t10 - t11)
    z1 = r(r(t12 + t13) * _A1)
    o2, o6 = r(t13 + z1), r(t13 - z1)
    u10, u11, u12 = r(t4 + t5), r(t5 + t6), r(t6 + t7)
    z5 = r(r(u10 - u12) * _A5)
    z2 = r(r(u10 * _A2) + z5)
    z4 = r(r(u12 * _A4) + z5)
    z3 = r(u11 * _A1)
    z11, z13 = r(t7 + z3), r(t7 - z3)
    o5, o3 = r(z13 + z2), r(z13 - z2)
    o1, o7 = r(z11 + z4), r(z11 - z4)
    return [r(o * s) for o, s in zip((o0, o1, o2, o3, o4, o5, o6, o7), _S)]


def dct8x8(x: torch.Tensor, rnd: Rounding = None) -> torch.Tensor:
    """[..., 8, 8] float32 -> its 2-D AAN DCT: the rows, then the columns."""
    r = _keep(rnd)
    rows = torch.stack(_aan([x[..., i] for i in range(8)], r), dim=-1)
    return torch.stack(_aan([rows[..., i, :] for i in range(8)], r), dim=-2)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    away = torch.where(x >= 0, t + 1.0, t - 1.0)
    return torch.where((x - t).abs() == 0.5, away, torch.round(x))


def coefficients(imgs: torch.Tensor, quality: int, mode: str, rnd: Rounding = None) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, nblocks, 64] int16 quantized zigzag
    coefficients in scan order, on ``imgs``' device."""
    r = _keep(rnd)
    lum, chrom = quant_tables(quality)
    dev = imgs.device
    pattern = PATTERNS[mode]
    q = torch.from_numpy(np.stack([lum if c == 0 else chrom for c in pattern]).astype(np.float32))
    q = q.reshape(len(pattern), 8, 8).to(dev)
    blk = blocks(imgs, mode, rnd)
    b, n = blk.shape[:2]
    dct = dct8x8(blk, rnd).reshape(b, n // len(pattern), len(pattern), 8, 8)
    quant = round_half_away(r(dct / q)).to(torch.int16).reshape(b, n, 64)
    return quant.index_select(-1, torch.from_numpy(ZIGZAG).to(dev))


# ------------------------------------------------------------ entropy coding


def _category(v: np.ndarray) -> np.ndarray:
    """Bit length of |v| (values up to 2**15)."""
    return np.frexp(np.abs(v.astype(np.float64)))[1].astype(np.int64)


def _magnitude_bits(v: np.ndarray, cat: np.ndarray) -> np.ndarray:
    v = v.astype(np.int64)
    return np.where(v < 0, v - 1, v) & ((1 << cat) - 1)


def _emit(vals: np.ndarray, lens: np.ndarray) -> bytes:
    """MSB-first concatenation of (value, length <= 64) items, padded with 1
    bits to a byte, 0xFF stuffed with 0x00."""
    total = int(lens.sum())
    item = np.repeat(np.arange(len(lens)), lens)  # the item of every output bit
    below = np.cumsum(lens)[item] - 1 - np.arange(total)  # its place from the item's end
    bits = np.ones(total + (-total) % 8, np.uint8)
    bits[:total] = (vals[item] >> below) & 1
    packed = np.packbits(bits)
    ff = np.flatnonzero(packed == 0xFF)
    return np.insert(packed, ff + 1, 0).tobytes()


def pack_scan(zz: np.ndarray, pattern: Sequence[int]) -> bytes:
    """One baseline scan, no restart markers, of [nblocks, 64] int16 zigzag
    coefficients in scan order with the standard tables: per block the DC
    difference (category code, magnitude bits), then each nonzero AC as its
    run of zeros (a ZRL code per 16) and its (run, category) code with
    magnitude bits, then EOB where the block ends in zeros."""
    zz = np.asarray(zz, np.int64)
    n = zz.shape[0]
    comp = np.tile(np.asarray(pattern), n // len(pattern))
    chroma = (comp != 0).astype(np.int64)
    dc = zz[:, 0]
    diff = np.empty(n, np.int64)
    for c in set(pattern):
        idx = np.flatnonzero(comp == c)
        diff[idx] = dc[idx] - np.concatenate([[0], dc[idx[:-1]]])
    cat = _category(diff)
    dc_code = np.where(chroma == 0, _TABLES[0][0][0][cat], _TABLES[1][0][0][cat])
    dc_len = np.where(chroma == 0, _TABLES[0][0][1][cat], _TABLES[1][0][1][cat])
    dc_val = (dc_code << cat) | _magnitude_bits(diff, cat)
    dc_len = dc_len + cat

    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    v = zz[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
    run = k - prev - 1
    nzrl, run = run // 16, run % 16
    acat = _category(v)
    ch = chroma[blk]
    codes = [(_TABLES[t][1][0], _TABLES[t][1][1]) for t in (0, 1)]
    rs = (run << 4) | acat
    rs_code = np.where(ch == 0, codes[0][0][rs], codes[1][0][rs])
    rs_len = np.where(ch == 0, codes[0][1][rs], codes[1][1][rs])
    zrl_code = np.where(ch == 0, codes[0][0][0xF0], codes[1][0][0xF0])
    zrl_len = np.where(ch == 0, codes[0][1][0xF0], codes[1][1][0xF0])
    ac_val = np.zeros(len(blk), np.int64)
    ac_len = np.zeros(len(blk), np.int64)
    for _ in range(3):  # at most 3 ZRLs: a run of 62 zeros
        m = nzrl > 0
        ac_val[m] = (ac_val[m] << zrl_len[m]) | zrl_code[m]
        ac_len[m] += zrl_len[m]
        nzrl = nzrl - m
    ac_val = (((ac_val << rs_len) | rs_code) << acat) | _magnitude_bits(v, acat)
    ac_len = ac_len + rs_len + acat

    nnz = np.bincount(blk, minlength=n)
    last = np.zeros(n, np.int64)
    ends = np.flatnonzero(np.append(blk[1:] != blk[:-1], True)) if len(blk) else blk
    last[blk[ends]] = k[ends]
    eob = last < 63
    eob_code = np.where(chroma == 0, codes[0][0][0], codes[1][0][0])
    eob_len = np.where(chroma == 0, codes[0][1][0], codes[1][1][0])

    per_block = 1 + nnz + eob
    base = np.cumsum(per_block) - per_block
    items = int(per_block.sum())
    vals, lens = np.zeros(items, np.int64), np.zeros(items, np.int64)
    vals[base], lens[base] = dc_val, dc_len
    rank = np.arange(len(blk)) - (np.cumsum(nnz) - nnz)[blk]
    vals[base[blk] + 1 + rank], lens[base[blk] + 1 + rank] = ac_val, ac_len
    e = np.flatnonzero(eob)
    vals[base[e] + 1 + nnz[e]], lens[base[e] + 1 + nnz[e]] = eob_code[e], eob_len[e]
    return _emit(vals, lens)


def frame(scan: bytes, width: int, height: int, quality: int, mode: str) -> bytes:
    """The baseline file around ``scan``: SOI, APP0 (JFIF 1.01, no units,
    1x1 density), two DQT (zigzag order), SOF0, the four DHT, SOS, the scan,
    EOI: pixo's segments in pixo's order."""
    lum, chrom = quant_tables(quality)
    out = bytearray(struct.pack(">HH", 0xFFD8, 0xFFE0) + struct.pack(">H", 16) + b"JFIF\x00"
                    + bytes([1, 1, 0]) + struct.pack(">HH", 1, 1) + bytes([0, 0]))
    for tid, table in ((0, lum), (1, chrom)):
        out += struct.pack(">HH", 0xFFDB, 67) + bytes([tid]) + table[ZIGZAG].astype(np.uint8).tobytes()
    y_sampling = 0x22 if mode == "420" else 0x11
    out += struct.pack(">HHBHHB", 0xFFC0, 17, 8, height, width, 3)
    out += bytes([1, y_sampling, 0, 2, 0x11, 1, 3, 0x11, 1])
    for tid, (counts, symbols) in ((0x00, DC_LUM), (0x01, DC_CHROM), (0x10, AC_LUM), (0x11, AC_CHROM)):
        out += struct.pack(">HHB", 0xFFC4, 19 + len(symbols), tid) + counts + symbols
    out += struct.pack(">HHB", 0xFFDA, 12, 3) + bytes([1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return bytes(out) + scan + b"\xff\xd9"


def encode(imgs: torch.Tensor, quality: int, mode: str, rnd: Rounding = None) -> List[bytes]:
    """[B, H, W, 3] uint8 -> each image's baseline JPEG file."""
    zz = coefficients(imgs, quality, mode, rnd).cpu().numpy()
    h, w = imgs.shape[1], imgs.shape[2]
    return [frame(pack_scan(z, PATTERNS[mode]), w, h, quality, mode) for z in zz]
