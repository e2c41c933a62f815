"""Baseline JPEG decode: the parser and Huffman decoder in plain Python, the
pixel tail in plain PyTorch.

``decode_coefficients`` reads a baseline, non-restart, 8-bit file (the kind
the benchmark writes) back to its quantized zigzag coefficients, a Python
loop a symbol: the tests hold the benchmark's sources to it. ``pixels`` is
the pixel tail from those coefficients: dequantization, the jidctint
fixed-point IDCT (CONST_BITS 13, PASS1_BITS 2, int32), nearest chroma
upsampling, the crop and the fixed-point inverse BT.601
(r = y + (359 cr >> 8), g = y - ((88 cb + 183 cr) >> 8), b = y + (454 cb >> 8)).
"""

from __future__ import annotations

import struct
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .jpeg_encode import ZIGZAG


class Decoded(NamedTuple):
    width: int
    height: int
    sampling: List[Tuple[int, int]]  # (h, v) of each component
    qtables: List[np.ndarray]  # natural-order table of each component
    zz: np.ndarray  # [nblocks, 64] int16 zigzag coefficients in scan order


def _huffman(counts: bytes, symbols: bytes) -> Dict[Tuple[int, int], int]:
    table, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            table[(length, code)] = symbols[k]
            code, k = code + 1, k + 1
        code <<= 1
    return table


class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos, self.acc, self.n = data, 0, 0, 0

    def bit(self) -> int:
        if self.n == 0:
            byte = self.data[self.pos]
            self.pos += 1
            if byte == 0xFF:
                if self.data[self.pos] != 0:
                    raise ValueError("marker inside the scan")
                self.pos += 1
            self.acc, self.n = byte, 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def symbol(self, table) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.bit()
            if (length, code) in table:
                return table[(length, code)]
        raise ValueError("bad Huffman code")


def _extend(v: int, size: int) -> int:
    return v - (1 << size) + 1 if size and v < (1 << (size - 1)) else v


def decode_coefficients(data: bytes) -> Decoded:
    """A baseline file's frame and quantized zigzag coefficients."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("no SOI")
    pos, qt, huff, comps = 2, {}, {}, []
    width = height = 0
    while True:
        marker, length = struct.unpack(">HH", data[pos: pos + 4])
        seg = data[pos + 4: pos + 2 + length]
        pos += 2 + length
        if marker == 0xFFDB:
            i = 0
            while i < len(seg):
                if seg[i] >> 4:
                    raise ValueError("16-bit tables are not baseline")
                qt[seg[i] & 15] = np.frombuffer(seg[i + 1: i + 65], np.uint8).astype(np.int64)
                i += 65
        elif marker == 0xFFC0:
            height, width = struct.unpack(">HH", seg[1:5])
            comps = [(seg[6 + 3 * c], seg[7 + 3 * c] >> 4, seg[7 + 3 * c] & 15, seg[8 + 3 * c])
                     for c in range(seg[5])]
        elif marker == 0xFFC4:
            i = 0
            while i < len(seg):
                counts = seg[i + 1: i + 17]
                n = sum(counts)
                huff[seg[i]] = _huffman(counts, seg[i + 17: i + 17 + n])
                i += 17 + n
        elif marker == 0xFFDA:
            sel = {seg[1 + 2 * c]: seg[2 + 2 * c] for c in range(seg[0])}
            break
        elif marker in (0xFFC1, 0xFFC2, 0xFFDD):
            raise ValueError("not a baseline file without restarts")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcus = -(-width // (8 * hmax)) * -(-height // (8 * vmax))
    order = [k for k, c in enumerate(comps) for _ in range(c[1] * c[2])]
    reader = _Bits(data[pos:])
    zz = np.zeros((mcus * len(order), 64), np.int16)
    pred = [0] * len(comps)
    row = 0
    for _ in range(mcus):
        for k in order:
            dc_t, ac_t = huff[sel[comps[k][0]] >> 4], huff[0x10 | (sel[comps[k][0]] & 15)]
            size = reader.symbol(dc_t)
            pred[k] += _extend(reader.bits(size), size)
            zz[row, 0] = pred[k]
            i = 1
            while i < 64:
                rs = reader.symbol(ac_t)
                run, size = rs >> 4, rs & 15
                if size == 0:
                    if run != 15:
                        break
                    i += 16
                    continue
                i += run
                zz[row, i] = _extend(reader.bits(size), size)
                i += 1
            row += 1
    natural = [np.empty(64, np.int64) for _ in comps]
    for k, c in enumerate(comps):
        natural[k][ZIGZAG] = qt[c[3]]
    return Decoded(width, height, [(c[1], c[2]) for c in comps], natural, zz)


_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633, f1501=12299,
            f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_pass(d, descale):
    f = _FIX
    z1 = (d[2] + d[6]) * f["f0541"]
    tmp2 = z1 - d[6] * f["f1847"]
    tmp3 = z1 + d[2] * f["f0765"]
    tmp0 = (d[0] + d[4]) << 13
    tmp1 = (d[0] - d[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    z1, z2, z3, z4 = d[7] + d[1], d[5] + d[3], d[7] + d[3], d[5] + d[1]
    z5 = (z3 + z4) * f["f1175"]
    t0, t1, t2, t3 = d[7] * f["f0298"], d[5] * f["f2053"], d[3] * f["f3072"], d[1] * f["f1501"]
    z1 = z1 * (-f["f0899"])
    z2 = z2 * (-f["f2562"])
    z3 = z3 * (-f["f1961"]) + z5
    z4 = z4 * (-f["f0390"]) + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [descale(v) for v in (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
                                 tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def idct8x8(natural: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] int32 dequantized natural-order coefficients -> uint8
    pixels: the columns, a descale by 2**11, the rows, a descale by 2**18,
    +128 and a clamp."""
    x = natural.to(torch.int32)
    ws = torch.stack(_idct_pass([x[..., i, :] for i in range(8)], lambda v: (v + 1024) >> 11), dim=-2)
    out = _idct_pass([ws[..., i] for i in range(8)],
                     lambda v: (((v + (1 << 17)) >> 18) + 128).clamp(0, 255))
    return torch.stack(out, dim=-1).to(torch.uint8)


def pixels(dec: Decoded, device="cpu") -> torch.Tensor:
    """[H, W, 3] uint8 pixels of a decoded baseline file with three
    components, on ``device``."""
    hmax = max(h for h, _ in dec.sampling)
    vmax = max(v for _, v in dec.sampling)
    mx, my = -(-dec.width // (8 * hmax)), -(-dec.height // (8 * vmax))
    per_mcu = [h * v for h, v in dec.sampling]
    zz = torch.from_numpy(dec.zz.astype(np.int32)).to(device).reshape(my * mx, sum(per_mcu), 64)
    inv = torch.from_numpy(np.argsort(ZIGZAG)).to(device)
    planes, first = [], 0
    for (h, v), q, n in zip(dec.sampling, dec.qtables, per_mcu):
        c = zz[:, first: first + n]
        first += n
        deq = c * torch.from_numpy(q[ZIGZAG].astype(np.int32)).to(device)
        blk = idct8x8(deq.index_select(-1, inv).reshape(my * mx, n, 8, 8))
        # MCU (my, mx), block (v, h) -> plane rows and columns
        plane = blk.reshape(my, mx, v, h, 8, 8).permute(0, 2, 4, 1, 3, 5).reshape(my * v * 8, mx * h * 8)
        plane = plane.repeat_interleave(vmax // v, dim=0).repeat_interleave(hmax // h, dim=1)
        planes.append(plane[: dec.height, : dec.width].to(torch.int32))
    y, cb, cr = planes[0], planes[1] - 128, planes[2] - 128
    rgb = torch.stack([y + ((cr * 359) >> 8), y - ((cb * 88 + cr * 183) >> 8), y + ((cb * 454) >> 8)], -1)
    return rgb.clamp(0, 255).to(torch.uint8)
