"""The JPEG decode's pixel math in plain PyTorch: dequantize, un-zigzag,
integer IDCT, plane assembly, chroma upsampling and the inverse BT.601.

Counterpart of the JAX package's ``ops/jpeg_decode.py``, on torch tensors on
any device, bit-equal to its jnp functions:

- the jidctint fixed-point IDCT, CONST_BITS 13 / PASS1_BITS 2, in int32.
  Torch's int32 ``*``, ``+`` and ``<<`` wrap modulo 2**32 and its ``>>``
  shifts arithmetically, on the CPU and on the card, as jnp.int32 does: on
  dequantized coefficients that overflow (corrupt or hostile streams; the
  decoder accepts them), this version wraps exactly as the reference's jnp
  tier and its TPU kernel ``idct8x8_int_pallas`` do, not as its int64 NumPy
  mirror. The NumPy mirrors are not ported.
- nearest and libjpeg-style triangle chroma upsampling, and the fixed-point
  inverse BT.601: r = y + (359 cr >> 8), g = y - ((88 cb + 183 cr) >> 8),
  b = y + (454 cb >> 8).

Plane functions act on the last two dimensions, so a batch of planes of one
geometry ([B, H, W]) goes through them at once.
"""

from __future__ import annotations

import torch

from ..jpeg.tables import ZIGZAG_INV

CONST_BITS = 13
PASS1_BITS = 2
ROUND_PASS1 = 1 << (CONST_BITS - PASS1_BITS - 1)
ROUND_OUTPUT = 1 << (CONST_BITS + PASS1_BITS + 3 - 1)

FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _idct_pass(cols, descale):
    """One jidctint 1-D butterfly over eight int32 lane tensors; every
    product stays at 2**13 scale and ``descale`` runs once per output."""
    d0, d1, d2, d3, d4, d5, d6, d7 = cols

    # Even part
    z1 = (d2 + d6) * FIX_0_541196100
    tmp2 = z1 - d6 * FIX_1_847759065
    tmp3 = z1 + d2 * FIX_0_765366865
    tmp0 = (d0 + d4) << 13
    tmp1 = (d0 - d4) << 13
    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    # Odd part
    z1 = d7 + d1
    z2 = d5 + d3
    z3 = d7 + d3
    z4 = d5 + d1
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = d7 * FIX_0_298631336
    t1 = d5 * FIX_2_053119869
    t2 = d3 * FIX_3_072711026
    t3 = d1 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560) + z5
    z4 = z4 * (-FIX_0_390180644) + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    return [
        descale(tmp10 + t3),
        descale(tmp11 + t2),
        descale(tmp12 + t1),
        descale(tmp13 + t0),
        descale(tmp13 - t0),
        descale(tmp12 - t1),
        descale(tmp11 - t2),
        descale(tmp10 - t3),
    ]


def idct8x8_int(blocks: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] int32 natural-order dequantized coefficients -> [..., 8, 8]
    uint8 pixels: column pass, workspace descale, row pass, +128, clamp."""
    x = blocks.to(torch.int32)
    cols = [x[..., i, :] for i in range(8)]
    ws = _idct_pass(cols, lambda v: (v + ROUND_PASS1) >> (CONST_BITS - PASS1_BITS))
    w = torch.stack(ws, dim=-2)
    rows = [w[..., i] for i in range(8)]
    outs = _idct_pass(
        rows,
        lambda v: (((v + ROUND_OUTPUT) >> (CONST_BITS + PASS1_BITS + 3)) + 128).clamp(0, 255),
    )
    return torch.stack(outs, dim=-1).to(torch.uint8)


def dequant_idct_blocks(zz_coeffs: torch.Tensor, qtable_zz: torch.Tensor) -> torch.Tensor:
    """[N, 64] int16 zigzag coefficients x [N, 64]-broadcastable zigzag
    table -> [N, 8, 8] uint8 blocks."""
    deq = zz_coeffs.to(torch.int32) * qtable_zz.to(torch.int32)
    natural = deq[..., torch.as_tensor(ZIGZAG_INV, dtype=torch.long, device=deq.device)]
    return idct8x8_int(natural.reshape(natural.shape[:-1] + (8, 8)))


def ycbcr_to_rgb_int(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """Fixed-point BT.601 inverse over int32 tensors (y full range, cb and cr
    already centred by -128) -> uint8 [..., 3]."""
    r = y + ((cr * 359) >> 8)
    g = y - ((cb * 88 + cr * 183) >> 8)
    b = y + ((cb * 454) >> 8)
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


def assemble_plane(blocks: torch.Tensor, blocks_w: int, blocks_h: int) -> torch.Tensor:
    """[..., nblocks, 8, 8] in raster block order -> [..., 8 blocks_h, 8 blocks_w]."""
    lead = blocks.shape[:-3]
    t = blocks.reshape(lead + (blocks_h, blocks_w, 8, 8)).transpose(-3, -2)
    return t.reshape(lead + (blocks_h * 8, blocks_w * 8))


def upsample_nearest(plane: torch.Tensor, h_ratio: int, v_ratio: int) -> torch.Tensor:
    """Nearest-neighbour chroma upsampling by any integer ratios."""
    if v_ratio > 1:
        plane = plane.repeat_interleave(v_ratio, dim=-2)
    if h_ratio > 1:
        plane = plane.repeat_interleave(h_ratio, dim=-1)
    return plane


def _shift_edge(plane: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The plane shifted by (dy, dx), its edge rows and columns repeated."""
    if dy == -1:
        plane = torch.cat([plane[..., :1, :], plane[..., :-1, :]], dim=-2)
    elif dy == 1:
        plane = torch.cat([plane[..., 1:, :], plane[..., -1:, :]], dim=-2)
    if dx == -1:
        plane = torch.cat([plane[..., :1], plane[..., :-1]], dim=-1)
    elif dx == 1:
        plane = torch.cat([plane[..., 1:], plane[..., -1:]], dim=-1)
    return plane


def _interleave2(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a and b interleaved along ``dim`` (-2 or -1), a first."""
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([a, b], dim=dim).reshape(shape)


def _triangle_h2(plane: torch.Tensor) -> torch.Tensor:
    """libjpeg h2 fancy upsampling along the width (int32 plane)."""
    left = _shift_edge(plane, 0, -1)
    right = _shift_edge(plane, 0, 1)
    even = (3 * plane + left + 2) >> 2
    odd = (3 * plane + right + 1) >> 2
    return _interleave2(even, odd, dim=-1)


def upsample_triangle(plane: torch.Tensor, h_ratio: int, v_ratio: int) -> torch.Tensor:
    """libjpeg-style fancy (triangle) chroma upsampling for ratios 1 and 2,
    over the whole (MCU-padded) plane; nearest for any other ratio."""
    if h_ratio not in (1, 2) or v_ratio not in (1, 2):
        return upsample_nearest(plane, h_ratio, v_ratio)
    p = plane.to(torch.int32)
    if v_ratio == 2:
        up = _shift_edge(p, -1, 0)
        down = _shift_edge(p, 1, 0)
        if h_ratio == 2:
            # h2v2: vertical 3:1 rows (scaled by 4), then horizontal: the
            # 9-3-3-1 kernel
            def h2_scaled(r):
                left = _shift_edge(r, 0, -1)
                right = _shift_edge(r, 0, 1)
                return _interleave2((3 * r + left + 8) >> 4, (3 * r + right + 7) >> 4, dim=-1)

            return _interleave2(h2_scaled(3 * p + up), h2_scaled(3 * p + down), dim=-2)
        return _interleave2((3 * p + up + 2) >> 2, (3 * p + down + 1) >> 2, dim=-2)
    if h_ratio == 2:
        return _triangle_h2(p)
    return p
