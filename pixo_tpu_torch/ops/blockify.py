"""Block/MCU extraction for JPEG on batched tensors: the plain version.

Counterpart of the JAX package's ``ops/blockify.py``. Every function takes a
batch ``[B, H, W, 3]`` (or ``[B, H, W]`` for gray) uint8 tensor and returns
``[B, nblocks, 8, 8]`` float32 level-shifted blocks in *scan order*
(interleaved per MCU), so the host packer reads one contiguous stream.

Parity targets (pixo ``src/jpeg/mod.rs``): ``extract_block`` (:1565-1606,
edge-clamp padding, fixed-point YCbCr, level shift -128) and
``extract_mcu_420`` (:1608-1656, four Y blocks then the 2x2-averaged Cb/Cr).

Edges are padded by clamping the row and column indices, as the JAX
package's NumPy mirrors do; ``F.pad(mode="replicate")`` would need float
NCHW input.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..color import rgb_to_ycbcr


def _clamp_pad(img: torch.Tensor, mult_h: int, mult_w: int) -> torch.Tensor:
    """Pad dims 1 (rows) and 2 (columns) of ``img`` up to multiples of
    ``mult_h``/``mult_w`` by repeating the last row and column."""
    h, w = img.shape[1], img.shape[2]
    ph, pw = -(-h // mult_h) * mult_h, -(-w // mult_w) * mult_w
    if ph != h:
        ys = torch.arange(ph, device=img.device).clamp_(max=h - 1)
        img = img.index_select(1, ys)
    if pw != w:
        xs = torch.arange(pw, device=img.device).clamp_(max=w - 1)
        img = img.index_select(2, xs)
    return img


def _tile_8x8(plane: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H//8 * W//8, 8, 8] in raster block order."""
    b, h, w = plane.shape
    t = plane.reshape(b, h // 8, 8, w // 8, 8)
    return t.permute(0, 1, 3, 2, 4).reshape(b, -1, 8, 8)


def _ycc_planes(img: torch.Tensor):
    """uint8 RGB -> (Y - 128, Cb, Cr) float32 planes."""
    ycc = rgb_to_ycbcr(img).to(torch.float32)
    return ycc[..., 0] - 128.0, ycc[..., 1], ycc[..., 2]


def blocks_gray(gray: torch.Tensor) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, nblocks, 8, 8] f32 blocks, raster order."""
    img = _clamp_pad(gray, 8, 8)
    return _tile_8x8(img.to(torch.float32) - 128.0)


def blocks_444(rgb: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, nmcu*3, 8, 8] f32 blocks, scan order
    (Y, Cb, Cr) per 8x8 MCU, MCUs in raster order."""
    img = _clamp_pad(rgb, 8, 8)
    b, h, w = img.shape[:3]
    ycc = rgb_to_ycbcr(img).to(torch.float32) - 128.0
    t = ycc.reshape(b, h // 8, 8, w // 8, 8, 3)
    return t.permute(0, 1, 3, 5, 2, 4).reshape(b, -1, 8, 8)


def blocks_420(rgb: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, nmcu*6, 8, 8] f32 blocks in 4:2:0 scan order.

    Per 16x16 MCU: Y(0,0), Y(0,1), Y(1,0), Y(1,1), Cb, Cr. Chroma is the 2x2
    average of the fixed-point-converted u8 Cb/Cr values, computed in f32 as
    (((a + b) + c) + d) * 0.25 - 128, in exactly that order.
    """
    img = _clamp_pad(rgb, 16, 16)
    b, h, w = img.shape[:3]
    yf, cb, cr = _ycc_planes(img)

    def avg2x2(p):
        q = p.reshape(b, h // 2, 2, w // 2, 2)
        s = q[:, :, 0, :, 0] + q[:, :, 0, :, 1] + q[:, :, 1, :, 0] + q[:, :, 1, :, 1]
        return s * 0.25 - 128.0

    nmy, nmx = h // 16, w // 16
    yt = yf.reshape(b, nmy, 2, 8, nmx, 2, 8).permute(0, 1, 4, 2, 5, 3, 6)
    yt = yt.reshape(b, nmy * nmx, 4, 8, 8)
    cbt = _tile_8x8(avg2x2(cb)).reshape(b, nmy * nmx, 1, 8, 8)
    crt = _tile_8x8(avg2x2(cr)).reshape(b, nmy * nmx, 1, 8, 8)
    return torch.cat([yt, cbt, crt], dim=2).reshape(b, -1, 8, 8)


def blocks_422(rgb: torch.Tensor) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> [B, nmcu*4, 8, 8] f32 blocks in 4:2:2 scan order.

    Per 16x8 MCU: Y(left), Y(right), Cb, Cr. Chroma is the horizontal pair
    average (a + b) * 0.5 - 128 in f32.
    """
    img = _clamp_pad(rgb, 8, 16)
    b, h, w = img.shape[:3]
    yf, cb, cr = _ycc_planes(img)

    def avg2h(p):
        q = p.reshape(b, h, w // 2, 2)
        return (q[..., 0] + q[..., 1]) * 0.5 - 128.0

    nmy, nmx = h // 8, w // 16
    yt = yf.reshape(b, nmy, 8, nmx, 2, 8).permute(0, 1, 3, 4, 2, 5)
    yt = yt.reshape(b, nmy * nmx, 2, 8, 8)
    cbt = _tile_8x8(avg2h(cb)).reshape(b, nmy * nmx, 1, 8, 8)
    crt = _tile_8x8(avg2h(cr)).reshape(b, nmy * nmx, 1, 8, 8)
    return torch.cat([yt, cbt, crt], dim=2).reshape(b, -1, 8, 8)


def scan_layout(
    width: int, height: int, color: str, subsampling: str
) -> Tuple[int, int, Tuple[int, ...]]:
    """(n_mcus, blocks_per_mcu, component-id pattern per MCU).

    Component ids: 0=Y, 1=Cb, 2=Cr. Matches the reference's MCU traversal
    (``encode_scan``, ``src/jpeg/mod.rs:1408-1570``).
    """
    if color == "gray":
        pw, ph = (width + 7) & ~7, (height + 7) & ~7
        return (pw // 8) * (ph // 8), 1, (0,)
    if subsampling == "420":
        pw, ph = (width + 15) & ~15, (height + 15) & ~15
        return (pw // 16) * (ph // 16), 6, (0, 0, 0, 0, 1, 2)
    if subsampling == "422":
        pw, ph = (width + 15) & ~15, (height + 7) & ~7
        return (pw // 16) * (ph // 8), 4, (0, 0, 1, 2)
    pw, ph = (width + 7) & ~7, (height + 7) & ~7
    return (pw // 8) * (ph // 8), 3, (0, 1, 2)


def num_blocks(h: int, w: int, mode: str) -> int:
    """Blocks per image for coefficient ``mode`` ("gray", "444", "420" or
    "422"): MCUs times blocks per MCU."""
    n_mcus, bpm, _ = scan_layout(w, h, "gray" if mode == "gray" else "rgb", mode)
    return n_mcus * bpm
