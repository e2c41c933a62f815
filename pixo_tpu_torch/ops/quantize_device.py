"""Plain PyTorch versions of the lossy PNG's device functions.

Counterparts of the JAX package's ``ops/quantize_device.py`` (semantics
source: pixo ``src/png/mod.rs:1160-1701``), batched over images (the
reference's ``vmap`` written out) and bit-equal to the host tier:

  - ``redmean_dist`` and ``nearest_palette``: the redmean argmin in int32,
    the first index on ties (mod.rs:1405-1430);
  - ``kmeans_refine``: two weighted refinement iterations (mod.rs:1346-1390)
    through segment sums, here ``index_add_`` in int64;
  - ``palette_lut``: the 6-6-6 opaque LUT as a chunked distance reduction
    (mod.rs:1448-1499);
  - ``dither_fs``: Floyd-Steinberg error diffusion as an anti-diagonal
    wavefront, a Python loop over its W + 2(H - 1) steps: step t handles
    pixel (y, t - 2y) of every row, which satisfies FS's left / up-left / up
    / up-right dependency cone. The order of the error sums does not matter:
    every term is k/16 times an integer in [-255, 255], so the partial sums
    are exact (in f32 as in int32, where they are kept here as 16 times the
    error).

They are what ``ops/kernels.py``'s ``kmeans_refine``, ``palette_lut`` and
``dither_fs`` take for tensors on the CPU, and what the CUDA kernels are held
to on the card.
"""

from __future__ import annotations

import numpy as np
import torch

INT32_MAX = 2**31 - 1
KMEANS_ITERATIONS = 2  # the reference's refinement (mod.rs:1346-1390)
LUT_CHUNK = 32768  # grid colours a distance matrix of palette_lut holds

_GRID = None


def lut_grid() -> np.ndarray:
    """[262144, 4] uint8: the 6-6-6 grid expanded to 8 bits, alpha 255 (the
    JAX package's ``png/quantize.py::_lut_grid``, which its device module
    imports; the port's host tier builds its LUT in the native library and
    needs no grid)."""
    global _GRID
    if _GRID is None:
        v6 = np.arange(64, dtype=np.uint8)
        v8 = (v6 << 2) | (v6 >> 4)
        _GRID = np.stack([np.repeat(v8, 64 * 64), np.tile(np.repeat(v8, 64), 64),
                          np.tile(v8, 64 * 64), np.full(64 ** 3, 255, np.uint8)], axis=1)
    return _GRID


def redmean_dist(colors: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., K, 4] uint8 (or int) -> [..., N, K] int32 distances."""
    c = colors.to(torch.int32)[..., :, None, :]
    p = palette.to(torch.int32)[..., None, :, :]
    dr = c[..., 0] - p[..., 0]
    dg = c[..., 1] - p[..., 1]
    db = c[..., 2] - p[..., 2]
    da = c[..., 3] - p[..., 3]
    rm = (c[..., 0] + p[..., 0]) >> 1
    dist = ((512 + rm) * dr * dr + 1024 * dg * dg + (767 - rm) * db * db) >> 8
    return dist + da * da


def nearest_palette(colors: torch.Tensor, palette: torch.Tensor) -> torch.Tensor:
    """[..., N, 4] x [..., K, 4] uint8 -> [..., N] int32 argmin redmean, the
    first on ties (``argmin``'s rule), matching the reference's strict-< scan."""
    return redmean_dist(colors, palette).argmin(dim=-1).to(torch.int32)


def valid_entries(k_valid, b: int, k: int) -> list:
    """Each palette's entries that a scan takes: ``k_valid`` ([B] int32)
    clamped to 1..K, as the kernels clamp it, or all K without it."""
    if k_valid is None:
        return [k] * b
    return [min(max(int(v), 1), k) for v in k_valid.tolist()]


def kmeans_refine(palette: torch.Tensor, colors: torch.Tensor, weights: torch.Tensor,
                  k_valid: torch.Tensor, counts=None) -> torch.Tensor:
    """Weighted k-means refinement, two iterations, bit-equal to the host tier.

    palette [B, K, 4] uint8, colors [B, M, 4] uint8, weights [B, M] int32
    (non-negative), k_valid [B] int32 (the real entries of each padded
    palette; rows at or past it take no colour) -> [B, K, 4] uint8. Pad M
    with zero weights freely: a zero-weight colour cannot move a centroid.
    A new entry is floor(sum(colour * weight) / sum(weight)) over the
    colours assigned to it, in int64; an entry with no weight keeps its
    value. ``counts`` sets the kernel's schedule (``ops/kernels.py``); this
    version reads every colour and takes it only to have the same
    arguments."""
    b, k = palette.shape[0], palette.shape[1]
    dev = palette.device
    colors_i = colors.to(torch.int64)
    w = weights.to(torch.int64)
    invalid = torch.arange(k, device=dev)[None, :] >= k_valid.to(dev)[:, None]  # [B, K]
    pal = palette.to(torch.uint8)
    # one segment index space over the batch: entry j of image i is i * K + j
    base = (torch.arange(b, device=dev) * k)[:, None]
    for _ in range(KMEANS_ITERATIONS):
        dist = redmean_dist(colors_i, pal).masked_fill(invalid[:, None, :], INT32_MAX)
        assign = (dist.argmin(dim=-1) + base).reshape(-1)
        sums = torch.zeros((b * k, 4), dtype=torch.int64, device=dev)
        totals = torch.zeros(b * k, dtype=torch.int64, device=dev)
        sums.index_add_(0, assign, (colors_i * w[..., None]).reshape(-1, 4))
        totals.index_add_(0, assign, w.reshape(-1))
        sums, totals = sums.reshape(b, k, 4), totals.reshape(b, k)
        new = torch.where((totals > 0)[..., None],
                          torch.div(sums, totals.clamp(min=1)[..., None], rounding_mode="floor"),
                          pal.to(torch.int64))
        pal = new.to(torch.uint8)
    return pal


def palette_lut(palette: torch.Tensor, k_valid=None) -> torch.Tensor:
    """[B, K, 4] uint8 -> [B, 262144] uint8: each 6-6-6 grid colour's
    nearest entry among the palette's first ``k_valid`` ([B] int32; all K
    without it), chunked over the grid to bound the distance matrix."""
    dev = palette.device
    grid = torch.from_numpy(lut_grid()).to(dev)
    out = torch.empty((palette.shape[0], grid.shape[0]), dtype=torch.uint8, device=dev)
    for i, kv in enumerate(valid_entries(k_valid, *palette.shape[:2])):
        for lo in range(0, grid.shape[0], LUT_CHUNK):
            out[i, lo:lo + LUT_CHUNK] = nearest_palette(grid[lo:lo + LUT_CHUNK],
                                                        palette[i, :kv]).to(torch.uint8)
    return out


def dither_fs(rgba: torch.Tensor, palette: torch.Tensor, lut: torch.Tensor,
              k_valid=None) -> torch.Tensor:
    """Batched FS dithering: [B, H, W, 4] uint8, [B, K, 4] uint8,
    [B, 262144] uint8 -> [B, H, W] uint8 palette indices, bit-equal to the
    host scan.

    The loop runs W + 2(H - 1) wavefront steps; step t handles pixel
    (y, t - 2y) of all rows at once. Each row keeps its last three errors
    (the contributions the row below needs), shifted every step with zeros
    outside the row, which reproduces the host's boundary zeros. A pixel
    whose alpha is not 255 takes the direct redmean over the palette's first
    ``k_valid`` entries ([B] int32; all K without it) with its own alpha
    instead of the LUT."""
    b, h, w = rgba.shape[:3]
    dev = rgba.device
    pal_i = palette.to(torch.int32)
    kv = torch.tensor(valid_entries(k_valid, b, palette.shape[1]), device=dev)
    invalid = torch.arange(palette.shape[1], device=dev)[None, None, :] >= kv[:, None, None]
    ys = torch.arange(h, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    has_alpha = bool((rgba[..., 3] != 255).any())
    # the last three errors of each row, integers in [-255, 255]
    lag1, lag2, lag3 = (torch.zeros((b, h, 3), dtype=torch.int32, device=dev) for _ in range(3))
    out = torch.zeros((b, h, w), dtype=torch.uint8, device=dev)
    zero_row = torch.zeros((b, 1, 3), dtype=torch.int32, device=dev)
    for t in range(w + 2 * (h - 1)):
        x = t - 2 * ys
        active = (x >= 0) & (x < w)
        xc = x.clamp(0, w - 1)
        # the row above, as its last step left it: er(y-1, x+1), er(y-1, x), er(y-1, x-1)
        up1 = torch.cat([zero_row, lag1[:, :-1]], 1)
        up2 = torch.cat([zero_row, lag2[:, :-1]], 1)
        up3 = torch.cat([zero_row, lag3[:, :-1]], 1)
        err16 = 7 * lag1 + up3 + 5 * up2 + 3 * up1
        px = rgba[:, ys, xc].to(torch.int32)  # [B, H, 4]
        # floor(clip(px + err16 / 16, 0, 255)), exact in integers
        ai = torch.div(16 * px[..., :3] + err16, 16, rounding_mode="floor").clamp(0, 255)
        packed = (ai[..., 0] >> 2) << 12 | (ai[..., 1] >> 2) << 6 | (ai[..., 2] >> 2)
        idx = torch.gather(lut, 1, packed.to(torch.int64)).to(torch.int64)  # [B, H]
        if has_alpha:
            a = px[..., 3]
            dist = redmean_dist(torch.cat([ai, a[..., None]], -1), pal_i)
            direct = dist.masked_fill(invalid, INT32_MAX).argmin(dim=-1)
            idx = torch.where(a == 255, idx, direct)
        er = ai - pal_i[rows, idx, :3]
        er = torch.where(active[None, :, None], er, 0)
        out[:, ys[active], x[active]] = idx[:, active].to(torch.uint8)
        lag1, lag2, lag3 = er, lag1, lag2
    return out
