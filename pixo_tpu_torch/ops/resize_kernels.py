"""Resize on tensors: nearest, bilinear and Lanczos3.

Counterpart of the JAX package's ``ops/resize_kernels.py``; behavioral parity
with pixo ``src/resize.rs:298-560``:
  - nearest: src = round((dst+0.5)*ratio - 0.5) clamped (``:298-330``),
  - bilinear: align-corners ratios (src-1)/(dst-1), single f32 lerp pass,
    round-half-away + clamp (``:333-390``),
  - Lanczos3: separable horizontal-then-vertical with per-destination
    normalized windows, filter support scaled by max(scale, 1), and the
    reference's *intermediate u8 rounding* between the two passes
    (``:393-560``).

Lanczos3 is a serial f32 accumulation of each window's taps in index order:
a matrix product with the dense weight matrix would sum in another order and
change bytes. On a CUDA tensor the two passes are the hand-written kernel of
``csrc/resize.cu`` (``ops/kernels.py::resize_lanczos3``); on a CPU tensor they
are ``_lanczos_pass``, the kernel's plain version. Nearest and bilinear are
plain PyTorch on either device (index gathers and one lerp).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .quantize import round_half_away


def _nearest_indices(src: int, dst: int) -> np.ndarray:
    ratio = src / dst
    centers = (np.arange(dst, dtype=np.float32) + 0.5) * ratio - 0.5
    # f32::round = half away from zero; centers >= -0.5 so floor(x+0.5) works
    idx = np.floor(centers + 0.5).astype(np.int64)
    return np.clip(idx, 0, src - 1)


def resize_nearest(img: torch.Tensor, *, dst_w: int, dst_h: int) -> torch.Tensor:
    """[H, W, C] uint8 -> [dst_h, dst_w, C] uint8 (pure gather)."""
    h, w = img.shape[0], img.shape[1]
    ys = torch.from_numpy(_nearest_indices(h, dst_h)).to(img.device)
    xs = torch.from_numpy(_nearest_indices(w, dst_w)).to(img.device)
    return img[ys][:, xs]


def resize_bilinear(img: torch.Tensor, *, dst_w: int, dst_h: int) -> torch.Tensor:
    """[H, W, C] uint8 -> [dst_h, dst_w, C] uint8 via one lerp pass."""
    h, w = img.shape[0], img.shape[1]
    dev = img.device
    y_ratio = (h - 1) / (dst_h - 1) if dst_h > 1 else 0.0
    x_ratio = (w - 1) / (dst_w - 1) if dst_w > 1 else 0.0

    # the ratio rounds to f32 before the multiply, as the reference's does
    yf = torch.arange(dst_h, dtype=torch.float32, device=dev) * float(np.float32(y_ratio))
    xf = torch.arange(dst_w, dtype=torch.float32, device=dev) * float(np.float32(x_ratio))
    y0 = torch.floor(yf).to(torch.int64)
    x0 = torch.floor(xf).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    fy = (yf - y0.to(torch.float32))[:, None, None]
    fx = (xf - x0.to(torch.float32))[None, :, None]

    f = img.to(torch.float32)
    p00 = f[y0][:, x0]
    p01 = f[y0][:, x1]
    p10 = f[y1][:, x0]
    p11 = f[y1][:, x1]
    top = p00 * (1.0 - fx) + p01 * fx
    bottom = p10 * (1.0 - fx) + p11 * fx
    value = top * (1.0 - fy) + bottom * fy
    return torch.clamp(round_half_away(value), 0.0, 255.0).to(torch.uint8)


def _lanczos_kernel_f32(x: np.float32, a: np.float32) -> np.float32:
    """One kernel tap, every op rounded to f32 in the reference's exact
    order (resize.rs:391-403)."""
    f32 = np.float32
    ax = abs(x)
    if ax < np.finfo(np.float32).eps:
        return f32(1.0)
    if ax >= a:
        return f32(0.0)
    pi = f32(math.pi)
    px = f32(pi * x)
    pxa = f32(px / a)
    return f32(
        f32(f32(a * np.sin(px, dtype=np.float32)) * np.sin(pxa, dtype=np.float32))
        / f32(px * pxa)
    )


@functools.lru_cache(maxsize=256)
def lanczos_taps(src: int, dst: int, a: float = 3.0):
    """Per-destination Lanczos windows in tap form, computed on the host in
    numpy f32 scalars (cached: the scalar-order weight computation is a
    Python loop that costs more than the resize itself).

    Returns (starts [dst] int32, weights [dst, K] f32) with windows
    right-padded by zero weights: an EXACT no-op during the serial f32
    accumulation (adding f32(px * 0.0) == +0.0 never rounds). The f32
    op order of the weight computation and normalization mirrors
    resize.rs:414-456 and decides the output's bytes.
    """
    f32 = np.float32
    scale = f32(src) / f32(dst)
    filter_scale = max(scale, f32(1.0))
    support = f32(f32(a) * filter_scale)
    eps = np.finfo(np.float32).eps
    starts, windows = [], []
    for d in range(dst):
        center = f32(f32(f32(d) + f32(0.5)) * scale - f32(0.5))
        start = max(int(np.floor(f32(center - support))), 0)
        end = min(int(np.ceil(f32(center + support))) + 1, src)
        ws = []
        wsum = f32(0.0)
        for s in range(start, end):
            x = f32(f32(f32(s) - center) / filter_scale)
            wv = _lanczos_kernel_f32(x, f32(a))
            ws.append(wv)
            wsum = f32(wsum + wv)
        if abs(wsum) > eps:
            ws = [f32(w_ / wsum) for w_ in ws]
        starts.append(start)
        windows.append(ws)
    k = max(len(w) for w in windows)
    weights = np.zeros((dst, k), np.float32)
    for d, ws in enumerate(windows):
        weights[d, : len(ws)] = ws
    return np.asarray(starts, np.int32), weights


def pad_taps(weights: torch.Tensor) -> torch.Tensor:
    """[dst, K] weights -> [dst, K rounded up to a multiple of 4], zero
    weights appended (as ``lanczos_taps`` pads its windows: each adds +0.0,
    which changes no sum), in a new tensor: the tap loop of
    ``csrc/resize.cu`` goes in fours."""
    dst, k = weights.shape
    padded = torch.zeros((dst, -(-k // 4) * 4), dtype=weights.dtype, device=weights.device)
    padded[:, :k] = weights
    return padded


@functools.lru_cache(maxsize=256)
def _taps_on(src: int, dst: int, device: torch.device):
    """``lanczos_taps(src, dst)`` as tensors on ``device``, copied there once,
    the weights padded by ``pad_taps``."""
    starts, weights = lanczos_taps(src, dst)
    return torch.from_numpy(starts).to(device), pad_taps(torch.from_numpy(weights)).to(device)


def _lanczos_pass(imgs: torch.Tensor, starts: torch.Tensor, weights: torch.Tensor,
                  axis: int) -> torch.Tensor:
    """One separable pass along ``axis`` (1, the rows, or 2, the columns) of
    [B, H, W, C] uint8 -> the same with that axis ``dst`` long.

    The tap loop is a Python loop of eager operations (a gather, one
    multiply, one add, each its own call), so the f32 accumulator rounds
    after every multiply and every add in the reference's exact serial
    order (resize.rs:459-513) and nothing is contracted into an FMA.
    Right-padded zero-weight taps are exact no-ops (+0.0 cannot change an
    f32 sum)."""
    s_dim = imgs.shape[axis]
    dst, k = weights.shape
    f = imgs.to(torch.float32)
    starts = starts.to(torch.int64)
    wshape = [1, 1, 1, 1]
    wshape[axis] = dst
    shape = list(f.shape)
    shape[axis] = dst
    acc = torch.zeros(shape, dtype=torch.float32, device=imgs.device)
    for i in range(k):
        idx = torch.clamp(starts + i, 0, s_dim - 1)
        px = torch.index_select(f, axis, idx)
        acc = acc + px * weights[:, i].reshape(wshape)
    return torch.clamp(round_half_away(acc), 0.0, 255.0).to(torch.uint8)


def resize_lanczos3_batch(imgs: torch.Tensor, *, dst_w: int, dst_h: int) -> torch.Tensor:
    """[B, H, W, C] uint8 -> [B, dst_h, dst_w, C] uint8 on ``imgs``' device:
    a whole same-shape group in one call (the kernel on a card, its plain
    version on the CPU), bit-identical to the per-image path."""
    from .kernels import resize_lanczos3 as kernel  # kernels.py imports this module

    h, w = imgs.shape[1], imgs.shape[2]
    sx, wx = _taps_on(w, dst_w, imgs.device)
    sy, wy = _taps_on(h, dst_h, imgs.device)
    return kernel(imgs, sx, wx, sy, wy)


def resize_lanczos3(img: torch.Tensor, *, dst_w: int, dst_h: int) -> torch.Tensor:
    """[H, W, C] uint8 -> [dst_h, dst_w, C] uint8, horizontal then vertical
    pass with the reference's intermediate u8 round/clamp: byte-identical
    to pixo."""
    return resize_lanczos3_batch(img[None], dst_w=dst_w, dst_h=dst_h)[0]


def resize_lanczos3_np(img: np.ndarray, *, dst_w: int, dst_h: int) -> np.ndarray:
    """NumPy mirror of the serial-f32 Lanczos pass pair (the oracle of the
    native host tier and of the plain PyTorch version).

    NumPy never fuses, so a per-tap loop of (acc + px*w) reproduces the
    reference's serial rounding exactly: this is the authoritative order.
    """

    def round_half_away_np(x: np.ndarray) -> np.ndarray:
        t = np.trunc(x)
        frac = (x - t).astype(x.dtype)
        half_up = np.where(x >= 0, t + 1.0, t - 1.0).astype(x.dtype)
        return np.where(np.abs(frac) == 0.5, half_up, np.round(x))

    def vpass(sp: np.ndarray, starts, weights):
        s_dim = sp.shape[0]
        dst, k = weights.shape
        acc = np.zeros((dst,) + sp.shape[1:], np.float32)
        f = sp.astype(np.float32)
        for i in range(k):
            idx = np.clip(starts + i, 0, s_dim - 1)
            acc = acc + f[idx] * weights[:, i][:, None, None]
        return np.clip(round_half_away_np(acc), 0.0, 255.0).astype(np.uint8)

    h, w = img.shape[0], img.shape[1]
    sx, wx = lanczos_taps(w, dst_w)
    sy, wy = lanczos_taps(h, dst_h)
    t = vpass(img.transpose(1, 0, 2), sx, wx)
    return vpass(t.transpose(1, 0, 2), sy, wy)
