"""Lanczos3 resize with pixo's rounding (``src/resize.rs``), plain.

The taps are computed once a shape in NumPy float32 scalars, each operation
rounded in pixo's order; the windows are normalised by their sum and padded
with zero weights, which add +0.0 and change no sum. The two passes
(horizontal, then vertical, with the intermediate rounded half away from
zero and clamped to u8) accumulate every window serially in float32 on
torch tensors, an eager multiply and add a tap.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .jpeg_encode import Rounding, _keep, round_half_away


def _kernel(x, a):
    f32 = np.float32
    ax = abs(x)
    if ax < np.finfo(np.float32).eps:
        return f32(1.0)
    if ax >= a:
        return f32(0.0)
    px = f32(f32(math.pi) * x)
    pxa = f32(px / a)
    return f32(f32(f32(a * np.sin(px, dtype=np.float32)) * np.sin(pxa, dtype=np.float32))
               / f32(px * pxa))


@functools.lru_cache(maxsize=64)
def taps(src: int, dst: int, a: float = 3.0):
    """(starts [dst] int64, weights [dst, K] float32) of every output
    position's window."""
    f32 = np.float32
    scale = f32(src) / f32(dst)
    filter_scale = max(scale, f32(1.0))
    support = f32(f32(a) * filter_scale)
    starts, windows = [], []
    for d in range(dst):
        center = f32(f32(f32(d) + f32(0.5)) * scale - f32(0.5))
        lo = max(int(np.floor(f32(center - support))), 0)
        hi = min(int(np.ceil(f32(center + support))) + 1, src)
        ws, total = [], f32(0.0)
        for s in range(lo, hi):
            w = _kernel(f32(f32(f32(s) - center) / filter_scale), f32(a))
            ws.append(w)
            total = f32(total + w)
        if abs(total) > np.finfo(np.float32).eps:
            ws = [f32(w / total) for w in ws]
        starts.append(lo)
        windows.append(ws)
    weights = np.zeros((dst, max(len(w) for w in windows)), np.float32)
    for d, ws in enumerate(windows):
        weights[d, : len(ws)] = ws
    return np.asarray(starts, np.int64), weights


def _pass(imgs: torch.Tensor, axis: int, dst: int, r) -> torch.Tensor:
    n = imgs.shape[axis]
    starts, weights = taps(n, dst)
    starts = torch.from_numpy(starts).to(imgs.device)
    weights = torch.from_numpy(weights).to(imgs.device)
    f = imgs.to(torch.float32)
    shape = [1] * imgs.dim()
    shape[axis] = dst
    out_shape = list(f.shape)
    out_shape[axis] = dst
    acc = torch.zeros(out_shape, dtype=torch.float32, device=imgs.device)
    for i in range(weights.shape[1]):
        px = torch.index_select(f, axis, torch.clamp(starts + i, 0, n - 1))
        acc = r(acc + r(px * weights[:, i].reshape(shape)))
    return torch.clamp(round_half_away(acc), 0.0, 255.0).to(torch.uint8)


def lanczos3(imgs: torch.Tensor, dst_w: int, dst_h: int, rnd: Rounding = None) -> torch.Tensor:
    """[B, H, W, C] uint8 -> [B, dst_h, dst_w, C] uint8: the horizontal
    pass, then the vertical one."""
    r = _keep(rnd)
    return _pass(_pass(imgs, 2, dst_w, r), 1, dst_h, r)
