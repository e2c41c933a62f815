"""Deterministic synthetic image generators.

Parity with the reference's fixture generators (tests/support/synthetic.rs):
solid, gradients, checkerboard, noise, text-like — reproducible regression
inputs for tests and benchmarks.
"""

from __future__ import annotations

import numpy as np


def synth_solid(h: int, w: int, channels: int = 3, value: int = 128) -> np.ndarray:
    return np.full((h, w, channels), value, np.uint8)


def synth_gradient(h: int, w: int, channels: int = 3) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    chans = [
        (xx * 255 // max(w - 1, 1)),
        (yy * 255 // max(h - 1, 1)),
        ((xx + yy) * 255 // max(w + h - 2, 1)),
        np.full((h, w), 255),
    ]
    return np.stack(chans[:channels], axis=-1).astype(np.uint8)


def synth_checkerboard(h: int, w: int, channels: int = 3, cell: int = 8) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    base = (((yy // cell) + (xx // cell)) % 2 * 255).astype(np.uint8)
    return np.repeat(base[..., None], channels, axis=-1)


def synth_noise(h: int, w: int, channels: int = 3, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, channels), dtype=np.uint8)


def synth_text_like(h: int, w: int, channels: int = 3, seed: int = 3) -> np.ndarray:
    """Sparse dark strokes on white: screenshot/text-like content."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 255, np.int32)
    for _ in range(max(h * w // 200, 4)):
        y = int(rng.integers(0, h))
        x = int(rng.integers(0, w))
        ln = int(rng.integers(2, 12))
        if rng.integers(0, 2):
            img[y, x : min(x + ln, w)] = int(rng.integers(0, 80))
        else:
            img[y : min(y + ln, h), x] = int(rng.integers(0, 80))
    return np.repeat(img.astype(np.uint8)[..., None], channels, axis=-1)
