"""Quantization + zigzag on tensors: the plain version.

Counterpart of the JAX package's ``ops/quantize.py``. ``quantize_block``
divides by the f32 table and rounds half away from zero, Rust's
``f32::round`` (pixo ``src/jpeg/quantize.rs:99-105``). ``torch.round`` rounds
half to even, so exact halves are fixed up. Zigzag is a fixed gather
(``src/jpeg/quantize.rs:107-113``).
"""

from __future__ import annotations

import torch

from ..jpeg.tables import ZIGZAG


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust f32::round semantics: round half away from zero, elementwise."""
    t = torch.trunc(x)
    frac = x - t  # exact in f32 for |x| < 2^24
    half_up = torch.where(x >= 0, t + 1.0, t - 1.0)
    nearest = torch.round(x)  # half-to-even; equals target except at exact .5
    return torch.where(frac.abs() == 0.5, half_up, nearest)


def quantize_blocks(dct: torch.Tensor, qtable: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] f32 DCT / broadcastable f32 table -> int16 (natural order)."""
    return round_half_away(dct / qtable).to(torch.int16)


def zigzag_blocks(coeffs: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] or [..., 64] -> [..., 64] zigzag-ordered."""
    if coeffs.shape[-1] == 8:
        coeffs = coeffs.reshape(coeffs.shape[:-2] + (64,))
    index = torch.as_tensor(ZIGZAG, dtype=torch.long, device=coeffs.device)
    return coeffs.index_select(-1, index)
