"""Batched forward 8x8 AAN DCT on tensors: the plain version.

Counterpart of the JAX package's ``ops/dct.py::dct8x8_aan``. It reproduces
the reference's float AAN algorithm (pixo ``src/jpeg/dct.rs:588-700``: rows
then columns, 5 multiplies and 29 adds per 1-D pass, post-scale ``S[k]``)
with the *same f32 operation order*, so quantized coefficients are
bit-identical to the reference encoder's.

Exactness: every multiply and add is its own eager tensor op, so nothing is
contracted into a fused multiply-add. Do not rewrite a step with ``addcmul``
or another fused op: one rounding fewer changes the bytes. The CUDA kernel
(``csrc/aan.cuh``) keeps the same order with ``__fmul_rn``/``__fadd_rn``.

``dct8x8_matmul`` and ``idct8x8`` are the DCT and its inverse as two
products with the orthonormal matrix ``DCT_MATRIX``, in float32: fast but
not bit-exact, as in the JAX package, whose encode and decode use neither.
"""

from __future__ import annotations

import math

import numpy as np
import torch

FRAC_1_SQRT_2 = np.float32(0.70710678118654752440)

A1 = np.float32(FRAC_1_SQRT_2)
A2 = np.float32(0.5411961)
A3 = np.float32(FRAC_1_SQRT_2)
A4 = np.float32(1.3065629)
A5 = np.float32(0.38268343)

S = np.array(
    [0.3535534, 0.2548978, 0.2705981, 0.3006724,
     0.3535534, 0.4499881, 0.6532815, 1.2814578],
    dtype=np.float32,
)

# f32 values as Python floats: a float32 tensor times a Python float computes
# in float32 with the scalar rounded to float32, which these are exactly.
_A1, _A2, _A3, _A4, _A5 = (float(a) for a in (A1, A2, A3, A4, A5))
_S = [float(s) for s in S]


def _aan_1d(cols):
    """One AAN 1-D DCT pass over a list of eight same-shaped f32 tensors.

    Exact operation order of the reference's ``aan_dct_1d``.
    """
    d0, d1, d2, d3, d4, d5, d6, d7 = cols

    tmp0 = d0 + d7
    tmp7 = d0 - d7
    tmp1 = d1 + d6
    tmp6 = d1 - d6
    tmp2 = d2 + d5
    tmp5 = d2 - d5
    tmp3 = d3 + d4
    tmp4 = d3 - d4

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    o0 = tmp10 + tmp11
    o4 = tmp10 - tmp11

    z1 = (tmp12 + tmp13) * _A1
    o2 = tmp13 + z1
    o6 = tmp13 - z1

    t10 = tmp4 + tmp5
    t11 = tmp5 + tmp6
    t12 = tmp6 + tmp7

    z5 = (t10 - t12) * _A5
    z2 = t10 * _A2 + z5
    z4 = t12 * _A4 + z5
    z3 = t11 * _A3

    z11 = tmp7 + z3
    z13 = tmp7 - z3

    o5 = z13 + z2
    o3 = z13 - z2
    o1 = z11 + z4
    o7 = z11 - z4

    out = [o0, o1, o2, o3, o4, o5, o6, o7]
    return [out[i] * _S[i] for i in range(8)]


def dct8x8_aan(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2-D DCT over [..., 8, 8] f32 blocks, exact AAN semantics.

    Rows pass first, then columns (``dct_2d``, ``src/jpeg/dct.rs:614-640``).
    """
    x = blocks.to(torch.float32)
    rows_done = _aan_1d([x[..., i] for i in range(8)])
    t = torch.stack(rows_done, dim=-1)  # [..., 8(row), 8(col)]
    cols_done = _aan_1d([t[..., i, :] for i in range(8)])
    return torch.stack(cols_done, dim=-2)


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix (f32)."""
    m = np.zeros((8, 8), dtype=np.float64)
    for k in range(8):
        ck = math.sqrt(0.25) if k else math.sqrt(0.125)
        for n in range(8):
            m[k, n] = ck * math.cos((2 * n + 1) * k * math.pi / 16.0)
    return m.astype(np.float32)


DCT_MATRIX = _dct_matrix()


def dct8x8_matmul(blocks: torch.Tensor) -> torch.Tensor:
    """2-D DCT of [..., 8, 8] blocks as two f32 products: D @ X @ D^T."""
    d = torch.from_numpy(DCT_MATRIX).to(blocks.device)
    return d @ blocks.to(torch.float32) @ d.T


def idct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT of [..., 8, 8] blocks as two f32 products:
    D^T @ X @ D (``DCT_MATRIX`` is orthonormal)."""
    d = torch.from_numpy(DCT_MATRIX).to(blocks.device)
    return d.T @ blocks.to(torch.float32) @ d
