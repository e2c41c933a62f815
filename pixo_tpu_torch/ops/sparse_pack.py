"""Coefficient compaction for the JPEG entropy packer: the plain versions.

Counterpart of the JAX package's ``ops/sparse_pack.py``. The
dense handoff ships [N, 64] int16 zigzag blocks (128 B/block) to the host;
on typical q85 content fewer than 6 of the 63 AC slots are nonzero. The
device therefore keeps, for every block, its DC, its nonzero-AC count and
its first ``cap`` nonzero (zigzag position, value) pairs, and the native
``jpeg_pack_scan_padded`` packer strides those rows directly.

This plain version uses ``torch.topk`` over a packed key, as the reference
uses ``lax.top_k``. The CUDA kernel (``ops/kernels.py::compact_padded``)
places each block's nonzeros by a prefix sum over its eight lanes instead.

The flat layout (``sparsify_blocks``) concatenates every block's nonzero ACs
into one stream of ``N * cap_per_block`` slots, packed by the native
``jpeg_pack_scan_sparse``. No entry point takes it; it serves callers that
want the layout, and ``padded_to_flat`` turns the padded rows into it. The
JAX package computes it as plain jit code outside any Pallas kernel; here it
is plain PyTorch on the tensor's device: a cumsum, then a scatter into
``cap + 1`` slots with the overflow slot cut off.
"""

from __future__ import annotations

import numpy as np
import torch

# Per-block capacity of the flat layout: its streams hold N * 8 entries.
DEFAULT_CAP_PER_BLOCK = 8

# Per-block capacity of the default (cheapest) tier; a block with more
# nonzeros trips its image's ``maxcount`` and the caller escalates.
PADDED_CAP_PER_BLOCK = 8
# Escalation ladder: callers re-compact at the smallest tier that holds the
# measured per-block maxcount, and fall back to the dense path above the top
# tier (a cap-48 stream at 3 B/entry already exceeds the 128 B dense block).
PADDED_CAP_TIERS = (8, 16, 32)
PADDED_CAP_MAX = PADDED_CAP_TIERS[-1]


def sparsify_blocks(zz: torch.Tensor, cap_per_block: int = DEFAULT_CAP_PER_BLOCK):
    """[N, 64] int16 zigzag blocks -> (dc [N] int16, counts [N] uint8,
    poss [cap] uint8, vals [cap] int16, total int32), ``cap`` being
    ``N * cap_per_block``.

    ``poss``/``vals`` hold every block's nonzero ACs in block order; entries
    past ``total`` are padding (zeros). If ``total`` > ``cap`` the streams
    are incomplete and the caller must use the dense path.
    """
    return tuple(t[0] for t in sparsify_blocks_batch(zz[None], cap_per_block))


def sparsify_blocks_batch(zz: torch.Tensor, cap_per_block: int = DEFAULT_CAP_PER_BLOCK):
    """[B, N, 64] int16 -> each image's flat streams: dc [B, N], counts
    [B, N], poss and vals [B, N * cap_per_block], total [B] int32."""
    b, n = zz.shape[0], zz.shape[1]
    cap = n * cap_per_block
    ac = zz[..., 1:].reshape(b, n * 63)
    nz = ac != 0
    counts = nz.reshape(b, n, 63).sum(dim=-1, dtype=torch.int32)
    # each nonzero's slot in its image's stream; zeros and overflow spill
    # into a discarded slot at index ``cap``
    idx = torch.cumsum(nz, dim=-1) - 1
    dest = torch.where(nz, idx.clamp(max=cap), torch.full_like(idx, cap))
    pos = torch.arange(1, 64, dtype=torch.uint8, device=zz.device).repeat(n).expand(b, -1)
    vals = torch.zeros((b, cap + 1), dtype=torch.int16, device=zz.device).scatter_(1, dest, ac)
    poss = torch.zeros((b, cap + 1), dtype=torch.uint8, device=zz.device).scatter_(1, dest, pos)
    return (zz[..., 0].contiguous(), counts.to(torch.uint8), poss[:, :cap], vals[:, :cap],
            counts.sum(dim=-1, dtype=torch.int32))


def padded_to_flat(counts: np.ndarray, poss: np.ndarray, vals: np.ndarray):
    """The padded [N, cap] rows -> the flat streams ``jpeg_pack_scan_sparse``
    reads (``sparsify_blocks``' streams up to ``total``), on the host:
    numpy boolean indexing of the rows by ``counts``."""
    mask = np.arange(poss.shape[1], dtype=np.int64)[None, :] < counts.astype(np.int64)[:, None]
    return poss[mask], vals[mask]


def sparsify_blocks_padded(zz: torch.Tensor, cap_per_block: int = PADDED_CAP_PER_BLOCK):
    """[N, 64] int16 -> per-block padded streams.

    Returns (dc [N] int16, counts [N] uint8, poss [N, cap] uint8,
    vals [N, cap] int16, total int32, maxcount int32). Absent slots hold 0.
    ``maxcount`` > ``cap_per_block`` means some block overflowed its slots
    and the padded arrays are incomplete: callers must escalate or use the
    dense path.
    """
    out = sparsify_blocks_padded_batch(zz[None], cap_per_block)
    return tuple(t[0] for t in out)


def sparsify_blocks_padded_batch(zz: torch.Tensor, cap_per_block: int = PADDED_CAP_PER_BLOCK):
    """[B, N, 64] int16 -> the padded streams of each image, with ``total``
    and ``maxcount`` [B] int32 per image.

    For each block, the first ``cap_per_block`` nonzero (position, value)
    pairs in zigzag order are found with one ``topk`` over a packed
    (64 - pos) << 16 | value key: positions are unique per block so the key
    order is total, and absent lanes pack to 0 and sort last.
    """
    ac = zz[..., 1:].to(torch.int32)  # [B, N, 63]
    nz = ac != 0
    pos = torch.arange(1, 64, dtype=torch.int32, device=zz.device)
    key = torch.where(nz, 64 - pos, torch.zeros_like(ac))
    packed = (key << 16) | (ac & 0xFFFF)
    top = torch.topk(packed, cap_per_block, dim=-1, largest=True, sorted=True).values
    keyk = top >> 16
    vals = (((top & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)  # sign-extend
    poss = torch.where(keyk > 0, 64 - keyk, torch.zeros_like(keyk)).to(torch.uint8)
    counts32 = nz.sum(dim=-1, dtype=torch.int32)
    return (
        zz[..., 0].contiguous(),
        counts32.to(torch.uint8),
        poss,
        vals,
        counts32.sum(dim=-1, dtype=torch.int32),
        counts32.amax(dim=-1),
    )
