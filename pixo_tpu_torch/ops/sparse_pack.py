"""Per-block coefficient compaction for the JPEG entropy packer: the plain
version.

Counterpart of the JAX package's ``ops/sparse_pack.py`` padded layout. The
dense handoff ships [N, 64] int16 zigzag blocks (128 B/block) to the host;
on typical q85 content fewer than 6 of the 63 AC slots are nonzero. The
device therefore keeps, for every block, its DC, its nonzero-AC count and
its first ``cap`` nonzero (zigzag position, value) pairs, and the native
``jpeg_pack_scan_padded`` packer strides those rows directly.

This plain version uses ``torch.topk`` over a packed key, as the reference
uses ``lax.top_k``. The CUDA kernel (``ops/kernels.py::compact_padded``)
places each block's nonzeros by a prefix sum over its eight lanes instead. The flat layout (``sparsify_blocks``) is
not ported.
"""

from __future__ import annotations

import torch

# Per-block capacity of the default (cheapest) tier; a block with more
# nonzeros trips its image's ``maxcount`` and the caller escalates.
PADDED_CAP_PER_BLOCK = 8
# Escalation ladder: callers re-compact at the smallest tier that holds the
# measured per-block maxcount, and fall back to the dense path above the top
# tier (a cap-48 stream at 3 B/entry already exceeds the 128 B dense block).
PADDED_CAP_TIERS = (8, 16, 32)


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
