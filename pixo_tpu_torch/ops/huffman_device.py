"""JPEG symbol histograms for optimized Huffman tables: the plain version.

Counterpart of the JAX package's ``ops/huffman_device.py`` (its jit body
``_count_device``). From the zigzag coefficient blocks of a baseline scan it
counts the DC size categories (per-component differences, the predictor
reset at each restart boundary) and the AC run/size symbols with their ZRL
splits and end-of-block, as the host counter does (``jpeg/packer.py
count_symbols`` and the native ``jpeg_count_symbols``).

The serial-looking parts are gathers and scans: the DC predictor of a block
is the DC of the previous block of the same component in the same restart
segment, a function of the scan pattern and the restart interval only
(``_prev_block_index``); a block's zero runs come from a cumulative max of
its nonzero positions. Building the tables from the counts stays on the
host: it is O(alphabet), once an image.

On the card the count is the hand-written kernel ``csrc/huffman.cu``
(``ops/kernels.py::count_symbols``), which computes the predictor index from
the pattern itself. This plain version serves CPU tensors and the tests.

A DC difference past category 11 (out of a baseline scan's range) counts in
no bin, as the reference's scatter drops it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _prev_block_index(
    n: int, pattern: Tuple[int, ...], restart_interval: Optional[int]
) -> np.ndarray:
    """For each block in scan order: index of the previous block of the
    same component within the same restart segment, or -1.

    Static per (n, pattern, restart_interval): the DC predictor chain
    depends only on the scan structure, never on coefficient values.
    """
    bpm = len(pattern)
    comp = np.tile(np.asarray(pattern, np.int64), n // bpm)
    mcu = np.arange(n) // bpm
    seg = mcu // restart_interval if restart_interval else np.zeros(n, np.int64)
    prev_idx = np.full(n, -1, np.int64)
    for c in set(pattern):
        idxs = np.flatnonzero(comp == c)
        prev = np.concatenate(([-1], idxs[:-1]))
        ok = (prev >= 0) & (seg[idxs] == seg[np.maximum(prev, 0)])
        prev_idx[idxs] = np.where(ok, prev, -1)
    return prev_idx


def _category(v: torch.Tensor) -> torch.Tensor:
    """JPEG size category = bit length of |v| (0 for 0), as integer
    compares (no float log2: it must be exact at powers of two)."""
    av = v.to(torch.int32).abs()
    cat = torch.zeros_like(av)
    for k in range(16):
        cat += (av >= (1 << k)).to(torch.int32)
    return cat


def count_symbols_plain(
    zz: torch.Tensor, pattern: Sequence[int], restart_interval: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, N, 64] int16 zigzag blocks in scan order -> (dc [B, 2, 12],
    ac [B, 2, 256]) int64 symbol counts of each image, table class 0 for
    component 0 and 1 for the others, on ``zz``'s device."""
    b, n = zz.shape[0], zz.shape[1]
    dev = zz.device
    pattern = tuple(int(c) for c in pattern)
    prev_idx = torch.from_numpy(_prev_block_index(n, pattern, restart_interval)).to(dev)
    comp = torch.tensor(pattern, dtype=torch.int64, device=dev).repeat(n // len(pattern))
    tclass = (comp != 0).to(torch.int64)  # [N]

    dc = zz[..., 0].to(torch.int32)  # [B, N]
    prev = torch.where(prev_idx >= 0, dc[:, prev_idx.clamp(min=0)], torch.zeros_like(dc))
    dccat = _category(dc - prev).to(torch.int64)
    keep = (dccat < 12).to(torch.int64)
    dc_hist = torch.zeros((b, 24), dtype=torch.int64, device=dev)
    dc_hist.scatter_add_(1, (tclass * 12 + dccat.clamp(max=11)).expand(b, n).contiguous(), keep)

    v = zz[..., 1:].to(torch.int32)  # [B, N, 63]
    nz = v != 0
    pos = torch.arange(1, 64, dtype=torch.int32, device=dev)
    # last nonzero position at or before each slot (0 = none yet)
    lastnz = torch.cummax(torch.where(nz, pos, torch.zeros_like(v)), dim=-1).values
    prevlast = torch.cat([torch.zeros_like(lastnz[..., :1]), lastnz[..., :-1]], dim=-1)
    run = pos - prevlast - 1  # zeros since the previous nonzero
    rs = (((run % 16) << 4) | _category(v)).to(torch.int64)
    nz64 = nz.to(torch.int64)
    base = (tclass * 256)[None, :, None]  # [1, N, 1]
    ac_hist = torch.zeros((b, 512), dtype=torch.int64, device=dev)
    ac_hist.scatter_add_(1, (base + rs).reshape(b, -1), nz64.reshape(b, -1))  # run/size
    ac_hist.scatter_add_(1, (base + 0xF0).expand(b, n, 63).reshape(b, -1),
                         ((run // 16).to(torch.int64) * nz64).reshape(b, -1))  # ZRL splits
    eob = (lastnz[..., -1] < 63).to(torch.int64)  # [B, N], the all-zero block too
    ac_hist.scatter_add_(1, (tclass * 256).expand(b, n).contiguous(), eob)
    return dc_hist.view(b, 2, 12), ac_hist.view(b, 2, 256)


def count_symbols(
    zz, pattern: Sequence[int], restart_interval: Optional[int] = None, *, device="cuda"
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Histogram of the DC/AC symbols of one image's [N, 64] int16 zigzag
    blocks (numpy or tensor), counted on ``device``: the kernel on a CUDA
    device, the default (as the JAX package's ``count_symbols_device`` runs
    on its default device), the plain version with ``device="cpu"``.
    Returns (dc_lum [12], dc_chrom [12], ac_lum [256], ac_chrom [256]) as
    int64 numpy arrays, equal to ``jpeg/packer.py::count_symbols``."""
    from .kernels import count_symbols as count_kernel

    zz = torch.as_tensor(np.ascontiguousarray(zz) if isinstance(zz, np.ndarray) else zz)
    dc, ac = count_kernel(zz.to(device).contiguous()[None], pattern, restart_interval)
    dc, ac = dc[0].cpu().numpy(), ac[0].cpu().numpy()
    return dc[0], dc[1], ac[0], ac[1]
