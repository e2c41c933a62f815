"""Device PNG unfilter: the reconstruction of filtered PNG rows.

Counterpart of the JAX package's ``ops/png_unfilter.py``, with the same
names. Reconstruction is sequential in x (Sub, Average and Paeth read the
byte ``bpp`` to the left) and in y (Up, Average and Paeth read the row
above), but the dependency cone (y, x - bpp), (y - 1, x), (y - 1, x - bpp)
admits an anti-diagonal wavefront: with each row skewed one step behind the
row above, step t reconstructs byte (y, t - y) of every row at once, in
``RB + H - 1`` steps. All arithmetic is the bytes' mod-256 sums in int32,
so the result equals the host library's serial ``png_unfilter``.

``unfilter_device_batch`` takes its plain PyTorch version
(``unfilter_plain``, the wavefront as a loop of tensor steps, which follows
the JAX function's algebra) for the CPU, and on a card launches the kernel
of ``csrc/unfilter.cu`` (a thread a row, a CTA an image, bands of up to
1024 rows in turn) or raises; it never falls back. It counts its launches in
``unfilter_device_batch.launches``. As in the JAX package, no path calls it:
the PNG decode reconstructs its rows with the host library.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import _check, _device_guard, _stream, count_launch, load

__all__ = ["unfilter_device", "unfilter_device_batch", "unfilter_plain"]

UNFILTER_BAND = 1024  # csrc/unfilter.cu's kUnfilterBand: the rows a CTA reconstructs at once
UNFILTER_MAX_ROW = 0x7FFFFFFF - 2 * UNFILTER_BAND  # its rows' bytes and steps are int


def unfilter_plain(rows: torch.Tensor, filters: torch.Tensor, bpp: int) -> torch.Tensor:
    """``unfilter_device_batch`` in plain PyTorch on ``rows``' device: the
    wavefront of the JAX package's ``lax.scan``, one step a loop iteration
    over every row of the batch, each row carrying its last ``bpp + 1``
    outputs. Filter ids outside 0-4 take no predictor, as there."""
    b, h, rb = rows.shape
    dev = rows.device
    if rows.numel() == 0:
        return torch.zeros((b, h, rb), dtype=torch.uint8, device=dev)
    steps = rb + h - 1
    ys = torch.arange(h, device=dev)
    cols = (ys[:, None] + torch.arange(rb, device=dev)[None, :]).expand(b, h, rb)
    skewed = torch.zeros((b, h, steps), dtype=torch.int32, device=dev)
    skewed.scatter_(2, cols, rows.to(torch.int32))  # skewed[b, y, y + x] = rows[b, y, x]
    f = filters.to(torch.int32)
    k = bpp + 1
    # lags[..., -1] = out(y, x - 1), lags[..., -j] = out(y, x - j)
    lags = torch.zeros((b, h, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, h, steps), dtype=torch.int32, device=dev)
    up_ok = (ys > 0)[None, :]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(steps):
        x = t - ys
        left_ok = (x >= bpp)[None, :]
        up = torch.cat([torch.zeros_like(lags[:, :1]), lags[:, :-1]], dim=1)  # the row above's lags
        a = torch.where(left_ok, lags[:, :, k - bpp], zero)  # out(y, x - bpp)
        bb = torch.where(up_ok, up[:, :, k - 1], zero)  # out(y - 1, x)
        c = torch.where(left_ok & up_ok, up[:, :, 0], zero)  # out(y - 1, x - bpp)
        p = a + bb - c
        pa, pb, pc = (p - a).abs(), (p - bb).abs(), (p - c).abs()
        paeth = torch.where((pa <= pb) & (pa <= pc), a, torch.where(pb <= pc, bb, c))
        pred = torch.where(f == 1, a, torch.where(f == 2, bb, torch.where(
            f == 3, (a + bb) >> 1, torch.where(f == 4, paeth, zero))))
        active = ((x >= 0) & (x < rb))[None, :]
        val = torch.where(active, (skewed[:, :, t] + pred) & 0xFF, zero)
        vals[:, :, t] = val
        lags = torch.cat([lags[:, :, 1:], val[:, :, None]], dim=2)
    return vals.gather(2, cols).to(torch.uint8)


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.require(x, requirements="W"))


def _inputs(rows, filters, bpp: int, device):
    """(rows, filters) as contiguous tensors on ``device``: [B, H, RB] uint8
    (a tensor already there, at any byte offset, is taken as it is) and
    [B, H] int32."""
    if not 1 <= bpp <= 8:
        raise ValueError(f"bpp must be 1 to 8, got {bpp}")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    rows = _tensor(rows).to(dev)
    if rows.dtype != torch.uint8 or rows.dim() != 3:
        raise ValueError(f"rows must be [B, H, RB] uint8, got {tuple(rows.shape)} {rows.dtype}")
    filters = _tensor(filters)
    if filters.is_floating_point() or filters.is_complex() or tuple(filters.shape) != tuple(rows.shape[:2]):
        raise ValueError(f"filters must be [{rows.shape[0]}, {rows.shape[1]}] integer ids, got "
                         f"{tuple(filters.shape)} {filters.dtype}")
    return rows.contiguous(), filters.to(device=dev, dtype=torch.int32).contiguous()


def unfilter_device_batch(rows, filters, *, bpp: int, device="cuda") -> torch.Tensor:
    """[B, H, RB] uint8 filtered rows (numpy or tensor) + [B, H] filter ids
    (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth; others take no predictor) ->
    [B, H, RB] uint8 reconstructed rows on ``device`` ("cpu" or a CUDA
    device). ``bpp`` (1 to 8) is the bytes a pixel, the left neighbour's
    distance. Equal to the JAX package's ``unfilter_device_batch`` and to
    the host library's ``png_unfilter``."""
    rows, filters = _inputs(rows, filters, bpp, device)
    if rows.device.type == "cpu":
        return unfilter_plain(rows, filters, bpp)
    b, h, rb = rows.shape
    out = torch.empty((b, h, rb), dtype=torch.uint8, device=rows.device)
    if out.numel() == 0:
        return out
    if b > 0x7FFFFFFF or rb > UNFILTER_MAX_ROW:
        raise ValueError(f"at most 2^31 - 1 images and rows of at most {UNFILTER_MAX_ROW} bytes a launch, "
                         f"got {b} and {rb}")
    lib = load()
    with _device_guard(rows):
        rc = lib.pixo_unfilter(rows.data_ptr(), filters.data_ptr(), b, h, rb, bpp, out.data_ptr(),
                               _stream(rows))
    _check(lib, rc, "unfilter")
    count_launch(unfilter_device_batch)
    return out


unfilter_device_batch.launches = 0


def unfilter_device(rows, filters, *, bpp: int, device="cuda") -> torch.Tensor:
    """The single-image [H, RB] variant of ``unfilter_device_batch``."""
    return unfilter_device_batch(_tensor(rows)[None], _tensor(filters)[None], bpp=bpp, device=device)[0]
