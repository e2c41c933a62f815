"""Device PNG unfilter: the reconstruction of filtered PNG rows.

Counterpart of the JAX package's ``ops/png_unfilter.py``, with the same
names. Reconstruction is sequential in x (Sub, Average and Paeth read the
pixel to the left) and in y (Up, Average and Paeth read the row above), but
the dependency cone (y, x - 1), (y - 1, x), (y - 1, x - 1) of pixels admits
an anti-diagonal wavefront: with each row skewed one step behind the row
above, step t reconstructs pixel (y, t - y) of every row at once, in
``ceil(RB / bpp) + H - 1`` steps (the bpp bytes of a pixel are independent).
All arithmetic is the bytes' mod-256 sums, so the result equals the host
library's serial ``png_unfilter``.

``unfilter_device_batch`` takes its plain PyTorch version
(``unfilter_plain``, the wavefront as a loop of tensor steps a byte at a
time, which follows the JAX function's algebra) for the CPU, and on a card
launches the kernel of ``csrc/unfilter.cu`` or raises; it never falls back.
The kernel takes a pixel a step, a lane a row, a warp a group of 32 rows;
the row above reaches a lane by a warp shuffle and a warp's first row
through a ring from the warp before; an image's warps cycle over its groups
and may span a cluster of CTAs. ``unfilter_plan`` picks the split and the
rings from the shape and the card's SMs. It counts its launches in
``unfilter_device_batch.launches``. As in the JAX package, no path calls it:
the PNG decode reconstructs its rows with the host library.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .kernels import H100_SMS, _check, _device_guard, _sm_count, _stream, count_launch, load

__all__ = ["UnfilterPlan", "unfilter_device", "unfilter_device_batch", "unfilter_plain", "unfilter_plan"]

UNFILTER_MAX_ROW = 0x7FFFFFFF - 2048  # csrc/unfilter.cu's rows: a step's byte positions are int
UNFILTER_GROUP = 32  # rows a warp takes at once, a lane a row
UNFILTER_CHUNK = 16  # its kChunk: steps between a warp's chunk-level work (copies, room, its count)
UNFILTER_TAKE = 8  # its kTake: steps whose pixels above a warp's first row takes at once
UNFILTER_AHEAD = 2  # its kAhead: chunks a lane's copies run ahead of its steps
UNFILTER_MAX_WARPS = 16  # its kMaxWarps: warps a CTA
UNFILTER_MAX_CTAS = 8  # its kMaxCtas: CTAs an image (a portable cluster)
UNFILTER_MIN_RING = 64  # its kMinRing: slots of a ring at least
UNFILTER_RING = 128  # slots of a ring where groups do not wrap round the warps
UNFILTER_LAG = 34  # the least steps from a group's start to the next one's (a take adds up to 8)
UNFILTER_CTA_WARPS = 2  # warps a CTA at least where an image spans a cluster (--unfilter-parts)
UNFILTER_SMEM = 232448  # dynamic shared memory a CTA may take on an H100


class UnfilterPlan(NamedTuple):
    """The unfilter kernel's launch for one batch shape (``unfilter_plan``)."""

    ctas: int  # CTAs an image, one cluster
    warps: int  # warps a CTA; the image's warp q takes groups q, q + ctas x warps, ...
    ring_slots: int  # slots of each warp's input ring (the row above its group)
    ring: str  # where the rings live: "shared" memory, or a "global" scratch past the budget
    smem: int  # dynamic shared-memory bytes of a CTA
    scratch: int  # bytes of global rings an image (0 for "shared")


def unfilter_in_words(bpp: int) -> int:
    """csrc/unfilter.cu's ``in_words<BPP>``: the 16-byte words of a lane's
    input ring, a power of 2 that holds the words the current chunk and the
    ``UNFILTER_AHEAD`` after it reach, and one more."""
    need = ((UNFILTER_AHEAD + 1) * UNFILTER_CHUNK * bpp + 15) // 16 + 1
    return 1 << (need - 1).bit_length()


def unfilter_lane_bytes(bpp: int) -> int:
    """A lane's shared memory in csrc/unfilter.cu: its input ring and 16
    bytes of padding (``lane_bytes<BPP>``), then its output staging, the
    word carried over and a chunk's bytes, 8 x an odd number of bytes
    (``stage_bytes<BPP>``)."""
    return 16 * unfilter_in_words(bpp) + 16 + 8 * (((8 + UNFILTER_CHUNK * bpp + 7) // 8) | 1)


def unfilter_slot_bytes(bpp: int) -> int:
    """Bytes of a ring slot: the pixel's 32-bit words, each beside its tag."""
    return 8 if bpp <= 4 else 16


def unfilter_plan(b: int, h: int, rb: int, bpp: int, sms: int = H100_SMS, ctas=None, warps=None,
                  ring=None) -> UnfilterPlan:
    """How ``unfilter_device_batch`` launches for ``b`` images of ``h`` rows
    of ``rb`` bytes at ``bpp`` on a card of ``sms`` SMs, by shape alone.

    A warp takes a group of 32 rows; a group starts about ``UNFILTER_LAG``
    steps after the one above (its lane 0 reads pixel x of the group above's
    last row, which that group's lane 31 makes 31 steps into it) and takes
    ``ceil(rb / bpp) + 31`` steps. An image gets the warps that finish a
    group before their next one is due (the depth), at most its groups and
    ``UNFILTER_MAX_CTAS x UNFILTER_MAX_WARPS``. Where the batch leaves SMs
    idle, the image's warps spread over a cluster of up to
    ``UNFILTER_MAX_CTAS`` CTAs of at least ``UNFILTER_CTA_WARPS`` warps; a
    CTA takes no more warps than its shared memory holds lanes for.
    ``ctas``, ``warps`` and ``ring`` ("global") force a split or the global
    rings, for the card checks and for timing the splits.

    Where groups wrap round the warps, every warp waiting on the next, the
    rings together must hold a row, or the warps deadlock: the slots keep
    ``ctas x warps x (slots - UNFILTER_CHUNK) >= ceil(rb / bpp)``, which the
    C entry checks. Elsewhere ``UNFILTER_RING`` slots suffice. The rings live
    in shared memory while a CTA's lanes and rings fit ``UNFILTER_SMEM``, in
    a global scratch beyond."""
    if b < 1 or h < 1 or rb < 1 or not 1 <= bpp <= 8 or sms < 1:
        raise ValueError(f"a plan needs b, h, rb, sms of at least 1 and bpp 1 to 8, got {(b, h, rb, bpp, sms)}")
    groups = -(-h // UNFILTER_GROUP)
    pixels = -(-rb // bpp)
    depth = min(groups, UNFILTER_MAX_CTAS * UNFILTER_MAX_WARPS, -(-(pixels + 31) // UNFILTER_LAG) + 1)
    if ctas is None:
        ctas = max(1, min(UNFILTER_MAX_CTAS, sms // b, -(-depth // UNFILTER_CTA_WARPS)))
    elif not 1 <= ctas <= UNFILTER_MAX_CTAS:
        raise ValueError(f"ctas must be 1 to {UNFILTER_MAX_CTAS}, got {ctas}")
    fit = UNFILTER_SMEM // (UNFILTER_GROUP * unfilter_lane_bytes(bpp))  # warps whose lanes a CTA holds
    if warps is None:
        warps = min(UNFILTER_MAX_WARPS, fit, -(-depth // ctas))
    elif not 1 <= warps <= min(UNFILTER_MAX_WARPS, fit):
        raise ValueError(f"warps must be 1 to {min(UNFILTER_MAX_WARPS, fit)} at bpp {bpp}, got {warps}")
    total = ctas * warps
    slots = UNFILTER_RING
    if groups > total:
        need = -(-pixels // total) + UNFILTER_CHUNK
        slots = max(slots, 1 << (need - 1).bit_length())
    block = slots * unfilter_slot_bytes(bpp) + 16
    lanes = warps * UNFILTER_GROUP * unfilter_lane_bytes(bpp)
    if ring not in (None, "global"):
        raise ValueError(f"ring must be None or 'global', got {ring!r}")
    if ring is None and lanes + warps * block <= UNFILTER_SMEM:
        return UnfilterPlan(ctas, warps, slots, "shared", lanes + warps * block, 0)
    return UnfilterPlan(ctas, warps, slots, "global", lanes, total * block)


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
    the host library's ``png_unfilter``. The launch follows
    ``unfilter_plan``."""
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
    plan = unfilter_plan(b, h, rb, bpp, _sm_count(rows.device))
    if b * plan.ctas > 0x7FFFFFFF:
        raise ValueError(f"at most 2^31 - 1 CTAs a launch, got {b} images of {plan.ctas}")
    ring = (torch.empty(b * plan.scratch, dtype=torch.uint8, device=rows.device)
            if plan.ring == "global" else None)
    lib = load()
    with _device_guard(rows):
        rc = lib.pixo_unfilter(rows.data_ptr(), filters.data_ptr(), b, h, rb, bpp, plan.ctas, plan.warps,
                               plan.ring_slots, None if ring is None else ring.data_ptr(), out.data_ptr(),
                               _stream(rows))
    _check(lib, rc, "unfilter")
    count_launch(unfilter_device_batch)
    return out


unfilter_device_batch.launches = 0


def unfilter_device(rows, filters, *, bpp: int, device="cuda") -> torch.Tensor:
    """The single-image [H, RB] variant of ``unfilter_device_batch``."""
    return unfilter_device_batch(_tensor(rows)[None], _tensor(filters)[None], bpp=bpp, device=device)[0]
