"""PNG filter bank and filter selection, in plain PyTorch.

Counterpart of the JAX package's ``ops/png_filters.py``. All five PNG filters
(None/Sub/Up/Average/Paeth) and their selection scores are computed for every
row at once: PNG filtering reads the *raw* previous row and pixel, so every
row and every filter is independent. The selection rules are the reference's,
bit for bit (pixo ``src/png/filter.rs``):

  - Adaptive / MinSum: try None,Sub,Up,Avg,Paeth in order, keep strict
    improvements, stop early when the running best reaches row_len/4 + 1.
  - AdaptiveFast: Sub,Up,Paeth with early stop at row_len/8 + 1; for images
    of height <= 32 the row-0 winner is reused for all rows.
  - Bigrams: the fewest distinct consecutive byte pairs, the lowest filter id
    on a tie.
  - Small images (area <= 4096) force Sub for the adaptive strategies and
    Bigrams.

Scores are sum(|byte as i8|). The functions here are the plain versions of
the CUDA filter kernels (``ops/kernels.py::filter_bank``/``filter_rows``),
which the wrappers take for tensors on the CPU. The per-image encode filters
on the host instead (``apply_filters``, the native tier, as the JAX package's
default does).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..native import native_png_filter
from ..options import FilterStrategy

FILTER_NONE, FILTER_SUB, FILTER_UP, FILTER_AVERAGE, FILTER_PAETH = range(5)

_FIXED_IDS = {
    FilterStrategy.NONE: FILTER_NONE,
    FilterStrategy.SUB: FILTER_SUB,
    FilterStrategy.UP: FILTER_UP,
    FilterStrategy.AVERAGE: FILTER_AVERAGE,
    FilterStrategy.PAETH: FILTER_PAETH,
}

# Filter modes as the native library and the CUDA kernel number them.
MODE_ADAPTIVE, MODE_ADAPTIVE_FAST, MODE_BIGRAMS = 5, 6, 7
_NATIVE_MODES = {
    **_FIXED_IDS,
    FilterStrategy.ADAPTIVE: MODE_ADAPTIVE,
    FilterStrategy.MIN_SUM: MODE_ADAPTIVE,
    FilterStrategy.ADAPTIVE_FAST: MODE_ADAPTIVE_FAST,
    FilterStrategy.BIGRAMS: MODE_BIGRAMS,
}


def resolve_strategy(strategy, small_image: bool) -> FilterStrategy:
    """The strategy that runs: Sub in place of an adaptive one or Bigrams on
    a small image."""
    strat = FilterStrategy(strategy)
    if small_image and strat in (FilterStrategy.ADAPTIVE, FilterStrategy.ADAPTIVE_FAST,
                                 FilterStrategy.BIGRAMS):
        return FilterStrategy.SUB
    return strat


def native_mode(strategy: FilterStrategy) -> int:
    """The native/kernel mode number of a resolved strategy."""
    return _NATIVE_MODES[strategy]


def early_stop(mode: int, row_bytes: int) -> int:
    """The score at or below which a selection stops: row_len/4 + 1 for
    adaptive, row_len/8 + 1 for adaptive-fast, unused (0) for a fixed filter."""
    if mode == MODE_ADAPTIVE:
        return row_bytes // 4 + 1
    if mode == MODE_ADAPTIVE_FAST:
        return row_bytes // 8 + 1
    return 0


def _candidates(rows: torch.Tensor, bpp: int) -> torch.Tensor:
    """[..., H, RB] uint8 -> [..., 5, H, RB] int32 filtered candidates
    (mod-256 values). All arithmetic in int32."""
    x = rows.to(torch.int32)
    rb = x.shape[-1]
    up = F.pad(x[..., :-1, :], (0, 0, 1, 0))
    if rb > bpp:
        left = F.pad(x[..., :-bpp], (bpp, 0))
        ul = F.pad(up[..., :-bpp], (bpp, 0))
    else:
        left = torch.zeros_like(x)
        ul = torch.zeros_like(x)

    f_none = x
    f_sub = (x - left) & 0xFF
    f_up = (x - up) & 0xFF
    f_avg = (x - ((left + up) >> 1)) & 0xFF

    p = left + up - ul
    pa = (p - left).abs()
    pb = (p - up).abs()
    pc = (p - ul).abs()
    pred = torch.where((pa <= pb) & (pa <= pc), left, torch.where(pb <= pc, up, ul))
    f_paeth = (x - pred) & 0xFF

    return torch.stack([f_none, f_sub, f_up, f_avg, f_paeth], dim=-3)


def _signed_abs_scores(cands: torch.Tensor) -> torch.Tensor:
    """[..., 5, H, RB] -> [..., H, 5] int32 sum of |value as i8| per row per
    filter."""
    mag = torch.minimum(cands, 256 - cands)  # |b as i8|; 0->0, 128->128, 255->1
    mag = torch.where(cands == 0, 0, mag)
    return mag.sum(dim=-1).transpose(-1, -2).to(torch.int32)


def _bigram_scores(cands: torch.Tensor) -> torch.Tensor:
    """[..., 5, H, RB] -> [..., H, 5] int32 counts of the distinct pairs
    (c[i], c[i+1]) of each row's candidate; 0 for a row of fewer than 2
    bytes."""
    rb = cands.shape[-1]
    if rb < 2:
        return torch.zeros((*cands.shape[:-3], cands.shape[-2], 5), dtype=torch.int32,
                           device=cands.device)
    keys = torch.sort(cands[..., :-1] * 256 + cands[..., 1:], dim=-1).values
    distinct = 1 + (keys[..., 1:] != keys[..., :-1]).sum(dim=-1)
    return distinct.transpose(-1, -2).to(torch.int32)


def _select_adaptive(scores: torch.Tensor, early: int) -> torch.Tensor:
    """Reference adaptive_filter selection over [..., H, 5] scores -> [..., H]
    int32 filter ids."""
    big = torch.iinfo(scores.dtype).max
    prefix = torch.cat(
        [torch.full_like(scores[..., :1], big), torch.cummin(scores, dim=-1).values[..., :-1]],
        dim=-1,
    )
    is_best = scores < prefix
    stop = is_best & (scores <= early)
    any_stop = stop.any(dim=-1)
    first_stop = torch.argmax(stop.to(torch.int32), dim=-1)
    overall = torch.argmin(scores, dim=-1)
    return torch.where(any_stop, first_stop, overall).to(torch.int32)


def _select_adaptive_fast(scores: torch.Tensor, early: int) -> torch.Tensor:
    """Reference adaptive_filter_fast selection: Sub, Up, Paeth with cutoffs."""
    s1, s2, s4 = scores[..., FILTER_SUB], scores[..., FILTER_UP], scores[..., FILTER_PAETH]
    best12 = torch.where(s2 < s1, FILTER_UP, FILTER_SUB)
    sb12 = torch.minimum(s1, s2)
    best124 = torch.where(s4 < sb12, FILTER_PAETH, best12)
    return torch.where(
        s1 <= early, FILTER_SUB, torch.where(sb12 <= early, best12, best124)
    ).to(torch.int32)


def filter_image_batch(
    batch_rows: torch.Tensor, *, bpp: int, strategy, small_image: bool, sticky_fast: bool
):
    """[B, H, RB] uint8 -> (filtered [B, H, RB] uint8, ids [B, H] int32), on
    the rows' device. ``strategy`` is a FilterStrategy or its value."""
    b, h, rb = batch_rows.shape
    strat = resolve_strategy(strategy, small_image)
    cands = _candidates(batch_rows, bpp)
    if strat in _FIXED_IDS:
        fid = _FIXED_IDS[strat]
        ids = torch.full((b, h), fid, dtype=torch.int32, device=batch_rows.device)
        return cands[:, fid].to(torch.uint8), ids

    if strat == FilterStrategy.BIGRAMS:
        # argmin takes the first of equal counts: the lowest filter id wins a
        # tie, as under the host library's strict < and jnp.argmin
        ids = torch.argmin(_bigram_scores(cands), dim=-1).to(torch.int32)
    elif strat == FilterStrategy.ADAPTIVE_FAST:
        ids = _select_adaptive_fast(_signed_abs_scores(cands), rb // 8 + 1)
        if sticky_fast:
            ids = ids[:, :1].expand(b, h).contiguous()
    else:  # ADAPTIVE, MIN_SUM
        ids = _select_adaptive(_signed_abs_scores(cands), rb // 4 + 1)
    index = ids.to(torch.int64)[:, None, :, None].expand(b, 1, h, rb)
    chosen = torch.gather(cands, 1, index)[:, 0]
    return chosen.to(torch.uint8), ids


def filter_image(rows: torch.Tensor, *, bpp: int, strategy, small_image: bool, sticky_fast: bool):
    """[H, RB] uint8 raw rows -> (filtered [H, RB] uint8, filter ids [H] int32)."""
    filtered, ids = filter_image_batch(
        rows[None], bpp=bpp, strategy=strategy, small_image=small_image, sticky_fast=sticky_fast
    )
    return filtered[0], ids[0]


def filter_rows_plain(
    batch_rows: torch.Tensor, *, bpp: int, strategy, small_image: bool, sticky_fast: bool
) -> torch.Tensor:
    """[B, H, RB] uint8 -> [B, H, RB+1] uint8 PNG rows, the filter id first:
    the plain version of the fused filter kernel."""
    filtered, ids = filter_image_batch(
        batch_rows, bpp=bpp, strategy=strategy, small_image=small_image, sticky_fast=sticky_fast
    )
    return torch.cat([ids.to(torch.uint8)[..., None], filtered], dim=-1)


def _log_filter_counts(strategy: FilterStrategy, ids: np.ndarray) -> None:
    counts = np.bincount(ids, minlength=5)
    print(
        f"PNG filters: strategy={strategy.name}, rows={len(ids)} "
        f"counts={{None:{counts[0]}, Sub:{counts[1]}, Up:{counts[2]}, "
        f"Avg:{counts[3]}, Paeth:{counts[4]}}}",
        file=sys.stderr,
    )


def apply_filters(
    data,
    width: int,
    height: int,
    row_bytes: int,
    bpp: int,
    strategy: FilterStrategy,
    *,
    verbose_filter_log: bool = False,
) -> bytes:
    """One image's raw bytes -> PNG-filtered bytes with type-byte rows,
    filtered on the host by the native tier (the JAX package's default for a
    single image: a device round trip costs more than the filtering)."""
    rows = np.frombuffer(data, dtype=np.uint8).reshape(height, row_bytes)
    small = width * height <= 4096
    sticky = height <= 32  # sequential path stickiness for AdaptiveFast
    mode = native_mode(resolve_strategy(strategy, small))
    out = native_png_filter(rows, bpp, mode, sticky and mode == MODE_ADAPTIVE_FAST)
    if verbose_filter_log:
        _log_filter_counts(strategy, out[:, 0])
    return out.tobytes()
