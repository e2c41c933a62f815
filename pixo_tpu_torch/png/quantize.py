"""Lossy PNG palette quantization.

Counterpart of the JAX package's ``png/quantize.py``, with behavioral parity
with pixo ``src/png/mod.rs:1160-1762``:

  - sampled histogram (50k cap, stride sampling, counts scaled by stride,
    8192-color cap keeping the most frequent),
  - median cut with perceptual split scores (G*4 > A*3 > R*2 > B*1),
    population-median split clamped so both halves are non-empty,
  - 2-iteration weighted k-means refinement with the redmean distance,
  - 6-6-6 RGB LUT (256Ki entries) for O(1) nearest lookup, alpha fallback,
  - optional Floyd-Steinberg dithering on RGB only (7/16, 3/16, 5/16, 1/16),
  - auto-quantize heuristic: quantize iff max_colors < unique <=
    32*max_colors over a 20k-pixel sample.

Two tiers, the same bytes. ``quantize_image`` is the per-image host tier
(numpy and the native library, as the reference's default). ``quantize_batch``
keeps the histograms, the median-cut boxes and the no-dither lookup on the
host and runs the k-means, the LUT build and the dither for the whole batch
through ``ops/kernels.py`` on ``device``: on a CUDA device three hand-written
kernels, on the CPU their plain versions (``ops/quantize_device.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..native import native_dither_fs, native_nearest_palette, native_palette_lut
from ..ops import kernels


def _keys_rgba(pixels: np.ndarray) -> np.ndarray:
    """[N, 3|4] uint8 -> u32 keys (r<<24 | g<<16 | b<<8 | a)."""
    r = pixels[:, 0].astype(np.uint32)
    g = pixels[:, 1].astype(np.uint32)
    b = pixels[:, 2].astype(np.uint32)
    a = (
        pixels[:, 3].astype(np.uint32)
        if pixels.shape[1] == 4
        else np.full(len(pixels), 255, np.uint32)
    )
    return (r << 24) | (g << 16) | (b << 8) | a


def should_quantize_auto(pixels: np.ndarray, max_colors: int) -> bool:
    """Sampled unique-color heuristic (``should_quantize_auto``, ``:1708-1762``)."""
    total = len(pixels)
    if total == 0:
        return False
    stride = max(total // 20_000, 1)
    sampled = pixels[::stride]
    if pixels.shape[1] == 3:
        keys = (
            (sampled[:, 0].astype(np.uint32) << 16)
            | (sampled[:, 1].astype(np.uint32) << 8)
            | sampled[:, 2].astype(np.uint32)
        )
    else:
        keys = _keys_rgba(sampled)
    threshold = max_colors * 32
    unique = len(np.unique(keys))
    return max_colors < unique <= threshold


def nearest_palette_indices(colors: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """[N, 4] colors x [K, 4] palette -> [N] uint8 argmin redmean distance,
    the first on ties (the host library)."""
    return native_nearest_palette(colors, palette)


def _sampled_histogram(pixels: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """-> (colors [K, 4] uint8, counts [K] uint32), sampled + capped."""
    total = len(pixels)
    stride = max(total // 50_000, 1)
    keys = _keys_rgba(pixels[::stride])
    skeys = np.sort(keys)
    uniq, counts = np.unique(skeys, return_counts=True)
    counts = counts.astype(np.uint64) * stride
    counts = np.minimum(counts, np.iinfo(np.uint32).max).astype(np.uint32)
    if len(uniq) > 8192:
        # keep the most frequent 8192 (mod.rs:1577-1581). The reference
        # tie-breaks arbitrarily (sort_unstable); a stable lowest-key
        # tie-break degenerates when counts are uniform (e.g. smooth
        # gradients sample ~50k distinct colors once each, and "first 8192
        # keys" is just the darkest corner of the color cube). Spread ties
        # deterministically over the color space with a multiplicative
        # hash instead: same most-frequent contract, uniform tie coverage.
        tie = (uniq * np.uint32(2654435761)) >> np.uint32(16)
        order = np.lexsort((tie, -counts.astype(np.int64)))[:8192]
        uniq, counts = uniq[order], counts[order]
    colors = np.stack(
        [(uniq >> 24) & 0xFF, (uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF],
        axis=1,
    ).astype(np.uint8)
    return colors, counts


class _Box:
    __slots__ = ("colors", "counts", "mins", "maxs", "_score")

    def __init__(self, colors: np.ndarray, counts: np.ndarray):
        self.colors = colors
        self.counts = counts
        self.mins = colors.min(axis=0).astype(np.int32)
        self.maxs = colors.max(axis=0).astype(np.int32)
        # cached: the selection loop re-consults every box's score each round
        ranges = self.maxs - self.mins
        scores = (
            int(ranges[0]) * 2, int(ranges[1]) * 4,
            int(ranges[2]) * 1, int(ranges[3]) * 3,
        )
        channel, best = 0, scores[0]
        for c in (1, 2, 3):
            if scores[c] > best:
                channel, best = c, scores[c]
        self._score = (channel, best)

    def range_score(self) -> Tuple[int, int]:
        """(channel, perceptual score) with weights R*2, G*4, B*1, A*3."""
        return self._score

    def can_split(self) -> bool:
        return len(self.colors) > 1

    def split(self) -> Tuple["_Box", "_Box"]:
        channel, _ = self.range_score()
        order = np.argsort(self.colors[:, channel], kind="stable")
        colors, counts = self.colors[order], self.counts[order]
        total = int(counts.sum(dtype=np.uint64))
        acc = np.cumsum(counts.astype(np.uint64))
        hits = np.nonzero(acc >= total // 2)[0]
        split_idx = int(hits[0]) if len(hits) else 0
        split_idx = min(split_idx, max(len(colors) - 2, 0))
        return (
            _Box(colors[: split_idx + 1], counts[: split_idx + 1]),
            _Box(colors[split_idx + 1 :], counts[split_idx + 1 :]),
        )

    def centroid(self) -> np.ndarray:
        total = int(self.counts.sum(dtype=np.uint64))
        if total == 0:
            return np.array([0, 0, 0, 255], np.uint8)
        sums = (self.colors.astype(np.uint64) * self.counts[:, None]).sum(axis=0)
        return (sums // total).astype(np.uint8)


def median_cut_palette(
    colors: np.ndarray, counts: np.ndarray, max_colors: int, refine: bool = True
) -> np.ndarray:
    if len(colors) == 0:
        return np.array([[0, 0, 0, 255]], np.uint8)
    boxes = [_Box(colors, counts)]
    while len(boxes) < max_colors:
        scores = [b.range_score()[1] for b in boxes]
        # Rust max_by_key keeps the LAST maximal element on ties
        # (mod.rs:1311-1317); reproduce for palette-order byte parity.
        best = max(scores)
        idx = len(scores) - 1 - scores[::-1].index(best)
        if not boxes[idx].can_split():
            break
        box = boxes.pop(idx)
        left, right = box.split()
        if len(left.colors):
            boxes.append(left)
        if len(right.colors):
            boxes.append(right)
    palette = np.stack([b.centroid() for b in boxes])
    if not refine:
        return palette
    return refine_palette_kmeans(palette, colors, counts)


def refine_palette_kmeans(
    palette: np.ndarray, colors: np.ndarray, counts: np.ndarray, iterations: int = 2
) -> np.ndarray:
    """Weighted k-means refinement with redmean assignment (``:1346-1390``)."""
    if len(palette) == 0 or len(colors) == 0:
        return palette
    palette = palette.copy()
    for _ in range(iterations):
        assign = nearest_palette_indices(colors, palette)
        w = counts.astype(np.uint64)
        sums = np.zeros((len(palette), 4), np.uint64)
        totals = np.zeros(len(palette), np.uint64)
        np.add.at(sums, assign, colors.astype(np.uint64) * w[:, None])
        np.add.at(totals, assign, w)
        nonzero = totals > 0
        palette[nonzero] = (sums[nonzero] // totals[nonzero, None]).astype(np.uint8)
    return palette


class PaletteLut:
    """6-6-6 opaque LUT + direct redmean fallback for alpha (``:1448-1499``)."""

    def __init__(self, palette: np.ndarray, opaque_lut: np.ndarray = None):
        self.palette = palette
        self.opaque_lut = native_palette_lut(palette) if opaque_lut is None else opaque_lut

    def lookup_many(self, rgba: np.ndarray) -> np.ndarray:
        """[N, 4] -> [N] uint8 indices."""
        r6 = rgba[:, 0] >> 2
        g6 = rgba[:, 1] >> 2
        b6 = rgba[:, 2] >> 2
        idx = (
            (r6.astype(np.int64) << 12) | (g6.astype(np.int64) << 6) | b6.astype(np.int64)
        )
        out = self.opaque_lut[idx]
        alpha_mask = rgba[:, 3] != 255
        if alpha_mask.any():
            out = out.copy()
            out[alpha_mask] = nearest_palette_indices(rgba[alpha_mask], self.palette)
        return out


def _dither_floyd_steinberg(
    rgba: np.ndarray, width: int, height: int, palette: np.ndarray, lut: PaletteLut
) -> np.ndarray:
    """Sequential FS error diffusion (``:1634-1698``), the host library's scan."""
    return native_dither_fs(rgba, width, height, palette, lut.opaque_lut)


def _pad_hist(colors: np.ndarray, counts: np.ndarray, m: int = 8192):
    """Pad to a fixed M with zero-count entries (one batch shape).
    Zero-weight colors cannot move a k-means centroid, so results are
    bit-equal to the unpadded host computation."""
    k = len(colors)
    pc = np.zeros((m, 4), np.uint8)
    pw = np.zeros(m, np.uint32)
    pc[:k] = colors
    pw[:k] = counts
    return pc, pw


def _device_kmeans_weights(counts: np.ndarray):
    """Weights safe for the device k-means' int32 weights, or None.

    Centroids are floor(sum(c*w) / sum(w)); dividing every weight by a
    common divisor leaves both quotients' exact rational unchanged, so
    the result is bit-equal.  Histogram counts are sample counts scaled
    by the sampling stride (``_sampled_histogram``), so their GCD
    absorbs the stride and the reduced weights sum to the raw sample
    count (<= ~100k) — far inside int32 range.  For arbitrary caller
    weights whose GCD is 1 the reduction can be a no-op; return None
    then so callers take the (uint64) host tier instead.
    """
    nz = counts[counts > 0]
    if len(nz) == 0:
        return counts
    g = int(np.gcd.reduce(nz.astype(np.uint64)))
    reduced = (counts.astype(np.uint64) // max(g, 1)).astype(np.uint32)
    if int(reduced.sum(dtype=np.uint64)) * 255 >= 2**31:
        return None
    return reduced


def _pad_palette(palette: np.ndarray, k: int = 256) -> np.ndarray:
    """Pad to K entries with duplicates of entry 0: duplicates at higher
    indices can never win a first-min tie, so assignments, LUTs and
    dithers over the padded palette equal the unpadded ones."""
    if len(palette) == k:
        return palette
    return np.concatenate(
        [palette, np.tile(palette[:1], (k - len(palette), 1))]
    )


def _as_rgba(pixels: np.ndarray) -> np.ndarray:
    """[N, 3|4] uint8 -> [N, 4], alpha 255 where there was none."""
    if pixels.shape[1] == 4:
        return pixels
    return np.concatenate([pixels, np.full((len(pixels), 1), 255, np.uint8)], axis=1)


class LossyBatch(NamedTuple):
    """``quantize_batch``'s host stage: the images that the host tier
    finished, and the padded inputs of the others' device stage."""

    results: list  # per image: (palette, indices) from the host tier, or None
    members: List[int]  # the images that go to the device, in batch order
    palettes: np.ndarray  # [n, 256, 4] uint8: median-cut palettes, padded with entry 0
    colors: np.ndarray  # [n, 8192, 4] uint8: sampled histograms, padded
    weights: np.ndarray  # [n, 8192] int32: their counts, reduced by their GCD, padded with 0
    k: np.ndarray  # [n] int32: each palette's real entries
    rgba: np.ndarray  # [n, H, W, 4] uint8: the members' pixels, alpha 255 where there was none
    counts: np.ndarray  # [n] int32: each histogram's real colours (the k-means' schedule)


def quantize_host_stage(imgs: np.ndarray, max_colors: int, dithering: bool) -> LossyBatch:
    """Per image on the host: the sampled histogram, then the host tier
    from it (``_quantize_histogram``) for an image whose histogram fits
    ``max_colors`` (the exact mapping), whose weights the device k-means'
    int32 range cannot take, or, with ``dithering``, whose pixels the
    device dither cannot take (past ``kernels.DITHER_MAX_PIXELS``), and for
    the others the median-cut boxes and the padded device inputs."""
    b, h, w = imgs.shape[:3]
    flat = imgs.reshape(b, h * w, imgs.shape[3])
    results: list = [None] * b
    members, pals, pcs, pws, ks, ns = [], [], [], [], [], []
    host_dither = dithering and h * w > kernels.DITHER_MAX_PIXELS
    for i in range(b):
        pixels = flat[i]
        colors, counts = _sampled_histogram(pixels)
        dw = None if len(colors) <= max_colors or host_dither else _device_kmeans_weights(counts)
        if dw is None:
            results[i] = _quantize_histogram(pixels, colors, counts, w, h, max_colors, dithering)
            continue
        pal0 = median_cut_palette(colors, counts, max_colors, refine=False)
        pc, pw = _pad_hist(colors, dw)
        members.append(i)
        pals.append(_pad_palette(pal0))
        pcs.append(pc)
        pws.append(pw.astype(np.int32))
        ks.append(len(pal0))
        ns.append(len(colors))
    rgba = np.stack([_as_rgba(flat[i]).reshape(h, w, 4) for i in members]) if members else None

    def stack(arrays, shape, dtype):
        return np.stack(arrays) if arrays else np.zeros((0, *shape), dtype)

    return LossyBatch(results, members, stack(pals, (256, 4), np.uint8),
                      stack(pcs, (8192, 4), np.uint8), stack(pws, (8192,), np.int32),
                      np.asarray(ks, np.int32), rgba, np.asarray(ns, np.int32))


def quantize_device_stage(batch: LossyBatch, dithering: bool, device):
    """The members' k-means, LUT and (with ``dithering``) dither on
    ``device``, through ``ops/kernels.py``: (palettes [n, 256, 4], LUTs
    [n, 262144], indices [n, H, W] or None), all on ``device``. Each refined
    palette is padded again with its FINAL entry 0, on the device, so that
    the padding rows are true duplicates (harmless in first-min ties) of the
    refined palette; the LUT and the dither scan only each palette's real
    entries (``batch.k``)."""
    dev = torch.device(device)

    def up(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

    k = up(batch.k)
    pal = kernels.kmeans_refine(up(batch.palettes), up(batch.colors), up(batch.weights), k,
                                batch.counts)
    pad = torch.arange(pal.shape[1], device=dev)[None, :] >= k[:, None].long()
    pal = torch.where(pad[..., None], pal[:, :1], pal).contiguous()
    lut = kernels.palette_lut(pal, k)
    idx = kernels.dither_fs(up(batch.rgba), pal, lut, k) if dithering else None
    return pal, lut, idx


def quantize_finish(batch: LossyBatch, pal: torch.Tensor, lut: torch.Tensor, idx) -> list:
    """The device results to the host, and each member's (palette, indices):
    the dither's indices, or without a dither ``PaletteLut.lookup_many`` of
    the LUT on the host, as in the reference."""
    results = list(batch.results)
    pal_b = pal.cpu().numpy()
    if idx is not None:
        idx_b = idx.cpu().numpy().reshape(len(batch.members), -1)
    else:
        lut_b = lut.cpu().numpy()
        idx_b = [PaletteLut(pal_b[j], lut_b[j]).lookup_many(batch.rgba[j].reshape(-1, 4))
                 for j in range(len(batch.members))]
    for j, i in enumerate(batch.members):
        results[i] = (pal_b[j][: batch.k[j]], np.asarray(idx_b[j], dtype=np.uint8))
    return results


def quantize_batch(imgs: np.ndarray, max_colors: int, dithering: bool, *,
                   device="cuda") -> List[Tuple[np.ndarray, np.ndarray]]:
    """[B, H, W, 3|4] uint8 -> list of (palette [K, 4], indices [H*W]),
    each equal to ``quantize_image`` of its image.

    Per image on the host (``quantize_host_stage``): the sampled histogram,
    the exact-mapping branch (the histogram fits ``max_colors``), the host
    tier for weights that the device k-means' int32 range cannot take, and
    the median-cut boxes. Then, for the rest of the batch at once on
    ``device`` (``quantize_device_stage``): the k-means refinement
    (``ops/kernels.py::kmeans_refine``), the 6-6-6 LUT (``palette_lut``)
    and, with ``dithering``, the wavefront Floyd-Steinberg dither
    (``dither_fs``); without it the LUT comes to the host for
    ``PaletteLut.lookup_many``, as in the reference. The device stage runs
    in groups of at most ``kernels.QUANTIZE_MAX_BATCH`` members."""
    batch = quantize_host_stage(imgs, max_colors, dithering)
    results = batch.results
    for lo in range(0, len(batch.members), kernels.QUANTIZE_MAX_BATCH):
        hi = lo + kernels.QUANTIZE_MAX_BATCH  # quantize_finish fills results for members lo to hi - 1
        part = LossyBatch(results, batch.members[lo:hi], *(a[lo:hi] for a in batch[2:]))
        results = quantize_finish(part, *quantize_device_stage(part, dithering, device))
    return results


def quantize_image(
    pixels: np.ndarray,
    width: int,
    height: int,
    max_colors: int,
    dithering: bool,
) -> Tuple[np.ndarray, np.ndarray]:
    """[N, 3|4] uint8 -> (palette [K, 4] uint8, indices [N] uint8): the
    per-image host tier (numpy and the native library)."""
    colors, counts = _sampled_histogram(pixels)
    return _quantize_histogram(pixels, colors, counts, width, height, max_colors, dithering)


def _quantize_histogram(pixels: np.ndarray, colors: np.ndarray, counts: np.ndarray, width: int,
                        height: int, max_colors: int,
                        dithering: bool) -> Tuple[np.ndarray, np.ndarray]:
    """``quantize_image`` from the image's sampled histogram (colors,
    counts) on."""
    rgba = _as_rgba(pixels)
    if len(colors) <= max_colors:
        # Exact mapping: sampled colors are the palette; binary-search by key
        # with redmean fallback for unsampled colors.
        palette = colors
        keys = _keys_rgba(rgba)
        pal_keys = _keys_rgba(palette.astype(np.uint8))
        order = np.argsort(pal_keys)
        sorted_keys = pal_keys[order]
        pos = np.searchsorted(sorted_keys, keys)
        pos_c = np.minimum(pos, len(sorted_keys) - 1)
        found = sorted_keys[pos_c] == keys
        indices = np.empty(len(keys), np.uint8)
        indices[found] = order[pos_c[found]].astype(np.uint8)
        if (~found).any():
            indices[~found] = nearest_palette_indices(rgba[~found], palette)
        return palette, indices

    palette = median_cut_palette(colors, counts, max_colors)
    lut = PaletteLut(palette)
    if not dithering:
        return palette, lut.lookup_many(rgba)
    return palette, _dither_floyd_steinberg(rgba, width, height, palette, lut)
