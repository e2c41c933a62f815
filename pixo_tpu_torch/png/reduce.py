"""Lossless PNG reductions: color type, palette, bit depth, alpha, mZeng.

Copied from the JAX package's ``png/reduce.py`` (numpy only, unchanged but
for this paragraph). Behavioral parity with pixo ``src/png/mod.rs``:
  - ``maybe_reduce_color_type`` (``:683-836``): RGB->Gray when channels
    equal; RGBA->Gray/RGB/GrayAlpha by opacity/grayness; palette reduction
    (sorted-unique, <= 256 colors) takes priority when enabled.
  - ``build_palette`` (``:838-900``): RGBA-keyed sort+dedup, binary-search
    index mapping, then mZeng reorder.
  - mZeng reindexing (``:909-1099``): co-occurrence matrix, greedy chain
    insertion by adjacency sums with prepend/append delta, most-popular-
    first rotation at the 15% threshold.
  - bit-depth reduction + row-aligned packing (``src/png/bit_depth.rs``).

For a batch, the predicates (all-gray, all-opaque, the palette screen)
run on the device (``ops/reduce_analysis.py``); the <=256-color greedy
ordering runs on host. NumPy is used here since these reductions are
bandwidth-trivial next to filtering/DEFLATE.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..color import ColorType


_SAMPLE_CAP = 4096  # ops/reduce_analysis.py samples with the same stride


def _sample(data: np.ndarray) -> np.ndarray:
    """Strided row sample for cheap early rejection (exact: a property that
    fails on the sample fails on the full image)."""
    n = data.shape[0]
    if n <= _SAMPLE_CAP:
        return data
    return data[:: max(n // _SAMPLE_CAP, 1)]


def all_gray_rgb(data: np.ndarray) -> bool:
    """data: [N, 3] uint8."""
    s = _sample(data)
    if not ((s[:, 0] == s[:, 1]).all() and (s[:, 1] == s[:, 2]).all()):
        return False
    return bool((data[:, 0] == data[:, 1]).all() and (data[:, 1] == data[:, 2]).all())


def analyze_rgba(data: np.ndarray) -> Tuple[bool, bool]:
    """data: [N, 4] uint8 -> (all_opaque, all_gray)."""
    s = _sample(data)
    all_opaque = bool((s[:, 3] == 255).all()) and bool((data[:, 3] == 255).all())
    all_gray = bool(
        (s[:, 0] == s[:, 1]).all() and (s[:, 1] == s[:, 2]).all()
    ) and bool((data[:, 0] == data[:, 1]).all() and (data[:, 1] == data[:, 2]).all())
    return all_opaque, all_gray


def reduce_gray_bit_depth(gray: np.ndarray) -> int:
    if gray.size == 0:
        return 8
    m = int(gray.max())
    if m <= 1:
        return 1
    if m <= 3:
        return 2
    if m <= 15:
        return 4
    return 8


def palette_bit_depth(n: int) -> int:
    if n == 0:
        return 8
    if n <= 2:
        return 1
    if n <= 4:
        return 2
    if n <= 16:
        return 4
    return 8


def pack_bits_rows(samples: np.ndarray, width: int, bits: int) -> bytes:
    """Row-aligned bit packing of 8-bit samples to 1/2/4-bit (MSB-first)."""
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    height = samples.size // width
    rows = samples.reshape(height, width).astype(np.uint8) & ((1 << bits) - 1)
    per_byte = 8 // bits
    pad = (-width) % per_byte
    if pad:
        rows = np.concatenate([rows, np.zeros((height, pad), np.uint8)], axis=1)
    grouped = rows.reshape(height, -1, per_byte)
    shifts = np.arange(per_byte - 1, -1, -1, dtype=np.uint8) * bits
    packed = (grouped.astype(np.uint16) << shifts).sum(axis=2).astype(np.uint8)
    return packed.tobytes()


def build_co_occurrence(indexed: np.ndarray, n: int, width: int, height: int) -> np.ndarray:
    """Symmetric horizontal+vertical neighbor-pair counts, [n, n] int64."""
    grid = indexed.reshape(height, width).astype(np.int64)
    mat = np.zeros((n, n), dtype=np.int64)
    if width > 1:
        a = grid[:, :-1].ravel()
        b = grid[:, 1:].ravel()
        np.add.at(mat, (a, b), 1)
        np.add.at(mat, (b, a), 1)
    if height > 1:
        a = grid[:-1, :].ravel()
        b = grid[1:, :].ravel()
        np.add.at(mat, (a, b), 1)
        np.add.at(mat, (b, a), 1)
    return mat


def mzeng_reindex(n: int, matrix: np.ndarray) -> List[int]:
    """Greedy chain ordering by adjacency sums (Pinho et al. 2004 variant)."""
    # edges sorted by weight desc; reference iterates j<i as ((j, i), w)
    weights = []
    for i in range(n):
        for j in range(i):
            if matrix[i, j] > 0:
                weights.append(((j, i), int(matrix[i, j])))
    if not weights:
        return list(range(n))
    weights.sort(key=lambda e: -e[1])
    first = weights[0][0]
    remapping = [first[0], first[1]]

    # Vec of [color, adjacency-sum] with swap_remove semantics, scanned with
    # strict > — reproduces the reference's tie-breaking exactly.
    sums: List[List[int]] = []
    best_pos, best = 0, (0, 0)
    for i in range(n):
        if i == remapping[0] or i == remapping[1]:
            continue
        s = int(matrix[i, remapping[0]] + matrix[i, remapping[1]])
        if s > best[1]:
            best_pos, best = len(sums), (i, s)
        sums.append([i, s])

    while sums:
        best_index = best[0]
        n_placed = n - len(sums)
        idxs = np.arange(len(remapping), dtype=np.int64)
        coeff = (n_placed - 1) - 2 * idxs
        delta = int((coeff * matrix[best_index, np.array(remapping)]).sum())
        if delta > 0:
            remapping.insert(0, best_index)
        else:
            remapping.append(best_index)
        sums[best_pos] = sums[-1]
        sums.pop()
        if sums:
            best_pos, best = 0, (0, 0)
            for i, entry in enumerate(sums):
                entry[1] += int(matrix[best_index, entry[0]])
                if entry[1] > best[1]:
                    best_pos, best = i, (entry[0], entry[1])
    return remapping


def apply_most_popular_first(indexed: np.ndarray, remapping: List[int]) -> List[int]:
    if not remapping or indexed.size == 0:
        return remapping
    counts = np.bincount(indexed, minlength=256)
    # Rust max_by_key keeps the LAST maximal element on ties (our Python
    # max() would keep the first) — reproduce for byte parity.
    pop_idx = remapping[0]
    for i in remapping:
        if counts[i] >= counts[pop_idx]:
            pop_idx = i
    if counts[pop_idx] < indexed.size * 3 // 20:
        return remapping
    pos = remapping.index(pop_idx)
    r = list(remapping)
    if pos >= len(r) // 2:
        r.reverse()
        k = (pos + 1) % len(r)
        r = r[-k:] + r[:-k] if k else r
    else:
        r = r[pos:] + r[:pos]
    return r


def optimize_palette_order(
    indexed: np.ndarray, palette: np.ndarray, width: int, height: int
) -> Tuple[np.ndarray, np.ndarray]:
    n = len(palette)
    if n <= 2:
        return indexed, palette
    matrix = build_co_occurrence(indexed, n, width, height)
    remapping = mzeng_reindex(n, matrix)
    remapping = apply_most_popular_first(indexed, remapping)
    new_palette = palette[np.array(remapping)]
    byte_map = np.zeros(256, dtype=np.uint8)
    for new_idx, old_idx in enumerate(remapping):
        byte_map[old_idx] = new_idx
    return byte_map[indexed], new_palette


def build_palette(
    pixels: np.ndarray, color_type: ColorType, width: int, height: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """[N, bpp] uint8 -> (indexed [N] uint8, palette [K, 4]) or None if >256."""
    if color_type not in (ColorType.RGB, ColorType.RGBA):
        return None

    def make_keys(px: np.ndarray) -> np.ndarray:
        k = (
            px[:, 0].astype(np.uint32) << 24
        ) | (px[:, 1].astype(np.uint32) << 16) | (px[:, 2].astype(np.uint32) << 8)
        if color_type == ColorType.RGB:
            return k | 255
        return k | px[:, 3].astype(np.uint32)

    # cheap early rejection: if even a strided sample exceeds 256 unique
    # colors, the full image certainly does. Key construction is deferred
    # to the sample too — building full-image keys first cost ~1.3 ms per
    # 512x512 on truecolor content that always rejects.
    if len(pixels) > _SAMPLE_CAP:
        sample_keys = make_keys(pixels[:: max(len(pixels) // _SAMPLE_CAP, 1)])
        if len(np.unique(sample_keys)) > 256:
            return None
    keys = make_keys(pixels)
    uniq, inv = np.unique(keys, return_inverse=True)
    if len(uniq) > 256:
        return None
    palette = np.stack(
        [(uniq >> 24) & 0xFF, (uniq >> 16) & 0xFF, (uniq >> 8) & 0xFF, uniq & 0xFF],
        axis=1,
    ).astype(np.uint8)
    indexed = inv.astype(np.uint8)
    return optimize_palette_order(indexed, palette, width, height)


def maybe_trim_transparency(alphas: np.ndarray) -> Optional[np.ndarray]:
    """Drop the tRNS chunk when fully opaque; trim trailing 255s otherwise.

    Parity: ``maybe_trim_transparency`` (``src/png/mod.rs:1888-1902``).
    """
    if (alphas == 255).all():
        return None
    last = len(alphas)
    while last > 0 and alphas[last - 1] == 255:
        last -= 1
    return alphas[:last]


@dataclasses.dataclass
class ReducedImage:
    data: bytes
    effective_color_type: ColorType
    color_type_byte: int
    bit_depth: int
    bytes_per_pixel: int
    palette: Optional[np.ndarray]  # [K, 4] uint8 or None
    # unpacked per-pixel samples when bit_depth < 8 (the packed rows in
    # ``data`` are width-aligned, so interlaced encoding needs the raw
    # samples to re-pack per Adam7 pass)
    samples: Optional[np.ndarray] = None


def maybe_reduce_color_type(
    pixels: np.ndarray,
    width: int,
    height: int,
    color_type: ColorType,
    reduce_color_type: bool,
    reduce_palette: bool,
) -> ReducedImage:
    """pixels: [N, bpp] uint8 (N = width*height)."""
    def passthrough():
        return ReducedImage(
            data=pixels.tobytes(),
            effective_color_type=color_type,
            color_type_byte=color_type.png_color_type,
            bit_depth=8,
            bytes_per_pixel=color_type.bytes_per_pixel,
            palette=None,
        )

    if color_type == ColorType.GRAY and reduce_color_type:
        return passthrough()  # parity: Gray keeps 8-bit here

    if reduce_palette:
        built = build_palette(pixels, color_type, width, height)
        if built is not None:
            indexed, palette = built
            bit_depth = palette_bit_depth(len(palette))
            packed = pack_bits_rows(indexed, width, bit_depth)
            return ReducedImage(
                data=packed,
                effective_color_type=ColorType.RGB,
                color_type_byte=3,
                bit_depth=bit_depth,
                bytes_per_pixel=max(bit_depth // 8, 1),
                palette=palette,
                samples=indexed if bit_depth < 8 else None,
            )

    if not reduce_color_type:
        return passthrough()

    if color_type == ColorType.RGB:
        if all_gray_rgb(pixels):
            gray = pixels[:, 0]
            bit_depth = reduce_gray_bit_depth(gray)
            packed = pack_bits_rows(gray, width, bit_depth)
            return ReducedImage(
                data=packed,
                effective_color_type=ColorType.GRAY,
                color_type_byte=0,
                bit_depth=bit_depth,
                bytes_per_pixel=max(bit_depth // 8, 1),
                palette=None,
                samples=gray if bit_depth < 8 else None,
            )
        return passthrough()

    if color_type == ColorType.RGBA:
        all_opaque, all_gray = analyze_rgba(pixels)
        if all_opaque and all_gray:
            gray = pixels[:, 0]
            bit_depth = reduce_gray_bit_depth(gray)
            packed = pack_bits_rows(gray, width, bit_depth)
            return ReducedImage(
                data=packed,
                effective_color_type=ColorType.GRAY,
                color_type_byte=0,
                bit_depth=bit_depth,
                bytes_per_pixel=max(bit_depth // 8, 1),
                palette=None,
                samples=gray if bit_depth < 8 else None,
            )
        if all_opaque:
            return ReducedImage(
                data=np.ascontiguousarray(pixels[:, :3]).tobytes(),
                effective_color_type=ColorType.RGB,
                color_type_byte=2,
                bit_depth=8,
                bytes_per_pixel=3,
                palette=None,
            )
        if all_gray:
            ga = np.ascontiguousarray(pixels[:, [0, 3]])
            return ReducedImage(
                data=ga.tobytes(),
                effective_color_type=ColorType.GRAY_ALPHA,
                color_type_byte=4,
                bit_depth=8,
                bytes_per_pixel=2,
                palette=None,
            )
        return passthrough()

    return passthrough()


def optimize_alpha(pixels: np.ndarray, color_type: ColorType) -> np.ndarray:
    """Zero color channels of fully transparent pixels (``:633-671``)."""
    out = pixels.copy()
    if color_type == ColorType.RGBA:
        mask = out[:, 3] == 0
        out[mask, :3] = 0
    elif color_type == ColorType.GRAY_ALPHA:
        mask = out[:, 1] == 0
        out[mask, 0] = 0
    return out
