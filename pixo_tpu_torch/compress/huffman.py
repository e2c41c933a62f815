"""DEFLATE-side Huffman code construction (Python surface).

Copied from the JAX package's ``compress/huffman.py`` (capability parity
with pixo ``src/compress/huffman.rs``): code lengths under a hard length
limit (``build_code_lengths`` and its native hook), canonical code
assignment and the fixed literal/distance tables. The JPEG encode's optimal
tables use ``build_code_lengths`` (``jpeg/tables.py::build_bits_vals_optimal``);
the DEFLATE streams are the host library's own, and the rest is the
inspectable surface. Length limiting uses package-merge (provably optimal
under the limit and always Kraft-complete).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _native_build(freqs: Sequence[int], max_len: int):
    """C++ counting-form package-merge (native ``huffman_build_lengths``):
    tie-for-tie identical to the Python implementation below. None when the
    library declines the histogram; the Python path then decides."""
    from ..native import native_build_code_lengths

    return native_build_code_lengths(freqs, max_len)


def build_code_lengths(
    freqs: Sequence[int], max_len: int = 15
) -> np.ndarray:
    """Length-limited optimal code lengths via package-merge.

    Returns uint8 lengths per symbol (0 = unused). Alphabets with a single
    used symbol get a dummy second 1-bit code (DEFLATE decoders reject
    incomplete codes for the literal and code-length alphabets).
    """
    n = len(freqs)
    lengths = np.zeros(n, np.uint8)
    items = [(int(f), s) for s, f in enumerate(freqs) if f > 0]
    if not items:
        return lengths
    if len(items) == 1:
        sym = items[0][1]
        lengths[sym] = 1
        lengths[1 if sym == 0 else 0] = 1
        return lengths
    nat = _native_build(freqs, max_len)
    if nat is not None:
        return nat
    items.sort()
    m = len(items)

    def fresh() -> List[Tuple[int, Tuple[int, ...]]]:
        return [(w, (s,)) for w, s in items]

    cur = fresh()
    for _ in range(1, max_len):
        packages = [
            (cur[i][0] + cur[i + 1][0], cur[i][1] + cur[i + 1][1])
            for i in range(0, len(cur) - 1, 2)
        ]
        base = fresh()
        merged: List[Tuple[int, Tuple[int, ...]]] = []
        a = b = 0
        while a < len(base) or b < len(packages):
            if b >= len(packages) or (a < len(base) and base[a][0] <= packages[b][0]):
                merged.append(base[a])
                a += 1
            else:
                merged.append(packages[b])
                b += 1
        cur = merged
    for _, syms in cur[: 2 * m - 2]:
        for s in syms:
            lengths[s] += 1
    return lengths


def generate_canonical_codes(lengths: Sequence[int]) -> np.ndarray:
    """Canonical code values (MSB-first numbering) per symbol."""
    lengths = np.asarray(lengths, np.uint8)
    codes = np.zeros(len(lengths), np.uint16)
    bl_count = np.bincount(lengths, minlength=17)
    bl_count[0] = 0
    next_code = np.zeros(17, np.uint32)
    code = 0
    for b in range(1, 17):
        code = (code + int(bl_count[b - 1])) << 1
        next_code[b] = code
    for s, ln in enumerate(lengths):
        if ln:
            codes[s] = next_code[ln]
            next_code[ln] += 1
    return codes


def reverse_bits(code: int, length: int) -> int:
    """Bit-reverse for DEFLATE's LSB-first transmission order."""
    out = 0
    for _ in range(length):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


def build_codes(
    freqs: Sequence[int], max_len: int = 15
) -> Tuple[np.ndarray, np.ndarray]:
    """(lengths, LSB-first codes) — the full encoder-side pipeline."""
    lengths = build_code_lengths(freqs, max_len)
    canon = generate_canonical_codes(lengths)
    codes = np.array(
        [reverse_bits(int(c), int(l)) for c, l in zip(canon, lengths)], np.uint16
    )
    return lengths, codes


def fixed_literal_lengths() -> np.ndarray:
    """RFC 1951 fixed literal/length code lengths (288 symbols)."""
    out = np.empty(288, np.uint8)
    out[:144] = 8
    out[144:256] = 9
    out[256:280] = 7
    out[280:] = 8
    return out


def fixed_distance_lengths() -> np.ndarray:
    return np.full(30, 5, np.uint8)
