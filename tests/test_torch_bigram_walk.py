"""Mode 7's (Bigrams') walk in the strip kernel, on the CPU.

``csrc/filter_bank.cu``'s ``count_pairs`` counts a row's distinct byte
pairs under one candidate filter in one sweep of a warp: lane l of step s
takes word k = 32s + l of the candidate (loads past the row's last word
take that word), computes it once, and takes the byte one on from word
k + 1, lane l + 1's, or for lane 31 the next step's lane 0's, computed a step
ahead. Bytes j of the two words are the pair that starts at byte 4k + j,
and instruction j of a step marks those pairs in a bitmap of 8 KB, key
``first << 8 | second`` at word key >> 5 and bit key & 31, counting the
bits each mark finds clear. A pair whose key equals the pair's just
before it (in the lane's word, or the lane before's last) does not mark
(``skip_runs``; ``chip_smoke.BIGRAM_PARTS`` times the kernel without it),
and its lane ORs 0 into its spare word instead; lane 0's first pair always
marks. After the sweep
the warp zeroes the bitmap. ``bigram_walk`` runs that walk in Python, lane
by lane, on rows staged as the kernel stages them (random bytes past a
row, masked left edges), and the tests hold its counts and chosen filters
to the JAX package's ``_bigram_scores`` and argmin and to the port's plain
version. The card tests hold the kernel to the plain version on the same
edge cases (``chip_smoke.bigram_edge_cases``).
"""

import numpy as np
import pytest
import torch

import jax

from pixo_tpu.ops import png_filters as jax_filters

from chip_smoke import BIGRAM_STEP, bigram_merge_cases
from pixo_tpu_torch.ops import png_filters

jax.config.update("jax_platforms", "cpu")

LANES = 32
WORDS = 2048  # the bitmap's 32-bit words: 8 KB


def pair_slot(key: int) -> tuple:
    """The kernel's pair_word and pair_bit."""
    return key >> 5, 1 << (key & 31)


def staged_candidates(rows: np.ndarray, bpp: int, rng) -> np.ndarray:
    """[H, RB] raw rows -> [H, 5, 4 * (last + 1)] candidate bytes as the
    kernel's words hold them: past byte rb - 1 of a row, its stream reads
    whatever lies there (random bytes here); left neighbours of bytes below
    bpp are masked to 0, and row 0 has no row above."""
    h, rb = rows.shape
    n = 4 * ((rb - 1) // 4 + 1)
    cands = np.empty((h, 5, n), np.int64)
    for y in range(h):
        x = np.concatenate([rows[y], rng.integers(0, 256, n - rb)]).astype(np.int64)
        up = (np.concatenate([rows[y - 1], rng.integers(0, 256, n - rb)]).astype(np.int64)
              if y else np.zeros(n, np.int64))
        i = np.arange(n)
        a = np.where(i >= bpp, x[np.maximum(i - bpp, 0)], 0)
        c = np.where(i >= bpp, up[np.maximum(i - bpp, 0)], 0)
        p = a + up - c
        pa, pb, pc = np.abs(p - a), np.abs(p - up), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, up, c))
        cands[y] = np.stack([x, x - a, x - up, x - (a + up) // 2, x - paeth]) & 0xFF
    return cands


def count_walk(cand: np.ndarray, rb: int, skip_runs: bool, stats: dict) -> int:
    """``count_pairs`` on one candidate row (its staged bytes ``cand``):
    the warp's sweep, a step at a time over its 32 lanes (the next step's
    words loaded ahead, clamped to the row's last word), then the sweep that
    clears the bitmap. Adds to ``stats`` the marks that set a bit
    (``marks``; a lane's OR of 0 into its spare word is not one) and the
    most lanes of an instruction that mark one bitmap word
    (``most_on_a_word``); checks that the bitmap is empty after the sweep."""
    pairs, last = rb - 1, (rb - 1) >> 2
    if pairs <= 0:
        return 0
    nk = (pairs + 3) >> 2
    words = cand.reshape(-1, 4)
    lanes = np.arange(LANES)
    bitmap = np.zeros(WORDS, np.int64)
    n = 0
    d = words[np.minimum(lanes, last)]
    for k0 in range(0, nk, LANES):
        nxt = words[np.minimum(k0 + LANES + lanes, last)]
        up = np.concatenate([d[1:, 0], nxt[:1, 0]])  # lane 31: the next step's lane 0
        e = np.concatenate([d[:, 1:], up[:, None]], axis=1)
        keys = d << 8 | e  # [lane, j]: the pair that starts at byte 4 (k0 + lane) + j
        left = np.concatenate([[-1], d[:-1, 3] << 8 | d[1:, 0]])  # lane 0's first pair always marks
        before = np.concatenate([left[:, None], keys[:, :3]], axis=1)
        live = np.minimum(4, pairs - 4 * (k0 + lanes))
        for j in range(4):
            on = (j < live) & ~(skip_runs & (keys[:, j] == before[:, j]))
            marked = keys[on, j]
            if marked.size:
                # the lanes' atomicOr, in any order: each distinct key's first finds its bit clear or set
                uniq = np.unique(marked)
                n += int((((bitmap[uniq >> 5] >> (uniq & 31)) & 1) == 0).sum())
                np.bitwise_or.at(bitmap, uniq >> 5, 1 << (uniq & 31))
                stats["marks"] += marked.size
                stats["most_on_a_word"] = max(stats["most_on_a_word"], int(np.bincount(marked >> 5).max()))
        d = nxt
    bitmap[:] = 0  # the sweep of 16-byte zero stores
    assert not bitmap.any()
    return n


def bigram_walk(rows: np.ndarray, bpp: int, skip_runs: bool = True, seed: int = 0):
    """The strip kernel's mode 7 on [H, RB] rows, row by row: ([H, 5] counts,
    [H] chosen filters (the fewest pairs, the lowest id on a tie), stats)."""
    h, rb = rows.shape
    cands = staged_candidates(rows, bpp, np.random.default_rng(seed))
    stats = {"marks": 0, "most_on_a_word": 0}
    counts = np.array([[count_walk(cands[y, f], rb, skip_runs, stats) for f in range(5)]
                       for y in range(h)], np.int64).reshape(h, 5)
    chosen = np.array([min(range(5), key=lambda f: (c[f], f)) for c in counts], np.int64)
    return counts, chosen, stats


def walk_cases(rng, bpp: int):
    """(label, [H, RB] uint8): rows of 1, 2, 3 and 5 bytes; rows at the
    first design's step boundaries 4 (2 + 32m) +- 1 and at this walk's,
    128m +- 1 and + 2; zeros; noise; ramps with ties."""
    ramp = (np.arange(3 * bpp + 41) % 256).astype(np.uint8)
    cases = [(f"rb {rb}", rng.integers(0, 256, (3, rb), dtype=np.uint8)) for rb in (1, 2, 3, 5)]
    cases += [(f"noise rb {rb}", rng.integers(0, 256, (2, rb), dtype=np.uint8))
              for m in (0, 1, 2) for rb in (4 * (2 + 32 * m) - 1, 4 * (2 + 32 * m) + 1)]
    cases += [(f"low noise rb {rb}", rng.integers(0, 4, (2, rb), dtype=np.uint8))
              for m in (1, 2) for rb in (BIGRAM_STEP * m - 1, BIGRAM_STEP * m + 1, BIGRAM_STEP * m + 2)]
    cases += [("zeros", np.zeros((3, 4 * bpp + 3), np.uint8)),
              ("noise", rng.integers(0, 256, (3, 301), dtype=np.uint8)),
              ("tied ramp", np.broadcast_to(ramp, (3, ramp.size)).copy())]
    return cases


def _jax_counts(rows: np.ndarray, bpp: int) -> np.ndarray:
    return np.asarray(jax_filters._bigram_scores(jax_filters._candidates(rows, bpp)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("skip_runs", [False, True])
@pytest.mark.parametrize("bpp", range(1, 9))
def test_walk_counts_equal_the_jax_scores(bpp, skip_runs, seed):
    """Every case's counts and chosen filters equal the JAX package's
    ``_bigram_scores`` and argmin and the port's plain version, whatever
    lies past the rows (``seed``)."""
    rng = np.random.default_rng(700 + bpp)
    for label, rows in walk_cases(rng, bpp):
        counts, chosen, _ = bigram_walk(rows, bpp, skip_runs, seed=seed)
        want = _jax_counts(rows, bpp)
        assert np.array_equal(counts, want), label
        assert np.array_equal(chosen, np.argmin(want, axis=1)), label
        plain = png_filters._bigram_scores(png_filters._candidates(torch.from_numpy(rows), bpp)).numpy()
        assert np.array_equal(counts, plain), label


@pytest.mark.parametrize("bpp", [1, 3, 4, 8])
def test_walk_on_the_cards_merge_cases(bpp):
    """``chip_smoke.bigram_merge_cases``, image by image, with and without
    the skipped runs: the walk's counts equal the JAX package's. On the rows
    of one key, and of one word with 32 keys, an instruction puts all 32
    lanes' marks on one bitmap word."""
    for label, imgs in bigram_merge_cases(np.random.default_rng(40 + bpp), bpp):
        for rows in imgs[:1]:
            want = _jax_counts(rows, bpp)
            for skip_runs in (False, True):
                counts, chosen, stats = bigram_walk(rows, bpp, skip_runs)
                assert np.array_equal(counts, want), (label, skip_runs)
                assert np.array_equal(chosen, np.argmin(want, axis=1)), (label, skip_runs)
                if "one key" in label or "one word" in label:
                    assert stats["most_on_a_word"] == LANES, (label, skip_runs)


def test_step_boundary_cases_tie_where_a_count_one_off_shows():
    """The boundary rows' second row ties its two fewest counts, and one
    pair more on the winner would change the filter chosen."""
    for bpp in (1, 3, 4, 8):
        for label, imgs in bigram_merge_cases(np.random.default_rng(40 + bpp), bpp):
            if "step boundaries" not in label:
                continue
            for img in imgs:
                counts = _jax_counts(img, bpp)[1]
                best = int(np.argmin(counts))
                bumped = counts.copy()
                bumped[best] += 1
                assert int(np.argmin(bumped)) != best, (label, bpp)


def test_skipped_runs_mark_once_a_step():
    """A row of zeros marks once a candidate with the runs skipped (lane 0's
    first pair of the first step; later steps' lane 0 finds the bit set),
    and every row of the all-zero image counts one pair."""
    rows = np.zeros((2, 300), np.uint8)
    counts, chosen, stats = bigram_walk(rows, 3)
    assert counts.tolist() == [[1] * 5, [1] * 5] and chosen.tolist() == [0, 0]
    steps = -(-299 // 4 // LANES)
    assert stats["marks"] == 2 * 5 * steps
    _, _, every = bigram_walk(rows, 3, skip_runs=False)
    assert every["marks"] == 2 * 5 * 299
