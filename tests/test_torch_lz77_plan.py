"""The decompositions of the LZ77 route's kernels, on the CPU.

``csrc/lz77.cu``'s ``chain_candidates`` sorts the positions 0..n-4 by hash
in two stable 8-bit counting passes over tiles of 4096 positions (the
[256, tiles] counts scanned a bin a CTA, each bin's first slot from the 256
totals), then writes the rows: a CTA a tile of 512 sorted indices, staged with
the 32 before them, the first 16 bytes of each one's position and its run
of one byte, a group of lanes a sorted index, a lane a candidate, its
length from the two runs where they decide it, else from the staged bytes
and past them 16 bytes a step where 276 bytes remain
(``chain_plan`` gives the shapes). ``sort_model`` and
``rows_model`` run those walks in Python, and the tests hold them to
``chain_candidates_plain`` and to the JAX package's ``chain_candidates``.

``csrc/adler32.cu`` splits the bytes into one contiguous share a CTA
(``compress/checksums.py::adler32_plan``), sums each share's 16-byte chunks
thread by thread in closed form (a chunk's term w + s * after), reduces
each thread's sums mod 65521, and lets the CTA with the last ticket combine
the shares' runs. ``adler_model`` runs that walk in Python, with the
kernel's integer widths, against ``zlib.adler32`` and the JAX package's
``adler32_jnp``. The card tests hold both kernels to their plain versions.
"""

import zlib
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixo_tpu.compress.checksums import adler32_jnp
from pixo_tpu.ops import lz77_assist as jax_lz77

import chip_smoke
from pixo_tpu_torch.compress import checksums
from pixo_tpu_torch.ops import lz77_assist as lz

jax.config.update("jax_platforms", "cpu")

ADLER_MOD = 65521
THREADS = 256  # the kernels' CTA width
SORT_TILE = chip_smoke.LZ77_SORT_TILE  # csrc/lz77.cu's kSortTile: positions a tile of the chain sort
ROW_TILE = chip_smoke.LZ77_ROW_TILE  # its kRowTile: sorted indices a CTA of the rows' kernel
STAGE_BACK = 32  # its kStageBack: sorted indices that CTA stages before its tile
FAST_ROOM = 276  # csrc/lz77.cu's kFastRoom
WINDOW = 16  # its kWindow: bytes of each staged position


# ---------------------------------------------------------------- Adler-32

def adler_model(data: np.ndarray, start: int, slots: int) -> int:
    """``csrc/adler32.cu``'s walk of ``data`` on ``slots`` CTA slots: each
    CTA's share, its threads' chunks and ragged bytes, each thread's sums in
    the kernel's widths (a 32-bit sum, a 64-bit weighted sum), the runs, and
    the last CTA's combine."""
    n = len(data)
    grid, share = checksums.adler32_plan(n, slots)
    runs = []
    for cta in range(grid):
        lo = cta * share
        ln = min(share, n - lo)
        chunks = ln // 16
        d = data[lo:lo + 16 * chunks].astype(np.uint64).reshape(chunks, 16)
        cs = d.sum(1)
        cq = (d * np.arange(16, dtype=np.uint64)).sum(1)
        after = (ln - 16 * np.arange(chunks) - 16).astype(np.uint64)
        thread = np.arange(chunks) % THREADS
        terms = cs * (after + 16) - cq
        s = np.bincount(thread, cs, THREADS).astype(np.uint64)  # exact: below 2^53
        w = np.zeros(THREADS, np.uint64)
        np.add.at(w, thread, terms)
        w_bound = np.bincount(thread, terms.astype(np.float64), THREADS)
        for t, x in enumerate(data[lo + 16 * chunks:lo + ln].tolist()):  # the ragged end
            s[t] += x
            w[t] += np.uint64(x * (ln - 16 * chunks - t))
            w_bound[t] += x * (ln - 16 * chunks - t)
        assert int(s.max()) < 2**32 and w_bound.max() < 2**63  # the kernel's widths, none wrapped
        runs.append((sum(int(v) % ADLER_MOD for v in s) % ADLER_MOD,
                     sum(int(v) % ADLER_MOD for v in w) % ADLER_MOD))
    ts = sum(r[0] for r in runs)
    tw = sum(r[1] + r[0] * ((n - min((i + 1) * share, n)) % ADLER_MOD) for i, r in enumerate(runs))
    a0, b0 = start & 0xFFFF, start >> 16
    a = (a0 + ts) % ADLER_MOD
    b = (b0 + (n % ADLER_MOD) * a0 + tw) % ADLER_MOD
    return (b << 16) | a


@pytest.mark.parametrize("slots", [1, 3, 132 * 8])
@pytest.mark.parametrize("n", [1, 2, 4096, 10_000, 1 << 20, (1 << 24) + 17])
def test_adler32_plan_covers_each_byte_once(n, slots):
    grid, share = checksums.adler32_plan(n, slots)
    assert share % 16 == 0
    assert checksums.ADLER_MIN_SHARE <= share <= checksums.ADLER_MAX_SHARE
    assert (grid - 1) * share < n <= grid * share
    assert grid <= max(slots, -(-n // checksums.ADLER_MAX_SHARE))


def test_adler32_plan_fills_the_card_and_keeps_the_sums_exact():
    assert checksums.adler32_plan(1 << 24, 1056) == (1056, 15888)
    assert checksums.adler32_plan(100, 1056) == (1, checksums.ADLER_MIN_SHARE)
    assert checksums.adler32_plan(1 << 30, 1) == (64, 1 << 24)  # at most ADLER_MAX_SHARE a CTA
    with pytest.raises(ValueError):
        checksums.adler32_plan(0, 8)
    with pytest.raises(ValueError):
        checksums.adler32_plan(8, 0)


@pytest.mark.parametrize("slots", [1, 5, 1056])
@pytest.mark.parametrize("n", [n for n in chip_smoke.ADLER_SIZES if 0 < n < 1 << 24]
                         + list(chip_smoke.adler_boundary_sizes(7)[:3]))
def test_adler_model_equals_zlib_and_jax(n, slots):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    data[::3] = 255
    for start in chip_smoke.ADLER_STARTS:
        want = zlib.adler32(data.tobytes(), start)
        assert adler_model(data, start, slots) == want
    assert adler_model(data, 1, slots) == int(adler32_jnp(jnp.asarray(data), 1))


def test_adler_model_of_16_mib_of_255s_on_the_cards_grid():
    """The largest sums a share can take, on the H100's 1056 slots (132 SMs,
    8 CTAs each) and on a card of one slot (shares of 2^24 bytes)."""
    data = np.full((1 << 24) + 17, 255, np.uint8)
    want = zlib.adler32(data.tobytes(), 0x12345678)
    assert adler_model(data, 0x12345678, 1056) == want
    assert adler_model(data, 0x12345678, 1) == want


# ---------------------------------------------------------------- the chain

class ChainPlan(NamedTuple):
    """How ``csrc/lz77.cu`` takes ``chain_candidates`` at n bytes and k."""

    sorted: int  # positions the sort takes: 0..n-4
    sort_tiles: int  # tiles of SORT_TILE positions, a CTA each in the counting passes
    row_ctas: int  # CTAs of the rows' kernel, ROW_TILE sorted indices each (at least 1)
    group: int  # lanes a sorted index: k up to a power of two, at most 32
    workspace: int  # int32 words: hashes, two keys and two values, [256, tiles] counts, 256 totals


def chain_plan(n: int, k: int) -> ChainPlan:
    """The launch shapes and workspace of ``pixo_chain_candidates`` at ``n``
    bytes and ``k`` candidates, as the C function computes them."""
    m = max(n - 3, 0)
    tiles = -(-m // SORT_TILE)
    group = 1
    while group < min(k, 32):
        group *= 2
    return ChainPlan(m, tiles, max(-(-m // ROW_TILE), 1), group, 5 * m + 256 * tiles + 256)


def sort_model(keys: np.ndarray):
    """The two counting passes of ``chain_candidates`` over the keys of the
    positions 0..m-1: per pass the tiles' digit counts [256, tiles], each
    bin's row scanned in rounds of 256 tiles with a carry (its total
    kept), each bin's first slot the scan of the totals, and each tile's
    elements in position order from its offsets. Returns (skey, spos)."""
    m = len(keys)
    tile = SORT_TILE
    tiles = -(-m // tile)
    k_in, v_in = keys.astype(np.int64), np.arange(m)
    for shift in (0, 8):
        digit = (k_in >> shift) & 255
        counts = np.zeros((256, tiles), np.int64)
        np.add.at(counts, (digit, np.arange(m) // tile), 1)
        offsets, totals = np.zeros_like(counts), np.zeros(256, np.int64)
        for b in range(256):
            carry = 0
            for base in range(0, tiles, THREADS):
                v = counts[b, base:base + THREADS]
                offsets[b, base:base + THREADS] = carry + np.cumsum(v) - v
                carry += int(v.sum())
            totals[b] = carry
        first = np.cumsum(totals) - totals
        k_out, v_out = np.full(m, -1), np.full(m, -1)
        for t in range(tiles):
            running = first + offsets[:, t]
            for i in range(t * tile, min((t + 1) * tile, m)):
                dest = running[digit[i]]
                assert k_out[dest] == -1
                k_out[dest], v_out[dest] = k_in[i], v_in[i]
                running[digit[i]] += 1
        k_in, v_in = k_out, v_out
    return k_in, v_in


def chain_len_model(d: np.ndarray, p: int, c: int, max_len: int) -> int:
    """``chain_len``: 16 bytes a step while p + 276 <= n (the words it
    loads lie below n), else ``match_len``'s byte semantics."""
    n = len(d)
    if p + FAST_ROOM > n:
        for j in range(max_len):
            if p + j >= n or d[p + j] != d[min(c + j, n - 1)]:
                return j
        return max_len
    for j in range(0, max_len, 16):
        diff = np.nonzero(d[p + j:p + j + 16] != d[c + j:c + j + 16])[0]
        if len(diff):
            return min(j + int(diff[0]), max_len)
    return max_len


def run_model(d: np.ndarray, p: int) -> int:
    """The bytes from p equal to d[p], at most 258 and up to n: a staged
    position's run (``chain_rows_kernel``: from its window, and past it 16
    lanes of 16 bytes each)."""
    seg = d[p:p + 258]
    diff = np.nonzero(seg != seg[0])[0]
    return int(diff[0]) if len(diff) else len(seg)


def cand_len_model(d: np.ndarray, win_p: np.ndarray, win_c: np.ndarray, run_p: int, run_c: int,
                   p: int, c: int) -> int:
    """``cand_len``: where p and c start with one byte and their runs differ
    (or both reach 258), the shorter run; else the first 16 bytes from the
    staged windows of p and c (zero past n) and, where all 16 match, the
    rest from ``chain_len`` at p + 16; at most 258 and n - p."""
    if win_p[0] == win_c[0] and (run_p != run_c or run_p == 258):
        return min(run_p, run_c)
    limit = min(258, len(d) - p)
    diff = np.nonzero(win_p != win_c)[0]
    m = int(diff[0]) if len(diff) else WINDOW
    if m == WINDOW and limit > WINDOW:
        m += chain_len_model(d, p + WINDOW, c + WINDOW, 258 - WINDOW)
    return min(m, limit)


def rows_model(d: np.ndarray, skey: np.ndarray, spos: np.ndarray, k: int):
    """The rows' kernel on the sorted (skey, spos): each CTA's staged window
    of sorted indices (the 32 before its tile at most) with the first 16
    bytes of each one's position and its run, its groups of
    ``chain_plan``'s lanes a sorted index, a lane's candidates j, j +
    group, ... from the window
    where they lie in it (the length from the staged bytes first), else
    from the sorted arrays (the length from ``chain_len``); then the tail
    rows. Each table entry must be written once."""
    n = len(d)
    padded = np.concatenate([d, np.zeros(WINDOW, np.uint8)])
    plan = chain_plan(n, k)
    m, group = plan.sorted, plan.group
    cand = np.zeros((n, k), np.int64)
    lens = np.zeros((n, k), np.int64)
    written = np.zeros((n, k), np.int64)
    for cta in range(plan.row_ctas):
        i0 = cta * ROW_TILE
        lo = max(i0 - min(k, STAGE_BACK), 0)
        hi = min(i0 + ROW_TILE, m)
        s_key, s_pos = skey[lo:hi], spos[lo:hi]
        s_win = [padded[q:q + WINDOW] for q in s_pos]
        s_run = [run_model(d, int(q)) for q in s_pos]
        for g in range(THREADS // group):
            for i in range(i0 + g, hi, THREADS // group):
                key, p = s_key[i - lo], int(s_pos[i - lo])
                for lane in range(group):
                    for j in range(lane, k, group):
                        at = i - 1 - j
                        c, length = -1, 0
                        if at >= lo:
                            assert at - lo < len(s_key)
                            if s_key[at - lo] == key:
                                c = int(s_pos[at - lo])
                                length = cand_len_model(d, s_win[i - lo], s_win[at - lo], s_run[i - lo],
                                                        s_run[at - lo], p, c)
                        elif at >= 0 and skey[at] == key:  # past the staged window: k > 32
                            c = int(spos[at])
                            length = chain_len_model(d, p, c, 258)
                        cand[p, j], lens[p, j] = c, length
                        written[p, j] += 1
    cand[m:], lens[m:] = -1, 0  # the last CTA's tail rows
    written[m:] += 1
    assert (written == 1).all()
    return cand, lens


def _chain_inputs():
    rng = np.random.default_rng(20)
    cases = chip_smoke.lz77_edge_cases(rng)
    cases["2 sort tiles and 5 bytes of values 0-3"] = rng.integers(0, 4, 2 * SORT_TILE + 5, dtype=np.uint8)
    cases["zeros, 1500 bytes"] = np.zeros(1500, np.uint8)
    return cases


CHAIN_INPUTS = _chain_inputs()


def test_chain_plan_shapes():
    assert chain_plan(786_944, 16) == (786_941, 193, 1537, 16, 5 * 786_941 + 256 * 193 + 256)
    assert [chain_plan(100, k).group for k in (1, 2, 3, 4, 5, 16, 17, 32, 33, 1000)] == \
        [1, 2, 4, 4, 8, 16, 32, 32, 32, 32]
    assert chain_plan(3, 16)[:3] == (0, 0, 1)  # no sorted index: one CTA writes the tail rows


@pytest.mark.parametrize("name", list(CHAIN_INPUTS))
def test_sort_model_is_the_stable_sort_by_hash(name):
    data = CHAIN_INPUTS[name]
    keys = lz.hash4_plain(torch.from_numpy(data.copy())).numpy()[:len(data) - 3]
    skey, spos = sort_model(keys)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(spos, order) and np.array_equal(skey, keys[order])


# The two longest cases (about 65 s each in one process) run from
# tests/test_torch_lz77_rows.py, so that xdist's whole-file scheduling can
# give them a worker of their own.
SLOW_ROWS_CASES = [("runs of 1 to 299 bytes of values 0-3", 16), ("runs of 1 to 299 bytes of values 0-3", 33)]
ROWS_CASES = [(name, k) for k in (1, 5, 16, 33) for name in CHAIN_INPUTS
              if (name, k) not in SLOW_ROWS_CASES]


def rows_model_equals_plain(name, k):
    data = CHAIN_INPUTS[name]
    keys = lz.hash4_plain(torch.from_numpy(data.copy())).numpy()[:len(data) - 3]
    cand, lens = rows_model(data, *sort_model(keys), k)
    ref_cand, ref_lens = lz.chain_candidates_plain(torch.from_numpy(data.copy()), k)
    assert np.array_equal(cand, ref_cand.numpy())
    assert np.array_equal(lens, ref_lens.numpy())


@pytest.mark.parametrize("name, k", ROWS_CASES, ids=[f"{name}-{k}" for name, k in ROWS_CASES])
def test_rows_model_equals_plain(name, k):
    rows_model_equals_plain(name, k)


@pytest.mark.parametrize("name", ["buckets of 1, 2, 4, 5, 16 and 17 positions", "n = 1539, values 0-3"])
def test_rows_model_equals_jax(name):
    data = CHAIN_INPUTS[name]
    keys = lz.hash4_plain(torch.from_numpy(data.copy())).numpy()[:len(data) - 3]
    cand, lens = rows_model(data, *sort_model(keys), 16)
    ref_cand, ref_lens = jax_lz77.chain_candidates(jnp.asarray(data), k=16)
    assert np.array_equal(cand, np.asarray(ref_cand)) and np.array_equal(lens, np.asarray(ref_lens))
