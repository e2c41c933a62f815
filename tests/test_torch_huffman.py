"""The optimized-Huffman pieces of the port against the JAX package, on the CPU.

- The symbol count: ``ops/kernels.py::count_symbols`` on a CPU tensor takes
  its plain version (``ops/huffman_device.py::count_symbols_plain``), which
  the card tests hold the kernel to. It is held, integer for integer, to the
  JAX package's ``count_symbols_device`` (jit on the CPU), to the native
  ``jpeg_count_symbols`` and to the Python ``packer.count_symbols``, on the
  edge blocks of ``chip_smoke.count_edge_blocks`` under every MCU pattern
  and restart interval, and by a property over seeded random blocks.
- The count kernel's predictor rule (``count_layout``) against
  ``_prev_block_index``.
- The table builders (``optimized_from_counts``, ``build_bits_vals``,
  ``build_bits_vals_optimal``, package-merge ``build_code_lengths``)
  against the JAX package's on the same histograms, including one-symbol,
  empty and overflowing ones.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from pixo_tpu.compress import huffman as jhuffman
from pixo_tpu.jpeg import tables as jtables
from pixo_tpu.jpeg.packer import count_symbols as jax_packer_count
from pixo_tpu.ops.huffman_device import count_symbols_device

from chip_smoke import COUNT_PATTERNS, count_edge_blocks
from pixo_tpu_torch.compress import huffman
from pixo_tpu_torch.jpeg import packer, tables
from pixo_tpu_torch.native import native_count_symbols
from pixo_tpu_torch.ops import huffman_device, kernels

jax.config.update("jax_platforms", "cpu")

RESTARTS = [None, 1, 2, 7]


def _per_image(zz, pattern, ri):
    """The port's count of [B, N, 64] as one 4-tuple of numpy arrays an image."""
    dc, ac = kernels.count_symbols(torch.from_numpy(zz), pattern, ri)
    return [(dc[i, 0].numpy(), dc[i, 1].numpy(), ac[i, 0].numpy(), ac[i, 1].numpy())
            for i in range(zz.shape[0])]


def _equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x, np.int64), np.asarray(y, np.int64)) for x, y in zip(a, b))


def _random_blocks(rng, n, density=0.2, amp=60):
    zz = rng.integers(-amp, amp + 1, (n, 64)) * (rng.random((n, 64)) < density)
    zz[:, 0] = rng.integers(-1024, 1024, n)
    return zz.astype(np.int16)


@pytest.mark.parametrize("ri", RESTARTS)
@pytest.mark.parametrize("mode", list(COUNT_PATTERNS))
def test_count_equals_jax_native_and_packer_on_edge_blocks(mode, ri):
    """Edge blocks (ZRL runs, no EOB, all-zero blocks, powers of two, DC
    category 11) as two images under each pattern: the port's count equals
    the JAX jit count, the native count and the Python count, image by
    image. One block count, so the JAX jit compiles once."""
    pattern = COUNT_PATTERNS[mode]
    rng = np.random.default_rng(5)
    zz = np.stack([count_edge_blocks(rng), count_edge_blocks(rng)[::-1].copy()])
    for i, got in enumerate(_per_image(zz, pattern, ri)):
        assert _equal(got, count_symbols_device(zz[i], pattern, ri))
        assert _equal(got, native_count_symbols(zz[i], pattern, ri))
        assert _equal(got, packer.count_symbols(zz[i], pattern, ri))
    dc, ac = kernels.count_symbols(torch.from_numpy(zz), pattern, ri)
    assert dc.dtype == ac.dtype == torch.int64
    assert dc.shape == (2, 2, 12) and ac.shape == (2, 2, 256)


def test_edge_blocks_reach_every_edge():
    """The edge blocks hold what they claim: ZRL splits, runs ending on a
    nonzero last AC, all-zero blocks and DC differences of category 11."""
    zz = count_edge_blocks(np.random.default_rng(5))
    dc_lum, _, ac_lum, _ = packer.count_symbols(zz, (0,), None)
    assert ac_lum[0xF0] >= 5 and dc_lum[11] > 0
    assert (zz[:, 63] != 0).any() and (~zz[:, 1:].any(axis=1)).sum() >= 4
    assert {int(abs(v)) for v in zz[:, 1:].ravel()} >= {1023, 1024, 2047}


@pytest.mark.parametrize("mode,n,ri", [("420", 6, 1), ("444", 90, 7), ("gray", 1, None)])
def test_count_equals_jax_on_random_blocks(mode, n, ri):
    pattern = COUNT_PATTERNS[mode]
    zz = _random_blocks(np.random.default_rng(n), 3 * n * len(pattern)).reshape(3, -1, 64)
    for i, got in enumerate(_per_image(zz, pattern, ri)):
        assert _equal(got, count_symbols_device(zz[i], pattern, ri))
        assert _equal(got, jax_packer_count(zz[i], pattern, ri))


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), mode=st.sampled_from(list(COUNT_PATTERNS)),
       mcus=st.integers(1, 12), ri=st.sampled_from(RESTARTS + [3, 5]),
       density=st.sampled_from([0.0, 0.05, 0.3, 1.0]))
def test_count_property_equals_native_and_packer(seed, mode, mcus, ri, density):
    pattern = COUNT_PATTERNS[mode]
    rng = np.random.default_rng(seed)
    zz = _random_blocks(rng, 2 * mcus * len(pattern), density, amp=int(rng.integers(1, 2048)))
    zz = zz.reshape(2, -1, 64)
    for i, got in enumerate(_per_image(zz, pattern, ri)):
        assert _equal(got, native_count_symbols(zz[i], pattern, ri))
        assert _equal(got, packer.count_symbols(zz[i], pattern, ri))


def test_count_front_returns_the_reference_tuple():
    zz = count_edge_blocks(np.random.default_rng(1))
    got = huffman_device.count_symbols(zz, COUNT_PATTERNS["420"], 2, device="cpu")
    assert len(got) == 4 and all(isinstance(a, np.ndarray) and a.dtype == np.int64 for a in got)
    assert _equal(got, native_count_symbols(zz, COUNT_PATTERNS["420"], 2))


@pytest.mark.parametrize("ri", [None, 1, 2, 3, 7])
@pytest.mark.parametrize("mode", list(COUNT_PATTERNS))
def test_count_layout_gives_the_reference_predictors(mode, ri):
    """The kernel's predictor rule over ``count_layout``'s slot table names
    the block ``_prev_block_index`` names, for every block."""
    pattern = COUNT_PATTERNS[mode]
    slots = kernels.count_layout(pattern)
    bpm, n = len(pattern), 30 * len(pattern)
    want = huffman_device._prev_block_index(n, pattern, ri)
    for j in range(n):
        m, k = divmod(j, bpm)
        cls, prev, last = (int(v) for v in slots[k])
        assert cls == (pattern[k] != 0)
        if prev >= 0:
            got = j - k + prev
        elif m > 0 and (ri is None or m % ri):
            got = (m - 1) * bpm + last
        else:
            got = -1
        assert got == want[j], (j, got, want[j])


def test_count_drops_dc_differences_past_category_11():
    """Outside a baseline scan's range the DC category counts in no bin, as
    the reference's scatter drops it; the AC counts are unaffected."""
    zz = np.zeros((1, 2, 64), np.int16)
    zz[0, :, 0] = (-20000, 20000)
    dc, ac = kernels.count_symbols(torch.from_numpy(zz), (0,))
    ref = count_symbols_device(zz[0], (0,), None)
    assert int(dc.sum()) == 0 == int(ref[0].sum())
    assert int(ac[0, 0, 0]) == 2


def test_count_wrapper_refuses_what_it_does_not_take():
    zz = torch.zeros((1, 6, 64), dtype=torch.int16)
    with pytest.raises(TypeError):
        kernels.count_symbols(zz.int(), (0,))
    with pytest.raises(ValueError):
        kernels.count_symbols(zz[:, :5], COUNT_PATTERNS["420"])  # not a whole MCU
    with pytest.raises(ValueError):
        kernels.count_symbols(zz, (0, 3))
    with pytest.raises(ValueError):
        kernels.count_symbols(zz, (0,), 0)
    with pytest.raises(ValueError):
        kernels.count_symbols(zz.reshape(1, 3, 128), (0,))
    with pytest.raises(ValueError):
        kernels.count_symbols(torch.zeros((1, 6, 64, 2), dtype=torch.int16)[..., 0], (0,))


# ---- the table builders


def _histograms():
    rng = np.random.default_rng(11)
    dc = np.zeros(12, np.int64)
    dc[:9] = rng.integers(1, 500, 9)
    ac = np.zeros(256, np.int64)
    ac[rng.choice(256, 160, replace=False)] = rng.integers(1, 3000, 160)
    one_dc = np.zeros(12, np.int64)
    one_dc[3] = 17
    one_ac = np.zeros(256, np.int64)
    one_ac[0] = 5
    fib = np.zeros(256, np.int64)  # Fibonacci counts: a tree deeper than 16
    a, b = 1, 1
    for s in range(24):
        fib[s] = a
        a, b = b, a + b
    return {"typical": (dc, ac), "one symbol": (one_dc, one_ac), "empty": (np.zeros(12, np.int64),
            np.zeros(256, np.int64)), "overflow": (dc, fib), "flat": (np.ones(12, np.int64),
            np.r_[np.ones(200, np.int64), np.zeros(56, np.int64)])}


HIST = _histograms()


@pytest.mark.parametrize("kind", list(HIST))
def test_bits_vals_builders_equal_jax(kind):
    for counts in HIST[kind]:
        assert tables.build_bits_vals(counts) == jtables.build_bits_vals(counts)
        assert tables.build_bits_vals_optimal(counts) == jtables.build_bits_vals_optimal(counts)
        lengths = tables.build_code_lengths(counts)
        ref = jtables.build_code_lengths(counts)
        assert (lengths is None) == (ref is None)
        if ref is not None:
            assert np.array_equal(lengths, ref)
    if kind == "overflow":
        assert tables.build_bits_vals(HIST[kind][1]) is None
        assert tables.build_bits_vals_optimal(HIST[kind][1]) is not None
    if kind == "empty":
        assert tables.build_bits_vals(HIST[kind][0]) is None
        assert tables.build_bits_vals_optimal(HIST[kind][0]) is None


_TABLE_FIELDS = ("dc_lum_bits", "dc_lum_vals", "dc_chrom_bits", "dc_chrom_vals", "ac_lum_bits",
                 "ac_lum_vals", "ac_chrom_bits", "ac_chrom_vals", "dc_lum_codes", "dc_lum_lengths",
                 "dc_chrom_codes", "dc_chrom_lengths", "ac_lum_codes", "ac_lum_lengths",
                 "ac_chrom_codes", "ac_chrom_lengths")


def _same_tables(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return all(np.array_equal(np.frombuffer(x, np.uint8) if isinstance(x, bytes) else x,
                              np.frombuffer(y, np.uint8) if isinstance(y, bytes) else y)
               for x, y in ((getattr(a, f), getattr(b, f)) for f in _TABLE_FIELDS))


@pytest.mark.parametrize("optimal", [False, True])
@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("lum,chrom", [("typical", "typical"), ("typical", "one symbol"),
                                       ("one symbol", "typical"), ("typical", "overflow"),
                                       ("overflow", "typical"), ("empty", "typical"),
                                       ("flat", "empty")])
def test_optimized_from_counts_equals_jax(lum, chrom, gray, optimal):
    (dl, al), (dcr, acr) = HIST[lum], HIST[chrom]
    args = (dl, None if gray else dcr, al, None if gray else acr)
    got = tables.HuffmanTables.optimized_from_counts(*args, optimal=optimal)
    ref = jtables.HuffmanTables.optimized_from_counts(*args, optimal=optimal)
    assert _same_tables(got, ref)
    assert got is None or not got.counted_from_scans


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("max_len", [7, 15, 16])
def test_package_merge_lengths_equal_jax(monkeypatch, native, max_len):
    """Package-merge lengths equal the JAX package's, through the host
    library and through the Python path (the native hook declined)."""
    if not native:
        monkeypatch.setattr(huffman, "_native_build", lambda freqs, max_len: None)
        monkeypatch.setattr(jhuffman, "_native_build", lambda freqs, max_len: None)
    rng = np.random.default_rng(max_len)
    cases = [rng.integers(0, 1000, 40), np.r_[np.zeros(5, int), 9], np.ones(2, int),
             np.array([2**i for i in range(20)]), rng.zipf(1.5, 100).clip(0, 10**6)]
    for freqs in cases:
        assert np.array_equal(huffman.build_code_lengths(freqs, max_len),
                              jhuffman.build_code_lengths(freqs, max_len))
