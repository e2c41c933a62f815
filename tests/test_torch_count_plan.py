"""The symbol-count kernel's decomposition, on the CPU.

``csrc/huffman.cu`` splits a batch's flattened blocks into one contiguous
share a CTA (``ops/kernels.py::count_plan``), walks each share in passes of
up to 128 blocks (a step of 16 a warp) cut where an image ends, keeps the
MCU, slot and place in its restart segment of each pass's blocks from pass
to pass (in the DC lanes), loads each block's DC predictor by an index,
counts into the CTA's row, and adds the row to its image's counts (zeroed
before the launch) at each image end and share end. ``count_model`` runs
that walk in Python, lane by lane, and the tests hold it to
``count_symbols_plain`` and to the JAX package's ``count_symbols_device``
under every MCU pattern and restart interval, with shares that start
inside an MCU, inside a restart segment and at an image boundary. The card
tests hold the kernel to the same plain version.

``batch_groups`` cuts a batch for the compaction kernel, which takes at most
65,535 images a launch.
"""

import numpy as np
import pytest
import torch

import jax

from pixo_tpu.ops.huffman_device import count_symbols_device

from chip_smoke import COUNT_PATTERNS, count_edge_blocks
from pixo_tpu_torch.ops import huffman_device, kernels

jax.config.update("jax_platforms", "cpu")

PASS = 128  # csrc/huffman.cu's kPass: block o of a pass is warp o // 16's round o % 16 // 4, group o % 4


def _bit_length(v: int) -> int:
    return abs(int(v)).bit_length()


def count_model(zz: np.ndarray, pattern, ri, grid: int, share: int) -> dict:
    """``csrc/huffman.cu``'s walk of [B, N, 64] int16 blocks under the plan
    (grid, share), as its CTAs take it. Returns the histograms (dc [B, 2,
    12], ac [B, 2, 256] int64), each block's count of passes that took it,
    and the flushes (CTA, image) in order."""
    b, n = zz.shape[0], zz.shape[1]
    total, bins = b * n, kernels.HIST_BINS
    slots = kernels.count_layout(tuple(pattern))
    bpm, restart = len(pattern), ri or 0
    hist = np.zeros((b, bins), np.int64)  # the memset before the launch
    taken = np.zeros(total, np.int64)
    flushes = []
    pass_mcu, pass_slot = PASS // bpm, PASS % bpm
    for cta in range(grid):
        begin, end = cta * share, min(cta * share + share, total)
        row = np.zeros(bins, np.int64)
        lrow, limg = begin, begin // n
        lj = begin - limg * n
        state = [None] * PASS  # each DC lane's (mcu, slot, seg) of block o; None: computed anew
        while lrow < end:
            length = min(PASS, n - lj, end - lrow)
            image_end = lj + length == n
            for o in range(PASS):
                j = lj + o
                if state[o] is None:
                    mcu = j // bpm
                    state[o] = (mcu, j - mcu * bpm, mcu % restart if restart else 0)
                mcu, slot, seg = state[o]
                if o < length:
                    taken[limg * n + j] += 1
                    cls, prev, last = (int(v) for v in slots[slot])
                    pj = -1
                    if prev >= 0:
                        pj = j - slot + prev
                    elif mcu > 0 and (restart == 0 or seg != 0):
                        pj = j - slot - bpm + last
                    pred = int(zz[limg, pj, 0]) if pj >= 0 else 0
                    _count_block(zz[limg, j], pred, cls, row)
                # the DC lane's state for the next pass
                if image_end:
                    state[o] = None
                else:
                    slot += pass_slot
                    dm = pass_mcu
                    if slot >= bpm:
                        slot -= bpm
                        dm += 1
                    mcu += dm
                    if restart:
                        seg += dm
                        if seg >= restart:
                            seg %= restart
                    state[o] = (mcu, slot, seg)
            if image_end or lrow + length == end:  # the flush: the row into the image's counts
                hist[limg] += row
                row[:] = 0
                flushes.append((cta, int(limg)))
            lrow += length
            if image_end:
                lj, limg = 0, limg + 1
            else:
                lj += length
    return {"dc": hist[:, :24].reshape(b, 2, 12), "ac": hist[:, 24:].reshape(b, 2, 256),
            "taken": taken, "flushes": flushes}


def _count_block(block: np.ndarray, pred: int, cls: int, row: np.ndarray) -> None:
    """One block's symbols into a warp's row, as its eight lanes count them:
    each lane its chunk of 8 zigzag coefficients, its runs after the highest
    nonzero AC of the nearest lane before it that holds one; the end-of-block
    and the DC category from the block's DC lane."""
    ac = 24 + 256 * cls
    masks = []
    for lane in range(8):
        chunk = block[8 * lane:8 * lane + 8]
        mask = sum(1 << e for e in range(8) if chunk[e] != 0)
        masks.append(mask & ~1 if lane == 0 else mask)
    for lane in range(8):
        below = [k for k in range(lane) if masks[k]]
        last = 8 * below[-1] + masks[below[-1]].bit_length() - 1 if below else 0
        for e in range(8):
            if masks[lane] >> e & 1:
                p = 8 * lane + e
                run = p - last - 1
                if run >= 16:
                    row[ac + 0xF0] += run >> 4
                row[ac + ((run & 15) << 4 | _bit_length(block[p]))] += 1
                last = p
    if block[63] == 0:
        row[ac] += 1  # the end-of-block
    cat = _bit_length(int(block[0]) - pred)
    if cat < 12:
        row[12 * cls + cat] += 1


def _edge_batch(b: int, seed: int = 5) -> np.ndarray:
    """[b, 240, 64] edge blocks: 240 is a multiple of every pattern's MCU."""
    rng = np.random.default_rng(seed)
    return np.stack([count_edge_blocks(rng) for _ in range(b)])


def _assert_counts(got: dict, zz: np.ndarray, pattern, ri) -> None:
    dc, ac = kernels.count_symbols(torch.from_numpy(zz), pattern, ri)
    np.testing.assert_array_equal(got["dc"], dc.numpy())
    np.testing.assert_array_equal(got["ac"], ac.numpy())
    assert (got["taken"] == 1).all()


# Shares of the model's tests over 3 images of 240 blocks: 7 starts inside
# MCUs of 3, 4 and 6 blocks and inside restart segments, 60 inside segments
# of 7 MCUs of 4 and 6 blocks, 240 at each image boundary, 500 spans a whole
# image and two partial ones; (1, 720) is one CTA over the batch.
SHARES = [7, 60, 240, 500, 720]


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("ri", [None, 1, 2, 7])
@pytest.mark.parametrize("mode", list(COUNT_PATTERNS))
def test_count_model_equals_plain(mode, ri, share):
    """The kernel's walk equals the plain version and takes every block
    once, under every pattern, restart interval and share."""
    zz = _edge_batch(3)
    pattern = COUNT_PATTERNS[mode]
    grid = -(-zz.shape[0] * zz.shape[1] // share)
    _assert_counts(count_model(zz, pattern, ri, grid, share), zz, pattern, ri)


@pytest.mark.parametrize("ri", [None, 1, 2, 7])
@pytest.mark.parametrize("mode", list(COUNT_PATTERNS))
def test_count_model_equals_jax(mode, ri):
    """Shares of 7 blocks (inside MCUs and restart segments): each image's
    counts equal the JAX package's ``count_symbols_device``."""
    zz = _edge_batch(2, seed=11)
    pattern = COUNT_PATTERNS[mode]
    got = count_model(zz, pattern, ri, -(-zz.shape[0] * zz.shape[1] // 7), 7)
    for i in range(zz.shape[0]):
        want = count_symbols_device(zz[i], pattern, ri)
        for g, w in zip((got["dc"][i, 0], got["dc"][i, 1], got["ac"][i, 0], got["ac"][i, 1]), want):
            np.testing.assert_array_equal(g, np.asarray(w, np.int64))


def test_count_model_shares_start_where_the_tests_claim():
    """Among SHARES, over 240-block images: shares of 7 start inside an MCU
    of every pattern but gray and inside restart segments of 2 and 7 MCUs
    (and of 1 where an MCU holds several blocks); shares of 60 start inside
    segments of 7 MCUs; shares of 240 start at image boundaries."""
    n = 240
    for mode, pattern in COUNT_PATTERNS.items():
        bpm = len(pattern)
        starts = [c * 7 % n for c in range(1, 3 * n // 7 + 1)]
        assert bpm == 1 or any(s % bpm for s in starts), mode
        for ri in (1, 2, 7):
            assert ri * bpm == 1 or any(s % (ri * bpm) for s in starts), (mode, ri)
        assert bpm == 1 or any(c * 60 % n % (7 * bpm) for c in range(1, 12)), mode
    assert all(c * 240 % n == 0 for c in range(1, 3))


def test_count_model_flushes_at_every_image_end():
    """A CTA adds its row to an image's counts once for each image its
    share touches: one CTA over three images flushes three times, two CTAs
    of 500 blocks four times (the last image from both); images of one
    MCU, eight to a share, flush at every image end; shares of one block
    flush once each."""
    zz = _edge_batch(3)
    pattern = COUNT_PATTERNS["420"]
    assert count_model(zz, pattern, None, 1, 720)["flushes"] == [(0, 0), (0, 1), (0, 2)]
    assert count_model(zz, pattern, None, 2, 500)["flushes"] == [(0, 0), (0, 1), (0, 2), (1, 2)]
    tiny = _edge_batch(1).reshape(40, 6, 64)
    got = count_model(tiny, pattern, 3, 5, 48)
    assert got["flushes"] == [(i // 8, i) for i in range(40)]
    _assert_counts(got, tiny, pattern, 3)
    one = _edge_batch(1)[:, :6]
    got = count_model(one, pattern, None, 6, 1)
    assert got["flushes"] == [(i, 0) for i in range(6)]
    _assert_counts(got, one, pattern, None)


@pytest.mark.parametrize("b,n,ctas", [(16, 6144, 264), (16, 6144, 396), (1, 6144, 396), (1, 1, 396),
                                      (65537, 6, 396), (3, 4950, 396), (12, 6144, 342), (7, 3, 1),
                                      (264, 650, 1), (300, 2**24, 396)])
def test_count_plan_takes_every_block_once(b, n, ctas):
    """Contiguous shares, none empty, cover the batch's blocks once; a share
    is whole steps, at least a pass and at most ``COUNT_MAX_SHARE``; the
    grid fills the card's CTA slots (more than half of them where a share
    is more than a pass, and no more than all of them)."""
    grid, share = kernels.count_plan(b, n, ctas)
    total = b * n
    assert (grid - 1) * share < total <= grid * share
    assert kernels.COUNT_PASS <= share <= kernels.COUNT_MAX_SHARE
    assert share % kernels.COUNT_STEP == 0
    if share < kernels.COUNT_MAX_SHARE:
        assert grid <= ctas
    if kernels.COUNT_PASS < share < kernels.COUNT_MAX_SHARE:
        assert 2 * grid > ctas


def test_count_plan_at_the_cells():
    """(b1) on three CTAs an SM of 132 SMs: 16 images of 6,144 blocks in 384
    shares of 256 blocks, 24 an image; one 512x512 image in 48 shares of a
    pass; a 65,537-image batch of 8x8 4:2:0 images in one launch."""
    assert kernels.count_plan(16, 6144, 396) == (384, 256)
    assert kernels.count_plan(1, 6144, 396) == (48, 128)
    grid, share = kernels.count_plan(65537, 6, 396)
    assert grid <= 396 and grid * share >= 65537 * 6
    with pytest.raises(ValueError):
        kernels.count_plan(0, 6)


def test_count_symbols_takes_batches_past_65535_images():
    """The wrapper takes a batch of 65,536 images (the CPU's plain
    version here; one launch on a card), with no cap of its own."""
    zz = torch.zeros((65536, 1, 64), dtype=torch.int16)
    zz[::3, 0, 0] = 5
    dc, ac = kernels.count_symbols(zz, (0,))
    assert dc.shape == (65536, 2, 12) and int(ac[:, 0, 0].sum()) == 65536
    assert int(dc[0, 0, 3]) == 1 and int(dc[1, 0, 0]) == 1


@pytest.mark.parametrize("b,most", [(1, 65520), (65520, 65520), (65521, 65520), (131041, 65520), (10, 3)])
def test_batch_groups_cut_the_batch_in_order(b, most):
    groups = kernels.batch_groups(b, most)
    assert groups[0][0] == 0 and groups[-1][1] == b
    assert all(hi0 == lo1 for (_, hi0), (lo1, _) in zip(groups, groups[1:]))
    assert all(0 < hi - lo <= most for lo, hi in groups)
    assert len(groups) == -(-b // most)


def test_compact_groups_keep_every_slice_aligned():
    """A group of ``COMPACT_MAX_BATCH`` images starts every later slice of
    the compaction's outputs on a 16-byte boundary, at any block count and
    cap, and the kernel's 65,535-image limit holds."""
    most = kernels.COMPACT_MAX_BATCH
    assert most <= 65535 and most % 16 == 0
    for n in (1, 3, 6, 4950):
        for cap in (8, 16, 32):
            for lo, _ in kernels.batch_groups(3 * most + 1, most):
                assert all(lo * n * per % 16 == 0 for per in (128, 2, 1, cap, 2 * cap))
    with pytest.raises(ValueError):
        kernels.batch_groups(0, most)


def test_compact_padded_on_the_cpu_equals_its_groups():
    """The compaction of a batch equals its groups' compactions laid side
    by side, the property the card's grouped launches rest on."""
    from pixo_tpu_torch.ops.sparse_pack import sparsify_blocks_padded_batch

    zz = torch.from_numpy(_edge_batch(1).reshape(10, 24, 64))
    whole = kernels.compact_padded(zz, 8)
    parts = [kernels.compact_padded(zz[lo:hi], 8) for lo, hi in kernels.batch_groups(10, 3)]
    for k, t in enumerate(whole):
        assert torch.equal(t, torch.cat([p[k] for p in parts]))
    for g, r in zip(whole, sparsify_blocks_padded_batch(zz, 8)):
        assert torch.equal(g, r)


def test_count_front_defaults_to_the_card():
    """``count_symbols`` (the one-image front) counts on the card unless the
    caller asks for the CPU, as the JAX package's counterpart runs on its
    default device."""
    import inspect

    assert inspect.signature(huffman_device.count_symbols).parameters["device"].default == "cuda"
