"""The ``dct_zz`` kernel's and the AAN contract's decompositions, on the CPU.

``csrc/coeffs.cu``'s ``dct_zz_kernel`` cuts a batch into tiles (an image's
run of MCUs in one MCU row, 128 pixels wide), gives each CTA one contiguous
share of them (``ops/kernels.py::dct_zz_plan``, the same bounds the kernel
computes from ``blockIdx.x``), and sends each tile's output, one contiguous
range of the scan-order blocks, with one bulk copy from an unpadded tile of
64 floats a block. Its column pass stores a lane's column in zigzag order;
its conversion reads four pixels of a row from three aligned words and
computes the fixed-point BT.601 with byte dot products, and its 4:2:0 and
4:2:2 chroma lanes sum their samples' pixels with byte dot products too.
The tests walk each of these in Python: the shares, the tiles' block
ranges against the port's ``num_blocks`` and the JAX package's
``scan_layout``, the store schedule's banks, the word extraction, the
conversion's integer formulas against both packages' colour conversions,
the chroma sums against the plain blockify's means, and the contract
kernel's lane layout. The card tests hold the kernels themselves to their
plain versions.
"""

import re

import numpy as np
import pytest
import torch

from pixo_tpu.color import rgb_to_ycbcr_np
from pixo_tpu.jpeg.tables import ZIGZAG as JAX_ZIGZAG
from pixo_tpu.ops.blockify import scan_layout

from pixo_tpu_torch.color import rgb_to_ycbcr
from pixo_tpu_torch.jpeg.tables import ZIGZAG
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.ops.blockify import num_blocks

MODES = ["gray", "444", "420", "422"]
SMS = kernels.H100_SMS
SOURCE = open(f"{kernels.CSRC}/coeffs.cu").read()


def _constant(name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", SOURCE).group(1)


def _share_ok(plan, n_tiles):
    """Every tile once, in order, in contiguous shares that differ by at most one."""
    assert plan[0][0] == 0 and plan[-1][1] == n_tiles
    assert all(a[1] == b[0] for a, b in zip(plan, plan[1:]))
    sizes = [e - b for b, e in plan]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)  # the longer shares first, as the kernel's bounds


def kernel_share(cta: int, grid: int, n_tiles: int):
    """The kernel's own bounds of CTA ``cta``: t0 = c q + min(c, r), t1 = t0 + q + (c < r)."""
    q, r = divmod(n_tiles, grid)
    t0 = cta * q + min(cta, r)
    return t0, t0 + q + (cta < r)


# (label, n_tiles, slots): the max cells (m1) and (m2) at 4:2:0 (128 tiles an
# image) on 132 SMs x 3 CTAs, one tile, more slots than tiles, a multiple of
# the slots and one tile past it, primes
PLAN_CASES = [
    ("m1", 16 * 128, SMS * 3), ("m2", 12 * 128, SMS * 3), ("one tile", 1, SMS * 3),
    ("more slots than tiles", 100, SMS * 9), ("a multiple of the slots", 3 * SMS * 4, SMS * 4),
    ("one tile past", SMS * 3 + 1, SMS * 3), ("primes", 7919, 263), ("one slot", 97, 1),
]


@pytest.mark.parametrize("label,n_tiles,slots", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_dct_zz_plan_takes_every_tile_once_in_balanced_shares(label, n_tiles, slots):
    plan = kernels.dct_zz_plan(n_tiles, slots)
    assert len(plan) == min(n_tiles, slots)
    _share_ok(plan, n_tiles)
    assert plan == [kernel_share(c, len(plan), n_tiles) for c in range(len(plan))]


def test_dct_zz_plan_at_the_max_cells():
    """(m1) and (m2) at 4:2:0 (128 tiles an image) on 132 SMs at the plan's
    CTAs an SM: every CTA busy, the longest share the mean rounded up."""
    slots = SMS * kernels.dct_zz_plan_ctas("420")
    for n_tiles in (16 * 128, 12 * 128):
        plan = kernels.dct_zz_plan(n_tiles, slots)
        assert len(plan) == slots
        assert max(e - b for b, e in plan) == -(-n_tiles // slots)


def test_dct_zz_plan_refuses_empty_input():
    with pytest.raises(ValueError):
        kernels.dct_zz_plan(0, 4)
    with pytest.raises(ValueError):
        kernels.dct_zz_plan(4, 0)


def test_plan_constants_match_the_kernel_source():
    assert int(_constant("kZzThreadsPerSm")) == kernels.DCT_ZZ_THREADS_PER_SM
    assert int(_constant("kTileW")) == kernels.TILE_W
    assert {m: kernels.dct_zz_plan_ctas(m) for m in MODES} == {"gray": 9, "444": 3, "420": 3, "422": 4}
    assert {m: kernels.zz_tiles(8, 8, m).threads for m in MODES} == {
        "gray": 128, "444": 384, "420": 384, "422": 256}


def walk(b: int, h: int, w: int, mode: str, slots: int):
    """The kernel's walk of a batch: each CTA's tiles in its share, each
    tile's bulk store (first block, blocks, byte offset, bytes). Returns the
    count of writes of each block of the flattened batch and the stores."""
    t = kernels.zz_tiles(h, w, mode)
    nblocks = t.n_mcu_x * t.n_mcu_y * t.bpm
    n_tiles = b * t.tiles_per_img
    written = np.zeros(b * nblocks, np.int64)
    stores = []
    for begin, end in kernels.dct_zz_plan(n_tiles, slots):
        for tile in range(begin, end):
            img, rem = divmod(tile, t.tiles_per_img)
            my, tx = divmod(rem, t.n_tiles_x)
            mx0 = tx * t.mcus
            n_mcus = min(t.mcus, t.n_mcu_x - mx0)
            first = img * nblocks + (my * t.n_mcu_x + mx0) * t.bpm
            count = n_mcus * t.bpm
            written[first:first + count] += 1
            stores.append((first, count, first * 256, count * 256))
    return written, stores


# (b, h, w): the max cells' shape, odd sizes that end inside an MCU and a
# tile, one 8x8 image, a tall image of one tile a row, a wide one of many
WALK_SHAPES = [(16, 512, 512), (3, 517, 389), (1, 8, 8), (2, 17, 23), (2, 40, 133), (3, 33, 200),
               (1, 600, 128), (2, 24, 1000)]


@pytest.mark.parametrize("slots", [SMS * 3, 7, 1])
@pytest.mark.parametrize("mode", MODES)
def test_walk_writes_every_block_once_with_aligned_bulk_stores(mode, slots):
    for b, h, w in WALK_SHAPES:
        written, stores = walk(b, h, w, mode, slots)
        n_mcus, bpm, _ = scan_layout(w, h, "gray" if mode == "gray" else "rgb", mode)
        assert written.size == b * num_blocks(h, w, mode) == b * n_mcus * bpm
        assert (written == 1).all(), (b, h, w)
        for _, count, offset, nbytes in stores:
            assert offset % 16 == 0 and nbytes % 16 == 0 and 0 < nbytes <= kernels.TILE_W // 8 * 6 * 256
            assert count % bpm == 0  # whole MCUs


def _zigzag_pos():
    """csrc/coeffs.cu's kZigzagPos: the zigzag position of each natural index."""
    body = re.search(r"kZigzagPos\[64\] = \{([^}]+)\}", SOURCE).group(1)
    return [int(v) for v in body.replace("\n", " ").split(",") if v.strip()]


def test_kernel_zigzag_table_inverts_both_packages_zigzag():
    pos = np.asarray(_zigzag_pos())
    np.testing.assert_array_equal(pos[ZIGZAG], np.arange(64))
    np.testing.assert_array_equal(np.asarray(JAX_ZIGZAG), np.asarray(ZIGZAG))


def store_schedule():
    """The column pass's zigzag stores of one warp (its four blocks' lanes
    (s, j), column j of the block in place s): at step k lane j stores row k
    of its column to position kZigzagPos[8 * k + j] of its block's 64
    floats. Returns [step][lane] = (block place, position)."""
    pos = _zigzag_pos()
    return [[(s, pos[8 * k + j]) for s in range(4) for j in range(8)] for k in range(8)]


def _banks(step):
    # block places are 64 floats apart: the bank is the position's, mod 32
    counts = np.zeros(32, np.int64)
    for _, p in step:
        counts[p % 32] += 1
    return counts


def test_store_schedule_writes_each_position_once():
    steps = store_schedule()
    for s in range(4):
        got = sorted(p for step in steps for place, p in step if place == s)
        assert got == list(range(64))


def test_store_schedule_banks():
    """The unpadded tile puts a warp's four blocks on the same banks: a step's
    32 stores fall on 8 banks, four each (the padded int16 tile of the
    coefficient kernel spreads them). No order of a block's rows helps: no
    four zigzag rows of a column set fall on pairwise disjoint banks, so an
    order a block avoids at most half of it (a rotation by the block's place
    in its warp: two a bank), and the rotation's selects cost more than the
    conflicts (--coeffs-parts dct_zz)."""
    import itertools

    for step in store_schedule():
        counts = _banks(step)
        assert (counts == 4).sum() == 8 and counts.sum() == 32
    pos = _zigzag_pos()
    rows = [frozenset(pos[8 * r + j] % 32 for j in range(8)) for r in range(8)]
    assert all(len(r) == 8 for r in rows)  # within a block, a row's lanes never conflict
    assert not any(len(frozenset().union(*(rows[r] for r in four))) == 32
                   for four in itertools.combinations(range(8), 4))
    rotated = [[(s, pos[8 * ((k + s) & 7) + j]) for s in range(4) for j in range(8)] for k in range(8)]
    assert max(_banks(step).max() for step in rotated) == 2


def _signed_bytes(word: int):
    return np.array([((word >> (8 * i)) & 255) - (256 if (word >> (8 * i)) & 128 else 0)
                     for i in range(4)], np.int64)


def _dp4a_words():
    """The weight words of csrc/coeffs.cu's ycc_word: Y (unsigned bytes),
    then Cb and Cr (signed bytes) with their extra b and r."""
    found = [int(v, 16) for v in re.findall(r"0x([0-9A-F]{8})u", SOURCE.split("ycc_word(uint32_t p)")[1][:600])]
    return found[:5]


@pytest.mark.parametrize("r0", range(0, 256, 64))
def test_dp4a_conversion_equals_both_packages_colour_conversion(r0):
    """ycc_word's byte dot products, every pixel of 64 red levels at a time,
    against the port's rgb_to_ycbcr and the JAX package's numpy twin."""
    y_w, cb_w, cb_extra, cr_w, cr_extra = _dp4a_words()
    r, g, b = np.meshgrid(np.arange(r0, r0 + 64), np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([r.ravel(), g.ravel(), b.ravel(), np.zeros(r.size, np.int64)], 1).astype(np.int64)
    y = (px @ np.array([(y_w >> (8 * i)) & 255 for i in range(4)], np.int64) + 128) >> 8
    cb = np.minimum((px @ _signed_bytes(cb_w) + px @ _signed_bytes(cb_extra) + 32896) >> 8, 255)
    cr = np.minimum((px @ _signed_bytes(cr_w) + px @ _signed_bytes(cr_extra) + 32896) >> 8, 255)
    rgb = px[:, :3].astype(np.uint8)
    want = rgb_to_ycbcr(torch.from_numpy(rgb)).numpy().astype(np.int64)
    np.testing.assert_array_equal(np.stack([y, cb, cr], 1), want)
    np.testing.assert_array_equal(want, rgb_to_ycbcr_np(rgb).astype(np.int64))


def test_four_pixels_from_three_aligned_words():
    """convert_words' fast path: pixels 4k..4k + 3 of a three-channel row
    whose offset is a multiple of 4 are the words w0, w1, w2 at 3k; pixel e's
    R, G, B are bytes 0-2 of w0, funnelshift_r(w0, w1, 24),
    funnelshift_r(w1, w2, 16) and w2 >> 8."""
    rng = np.random.default_rng(3)
    row = rng.integers(0, 256, 128 * 3 + 16, dtype=np.uint8)
    words = row.view("<u4").astype(np.uint64)
    for k in range(32):
        w0, w1, w2 = (int(v) for v in words[3 * k:3 * k + 3])
        got = [w0, ((w1 << 32 | w0) >> 24) & 0xFFFFFFFF, ((w2 << 32 | w1) >> 16) & 0xFFFFFFFF, w2 >> 8]
        for e, p in enumerate(got):
            x = 3 * (4 * k + e)
            assert [(p >> (8 * b)) & 255 for b in range(3)] == list(row[x:x + 3])


@pytest.mark.parametrize("mode", ["420", "422"])
def test_chroma_lane_sums_equal_the_plain_means(mode):
    """zz_chroma_row: a chroma lane's 16 pixels of one (4:2:2) or two (4:2:0)
    rows as four words each; sample k is the byte dot product of word k // 2
    with 0x0101 (k even) or 0x01010000 (k odd), over both rows, then
    sum * 0.25 (or 0.5) - 128 in f32: the plain blockify's chroma block."""
    from pixo_tpu_torch.ops.blockify import blocks_420, blocks_422

    rng = np.random.default_rng(4)
    rows = 2 if mode == "420" else 1
    img = rng.integers(0, 256, (1, 8 * rows, 16, 3), dtype=np.uint8)
    cb = rgb_to_ycbcr(torch.from_numpy(img)).numpy()[0, ..., 1].astype(np.uint8)
    mean = np.float32(0.25 if mode == "420" else 0.5)
    got = np.zeros((8, 8), np.float32)
    for j in range(8):
        planes = [cb[rows * j + d].view("<u4").astype(np.int64) for d in range(rows)]
        for k in range(8):
            pair = 0x01010000 if k & 1 else 0x0101
            total = sum(sum(((int(w[k >> 1]) >> (8 * b)) & 255) * ((pair >> (8 * b)) & 255)
                            for b in range(4)) for w in planes)
            got[j, k] = np.float32(np.float32(total) * mean) - np.float32(128)
    blocks = (blocks_420 if mode == "420" else blocks_422)(torch.from_numpy(img)).numpy()
    want = blocks[0, 4 if mode == "420" else 2]  # the MCU's Cb block
    np.testing.assert_array_equal(got.view(np.int32), want.astype(np.float32).view(np.int32))


def test_contract_lanes_cover_the_block_without_bank_conflicts():
    """The AAN contract's eight lanes a block, four blocks a warp (padded
    rows of 9 floats, blocks 72 apart): the row pass's stores, the column
    pass's loads and stores, and the 16-byte stores' loads each touch 32
    banks a step; lane j's two stores hold floats 4j.. and 32 + 4j.. of the
    block, so each 8-lane store covers 128 bytes in a row."""
    def banks(addr):
        return len({addr(s, j) % 32 for s in range(4) for j in range(8)})

    for k in range(8):
        assert banks(lambda s, j: 72 * s + 9 * j + k) == 32  # row pass: lane j's row j
        assert banks(lambda s, j: 72 * s + 9 * k + j) == 32  # column pass: lane j's column j
    covered = []
    for j in range(8):
        o = 9 * (j >> 1) + 4 * (j & 1)
        for e in range(4):
            for half, at in ((0, o + e), (32, o + 36 + e)):
                row, col = divmod(at, 9)
                assert col < 8 and 8 * row + col == half + 4 * j + e
                covered.append(8 * row + col)
    assert sorted(covered) == list(range(64))
    for e in range(4):
        for extra in (0, 36):
            assert banks(lambda s, j: 72 * s + 9 * (j >> 1) + 4 * (j & 1) + extra + e) == 32
