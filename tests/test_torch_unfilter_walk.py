"""The unfilter kernel's decomposition, on the CPU.

``csrc/unfilter.cu`` cannot run here, so its parts are held in Python:
``unfilter_plan`` (the split of an image's warps over a cluster, the rings
and where they live) in the manner of ``tests/test_torch_count_plan.py``;
the byte-wise predictor (``step4``) on every (a, b, c) byte triple under
every filter id; a lane's input ring of 16-byte words (``row_in_model``:
cp.async sends ``UNFILTER_AHEAD`` chunks ahead, waits, the funnel-shifted
pixel reads) and its output staging (``row_out_model``: bytes staged a
step at a time, whole 8-byte words out once a chunk, byte by byte at a
row's two ends); and the walk of
``test_torch_unfilter.unfilter_walk`` at the schedule's boundaries (heights
1, 31, 32, 33, one past a full CTA's rows, one past the warps' and a ring's
wrap; RB below bpp and not a multiple of it; every bpp 1 to 8) against
``unfilter_plain`` and the host library's ``png_unfilter``, and where the
rings are below the plan's rule, its deadlock. Inputs come from numpy
seeds; tolerance 0 throughout (integer arithmetic mod 256).
"""

import numpy as np
import pytest
import torch

from chip_smoke import host_unfilter
from pixo_tpu_torch.ops.png_unfilter import (
    UNFILTER_AHEAD,
    UNFILTER_CHUNK,
    UNFILTER_GROUP,
    UNFILTER_MAX_CTAS,
    UNFILTER_MAX_WARPS,
    UNFILTER_MIN_RING,
    UNFILTER_RING,
    UNFILTER_SMEM,
    unfilter_in_words,
    unfilter_lane_bytes,
    unfilter_plain,
    unfilter_plan,
)
from test_torch_unfilter import Deadlock, _masks, _paeth, step4, unfilter_walk


def _reference(f, raw, a, b, c):
    pred = np.select([f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
    return (raw + pred) & 0xFF


@pytest.mark.parametrize("f", [0, 1, 2, 3, 4, 5])
def test_byte_wise_step_on_every_triple(f):
    """``step4`` (the kernel's predictor on 4 bytes at once, with Paeth's
    nine-bit pc replaced by its tests on pa and pb) equals the predictor of
    the PNG specification byte by byte on all 2^24 (a, b, c) triples, each
    with a raw byte from a seed, under filter id ``f`` (5: no predictor)."""
    rng = np.random.default_rng(50 + f)
    for part in range(4):  # 2^22 triples at a time
        i = np.arange(part << 22, (part + 1) << 22, dtype=np.int64)
        a, b, c = (i >> 16) & 0xFF, (i >> 8) & 0xFF, i & 0xFF
        raw = rng.integers(0, 256, i.shape[0], dtype=np.int64)
        pack = lambda v: v.astype(np.uint8).view(np.uint32)  # noqa: E731
        ids = np.full(i.shape[0] // 4, f)
        got = step4(_masks(ids), pack(raw), pack(a), pack(b), pack(c)).view(np.uint8)
        np.testing.assert_array_equal(got, _reference(f, raw, a, b, c).astype(np.uint8))


def test_plan_at_the_device_group_and_beyond():
    """PNG (a)'s device group (8 images of 512 rows of 1536 bytes at bpp
    3) spreads each image's 16 warps over a cluster of 8 CTAs of 2 warps;
    a batch that fills the card keeps an image on one CTA; a short image
    takes a warp a group; a one-row image one warp."""
    assert unfilter_plan(8, 512, 1536, 3) == (8, 2, UNFILTER_RING, "shared", 23072, 0)
    big = unfilter_plan(132, 512, 1536, 3)
    assert (big.ctas, big.warps) == (1, UNFILTER_MAX_WARPS)
    assert unfilter_plan(8, 512, 1536, 3, sms=8)[:2] == (1, UNFILTER_MAX_WARPS)
    assert unfilter_plan(2, 100, 1536, 3)[:2] == (2, 2)  # 4 groups
    assert unfilter_plan(1, 1, 1, 1)[:3] == (1, 1, UNFILTER_RING)
    for ctas in range(1, UNFILTER_MAX_CTAS + 1):
        plan = unfilter_plan(8, 512, 1536, 3, ctas=ctas)
        assert plan.ctas == ctas and plan.ctas * plan.warps >= 16 and plan.warps == -(-16 // ctas)


@pytest.mark.parametrize("b,h,rb,bpp", [(1, 4000, 3 * 1500, 3), (1, 100000, 300000, 8), (3, 70000, 3000, 1),
                                       (1, 2100, 7, 4), (8, 512, 1536, 3), (1, 8193, 2, 2)])
def test_plan_keeps_the_ring_rule_and_the_budget(b, h, rb, bpp):
    """Where groups wrap round the image's warps the rings together hold a
    row, ctas x warps x (slots - chunk) >= ceil(rb / bpp), the rule the C
    entry checks; slots are powers of 2 of at least the C entry's least; a
    CTA's shared memory stays in the budget, the rings moving to a global
    scratch (ring blocks of slots x slot + 16 bytes) past it."""
    fit = UNFILTER_SMEM // (32 * unfilter_lane_bytes(bpp))
    for ctas, warps in ((None, None), (1, None), (2, None), (8, None), (3, 1), (1, min(16, fit))):
        plan = unfilter_plan(b, h, rb, bpp, ctas=ctas, warps=warps)
        total, pixels, groups = plan.ctas * plan.warps, -(-rb // bpp), -(-h // UNFILTER_GROUP)
        assert 1 <= plan.warps <= UNFILTER_MAX_WARPS and 1 <= plan.ctas <= UNFILTER_MAX_CTAS
        if ctas is not None:
            assert plan.ctas == ctas and (warps is None or plan.warps == warps)
        assert plan.ring_slots >= UNFILTER_MIN_RING and plan.ring_slots & (plan.ring_slots - 1) == 0
        if groups > total:
            assert total * (plan.ring_slots - UNFILTER_CHUNK) >= pixels
        assert plan.smem <= UNFILTER_SMEM
        slot = 8 if bpp <= 4 else 16
        lanes = plan.warps * 32 * unfilter_lane_bytes(bpp)
        if plan.ring == "shared":
            assert plan.smem == lanes + plan.warps * (plan.ring_slots * slot + 16) and plan.scratch == 0
        else:
            assert lanes + plan.warps * (plan.ring_slots * slot + 16) > UNFILTER_SMEM
            assert plan.smem == lanes and plan.scratch == total * (plan.ring_slots * slot + 16)
    assert unfilter_plan(1, 100000, 300000, 8).ring == "global"


def test_plan_refuses_bad_shapes():
    for args in [(0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0), (1, 1, 1, 9)]:
        with pytest.raises(ValueError):
            unfilter_plan(*args)
    for ctas in (0, UNFILTER_MAX_CTAS + 1):
        with pytest.raises(ValueError, match="ctas"):
            unfilter_plan(1, 64, 64, 1, ctas=ctas)
    for warps in (0, UNFILTER_MAX_WARPS + 1):
        with pytest.raises(ValueError, match="warps"):
            unfilter_plan(1, 64, 64, 1, warps=warps)
    with pytest.raises(ValueError, match="warps"):  # 16 warps' lanes outgrow a CTA's shared memory at bpp 8
        unfilter_plan(1, 64, 64, 8, warps=UNFILTER_MAX_WARPS)
    with pytest.raises(ValueError, match="ring"):
        unfilter_plan(1, 64, 64, 1, ring="shared")


def test_plan_forces_a_split_and_global_rings():
    """A forced split keeps the ring rule (the slots grow where the forced
    warps are too few for the row); forced global rings take the lanes'
    shared memory alone and a scratch of every warp's ring block."""
    plan = unfilter_plan(1, 4000, 3 * 1500, 3, ctas=1, warps=2)
    assert plan[:2] == (1, 2) and 2 * (plan.ring_slots - UNFILTER_CHUNK) >= 1500
    g = unfilter_plan(8, 512, 1536, 3, ring="global")
    assert g.ring == "global" and g.smem == g.warps * 32 * unfilter_lane_bytes(3)
    assert g.scratch == g.ctas * g.warps * (g.ring_slots * 8 + 16)


def row_in_model(lead: int, rb: int, bpp: int, lane: int) -> int:
    """A lane's ``RowIn`` (csrc/unfilter.cu) over its row: the prologue
    sends the words of the first ``UNFILTER_AHEAD`` chunks, each chunk
    start sends those of the chunk ``UNFILTER_AHEAD`` on and waits for all
    but the newest ``UNFILTER_AHEAD`` groups of copies; each step's pixel
    reads its bytes from the ring's slots (word k in slot k % words).
    Every byte of every pixel must come from a slot that holds its word,
    landed, and equal the row's byte. Returns the pixels read."""
    words, chunk = unfilter_in_words(bpp), UNFILTER_CHUNK
    count = (lead + rb + 15) >> 4
    pixels = -(-rb // bpp)
    slot_word = [-1] * words  # the word each slot holds
    slot_group = [-1] * words  # the group of copies that brings it
    state = {"sent": 0, "group": 0}

    def send_through(end):
        last = (lead + (end - lane) * bpp - 1) >> 4
        while state["sent"] < count and state["sent"] <= last:
            k = state["sent"]
            slot_word[k % words], slot_group[k % words] = k, state["group"]
            state["sent"] += 1
        state["group"] += 1

    for c in range(UNFILTER_AHEAD):
        send_through((c + 1) * chunk)
    steps, read = pixels + lane, 0
    for s0 in range(0, steps, chunk):
        send_through(s0 + (UNFILTER_AHEAD + 1) * chunk)
        landed = state["group"] - UNFILTER_AHEAD  # groups below it have landed
        for s in range(s0, s0 + chunk):
            x = s - lane
            if not 0 <= x < pixels:
                continue
            for j in range(bpp):
                q = lead + x * bpp + j
                if q - lead >= rb:
                    break  # a byte past the row: garbage
                k = q >> 4
                assert slot_word[k % words] == k and slot_group[k % words] < landed, (lead, rb, bpp, lane, x, j)
            read += 1
    return read


@pytest.mark.parametrize("bpp", range(1, 9))
def test_row_in_ring_holds_every_pixel(bpp):
    for lead in range(16):
        for rb in (1, bpp, 7 * bpp - 1, 200 * bpp + 3):
            for lane in (0, 1, 17, 31):
                assert row_in_model(lead, rb, bpp, lane) == -(-rb // bpp)


def row_out_model(lead: int, rb: int, bpp: int, values: np.ndarray, lane: int = 0) -> np.ndarray:
    """A lane's ``RowOut`` (csrc/unfilter.cu) over a row of ``values`` (the
    pixels' bytes, ceil(rb / bpp) * bpp of them), chunk by chunk as lane
    ``lane`` takes them: each step's pixel bytes into the staging bytes at
    their row position less ``base``; after each chunk the aligned 8-byte
    words it completed go out (whole where the row holds all of the word,
    else byte by byte), the row's last word once the row is done, and the
    word still being filled moves to the front. Returns the aligned words of
    memory around the row, 0xEE where nothing was stored; each word is held
    to be stored once and to fit the stage."""
    end, chunk = lead + rb, UNFILTER_CHUNK
    size = 8 * (((8 + chunk * bpp + 7) // 8) | 1)
    mem = np.full(((end + 7) >> 3) * 8 + 8, 0xEE, np.uint8)
    stage = np.zeros(size, np.uint8)
    stored, base, pixels = set(), 0, -(-rb // bpp)

    def store(lo, w):
        assert lo not in stored and lo % 8 == 0, (lead, rb, bpp, lo)
        stored.add(lo)
        for j in range(max(lo, lead), min(lo + 8, end)):
            mem[j] = w[j - lo]

    for s0 in range(0, pixels + lane, chunk):
        x0 = s0 - lane
        for x in range(max(x0, 0), min(x0 + chunk, pixels)):
            off = lead + x * bpp - base
            assert 0 <= off and off + bpp <= size
            stage[off: off + bpp] = values[x * bpp: (x + 1) * bpp]
        x1 = min(x0 + chunk, pixels)
        if x1 <= 0 or x0 >= pixels:
            continue
        e = min(lead + x1 * bpp, end)
        lo = base
        while lo + 8 <= e:
            store(lo, stage[lo - base: lo - base + 8].copy())
            lo += 8
        assert lo - base + 8 <= size
        rest = stage[lo - base: lo - base + 8].copy()
        if x1 == pixels:
            if lo < e:
                store(lo, rest)
        else:
            stage[:8] = rest
            base = lo
    return mem


@pytest.mark.parametrize("bpp", range(1, 9))
def test_row_out_stores_every_byte_once_in_the_row(bpp):
    rng = np.random.default_rng(60 + bpp)
    for lead in range(8):  # the row's first byte within its aligned 8-byte word
        for rb in (1, bpp - 1 or 1, bpp + 1, 16, 17, 31, 33, 16 * bpp + 5, 100):
            pixels = -(-rb // bpp)
            values = rng.integers(0, 256, pixels * bpp, dtype=np.uint8)
            mem = row_out_model(lead, rb, bpp, values, lane=lead % 4 * 9)
            np.testing.assert_array_equal(mem[lead: lead + rb], values[:rb], err_msg=f"{lead} {rb}")
            assert (mem[:lead] == 0xEE).all() and (mem[lead + rb:] == 0xEE).all()


def _boundary_cases(bpp):
    """(label, rows, filters, plan or None for the plan's own, sms): the
    schedule's boundaries at ``bpp``."""
    rng = np.random.default_rng(70 + bpp)

    def case(label, b, h, rb, plan=None, sms=132):
        rows = rng.integers(0, 256, (b, h, rb), dtype=np.uint8)
        filters = np.where(np.arange(h) < 5, np.arange(h) % 5, rng.integers(0, 5, (b, h))).astype(np.int32)
        return label, rows, filters, plan, sms

    small = max(bpp - 1, 1)  # RB < bpp (1 for bpp 1)
    odd = 3 * bpp + (1 if bpp > 1 else 0)  # RB not a multiple of bpp
    most = min(UNFILTER_MAX_WARPS, UNFILTER_SMEM // (32 * unfilter_lane_bytes(bpp)))  # a full CTA's warps
    cta = most * UNFILTER_GROUP + 1  # one past a full CTA's rows
    wrap = UNFILTER_MIN_RING + 1  # pixels one past a ring's slots
    return [
        case("H=1, RB<bpp", 2, 1, small),
        case("H=31", 2, 31, odd),
        case("H=32", 1, 32, 5 * bpp + 2),
        case("H=33 (two groups)", 2, 33, odd),
        case("H=65 on a cluster of 2 CTAs", 2, 65, odd, sms=4),
        case(f"H={cta}, a CTA of {most} warps wrapped once", 1, cta, odd,
             unfilter_plan(1, cta, odd, bpp, ctas=1, warps=most)),
        case(f"H={cta} on 8 CTAs of 2 warps", 1, cta, small,
             unfilter_plan(1, cta, small, bpp, ctas=8, warps=2)),
        case("one past a ring's wrap, groups round 2 CTAs", 1, 3 * UNFILTER_GROUP + 1, wrap * bpp - (bpp > 1),
             unfilter_plan(1, 97, wrap * bpp, bpp, ctas=2, warps=1)._replace(ring_slots=UNFILTER_MIN_RING)),
    ]


@pytest.mark.parametrize("bpp", range(1, 9))
def test_kernel_walk_at_the_schedule_boundaries(bpp):
    for label, rows, filters, plan, sms in _boundary_cases(bpp):
        b, h, rb = rows.shape
        plan = plan or unfilter_plan(b, h, rb, bpp, sms=sms)
        got = unfilter_walk(rows, filters, bpp, plan)
        want = unfilter_plain(torch.from_numpy(rows), torch.from_numpy(filters), bpp).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"{label} {plan}")
        np.testing.assert_array_equal(got, host_unfilter(rows, filters, bpp), err_msg=label)


def test_walk_deadlocks_below_the_ring_rule():
    """Two warps whose groups wrap round them, with rows of 200 pixels:
    rings of 64 slots (2 x (64 - 8) < 200, which the C entry refuses)
    deadlock when each warp runs on until it waits; the plan's rings (128
    slots) do not."""
    rng = np.random.default_rng(80)
    rows = rng.integers(0, 256, (1, 3 * UNFILTER_GROUP, 200), dtype=np.uint8)
    filters = rng.integers(0, 5, (1, 3 * UNFILTER_GROUP)).astype(np.int32)
    plan = unfilter_plan(1, 3 * UNFILTER_GROUP, 200, 1, ctas=1, warps=2)
    assert plan.ring_slots == UNFILTER_RING and 2 * (UNFILTER_MIN_RING - UNFILTER_CHUNK) < 200
    with pytest.raises(Deadlock):
        unfilter_walk(rows, filters, 1, plan._replace(ring_slots=UNFILTER_MIN_RING), greedy=True)
    for greedy in (False, True):
        np.testing.assert_array_equal(unfilter_walk(rows, filters, 1, plan, greedy), host_unfilter(rows, filters, 1))
