"""The port's device PNG unfilter against the JAX package's and the host
library's, on the CPU.

``unfilter_device_batch(..., device="cpu")`` runs the plain PyTorch
wavefront; it is held bit for bit (tolerance 0: the arithmetic is integer
mod 256) to the JAX package's jit ``unfilter_device_batch`` on XLA:CPU and
to the host library's ``native_png_unfilter``, on every filter id, every
bpp 1 to 8 and the edge shapes of ``chip_smoke.unfilter_edge_cases``.
``unfilter_walk`` runs ``csrc/unfilter.cu``'s schedule in numpy (a pixel a
step, a lane a row, warps of 32 rows fed by the lane above's last step, the
rings between warps with their tags and chunk-level counts, the image's
warps over the plan's CTAs, the kernel's byte-wise predictor on packed
pixel words): a change to the kernel's walk goes through it first. Inputs
come from numpy seeds.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax

from pixo_tpu.ops.png_unfilter import unfilter_device_batch as jax_unfilter_batch

from chip_smoke import UNFILTER_BAND_ROWS, host_unfilter, unfilter_edge_cases
from pixo_tpu_torch import FilterStrategy
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.ops.png_unfilter import (
    UNFILTER_CHUNK,
    UNFILTER_GROUP,
    UNFILTER_TAKE,
    unfilter_device,
    unfilter_device_batch,
    unfilter_plain,
    unfilter_plan,
)

jax.config.update("jax_platforms", "cpu")

CASES = unfilter_edge_cases(np.random.default_rng(41))

M7, M8 = np.uint32(0x7F7F7F7F), np.uint32(0x80808080)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _spread(m):
    """PRMT's sign replication: 0xff in each byte whose top bit is set."""
    return ((m >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(0xFF)


def lt4(x, y):
    """csrc/unfilter.cu's ``lt4``: 0xff in each byte where x < y."""
    t = (x | M8) - (y & M7)
    return _spread((((x ^ y) & y) | (~(x ^ y) & ~t)) & M8)


def absdiff4(x, y):
    """VABSDIFF4: |x - y| byte by byte."""
    d = np.abs(x.view(np.uint8).astype(np.int16) - y.view(np.uint8).astype(np.int16))
    return d.astype(np.uint8).view(np.uint32).reshape(x.shape)


def step4(masks, raw, a, b, c):
    """csrc/unfilter.cu's ``step4`` on [N] uint32 words of 4 bytes: raw +
    the predictor of each row's filter (``masks``: its sub, up, avg and
    paeth masks), byte by byte."""
    sub, up, avg_m, paeth_m = masks
    avg = (a & b) + (((a ^ b) >> np.uint32(1)) & M7)
    pa, pb = absdiff4(b, c), absdiff4(a, c)
    a_wins = ~lt4(pb, pa)
    far = (lt4((pb >> np.uint32(1)) & M7, pa) & a_wins) | (lt4((pa >> np.uint32(1)) & M7, pb) & ~a_wins)
    take_c = (lt4(a, c) ^ lt4(b, c)) & far
    paeth = (c & take_c) | (((a & a_wins) | (b & ~a_wins)) & ~take_c)
    pred = (a & sub) | (b & up) | (avg & avg_m) | (paeth & paeth_m)
    return ((raw & M7) + (pred & M7)) ^ ((raw ^ pred) & M8)


def step8(masks, raw, a, b, c):
    """``step8``: ``step4`` on both halves of [N] uint64 pixel words."""
    lo32, sh = np.uint64(0xFFFFFFFF), np.uint64(32)
    half = lambda v, k: ((v >> sh) if k else v & lo32).astype(np.uint32)  # noqa: E731
    lo = step4(masks, half(raw, 0), half(a, 0), half(b, 0), half(c, 0)).astype(np.uint64)
    hi = step4(masks, half(raw, 1), half(a, 1), half(b, 1), half(c, 1)).astype(np.uint64)
    return (hi << sh) | lo


def _masks(f):
    return tuple(np.where(f == k, np.uint32(0xFFFFFFFF), np.uint32(0)) for k in (1, 2, 3, 4))


class Deadlock(RuntimeError):
    pass


def unfilter_walk(rows, filters, bpp, plan=None, greedy=False):
    """``csrc/unfilter.cu``'s schedule in numpy, image by image (an image is
    one cluster of ``plan.ctas`` CTAs of ``plan.warps`` warps; the plan is
    ``unfilter_plan``'s by default). The image's warp q takes groups q, q +
    total, ... of 32 rows; lane l of a group reconstructs pixel s - l of its
    row at step s as one packed word of ``bpp`` bytes (bytes past the row
    are garbage, 0xA5 here: a pixel's bytes are independent): b is the lane
    above's output of step s - 1 (the shuffle), for lane 0 the slot of the
    warp's ring whose tag is the pixel's running index, which lane 31 of the
    warp before fills; c the lane's b of step s - 1, a its own output. At
    each chunk start (every ``UNFILTER_CHUNK`` steps) lane 0 stores the
    count of pixels read for the writer and a writer waits for room for
    lane 31's pixels of the chunk; every ``UNFILTER_TAKE`` steps a reader
    waits until the slots of lane 0's pixels of the next ``UNFILTER_TAKE``
    steps (those of the row) hold them, then takes them all. A lane shuffles
    its output unmasked (past the row it is garbage, which only lanes past
    their rows receive). A warp that waits takes no step: by turns a step a
    warp, or with ``greedy`` each warp on until it waits. Raises
    ``Deadlock`` when every warp waits."""
    b, h, rb = rows.shape
    plan = plan or unfilter_plan(b, h, rb, bpp)
    pixels, groups = -(-rb // bpp), -(-h // UNFILTER_GROUP)
    total, slots, chunk, take = plan.ctas * plan.warps, plan.ring_slots, UNFILTER_CHUNK, UNFILTER_TAKE
    wide = bpp > 4
    dtype = np.uint64 if wide else np.uint32
    step = step8 if wide else step4
    padded = np.full((b, h, pixels * bpp), 0xA5, np.uint8)
    padded[..., :rb] = rows
    words = np.zeros((b, h, pixels, 8 if wide else 4), np.uint8)
    words[..., :bpp] = padded.reshape(b, h, pixels, bpp)
    words = words.view(dtype)[..., 0]  # [b, h, pixels] little-endian pixel words
    out = np.zeros((b, h, pixels * bpp), np.uint8)
    lanes = np.arange(32)
    mod = 1 << 32
    for img in range(b):
        tags = np.full((total, slots), mod - 1, np.int64)
        vals = np.zeros((total, slots), dtype)
        counts = np.zeros(total, np.int64)  # ring q's pixels read, by its reader (warp q)
        warps = [{"g": q, "k": 0, "s": 0} for q in range(total)]

        def start(w):
            w["own"], w["up"], w["recv"] = (np.zeros(32, dtype) for _ in range(3))

        for w in warps:
            start(w)

        def advance(q):
            """One step of warp q, or False where it waits."""
            w = warps[q]
            g, k, s = w["g"], w["k"], w["s"]
            y = g * UNFILTER_GROUP + lanes
            row_ok = y < h
            n = min(UNFILTER_GROUP, h - g * UNFILTER_GROUP)
            reads, writes = g > 0, g + 1 < groups
            in_base = ((k - 1 if q == 0 else k) * pixels) % mod
            out_base = (k * pixels) % mod
            nxt = (q + 1) % total
            if s % chunk == 0:
                if reads:
                    counts[q] = (in_base + min(s, pixels)) % mod
                need = min(s - 31 + chunk, pixels) - slots
                if writes and need > 0 and (counts[nxt] - (out_base + need)) % mod >= mod // 2:
                    return False
            if s % take == 0:
                w["above"] = np.zeros(take, dtype)
                if reads:
                    idx = (in_base + np.arange(s, min(s + take, pixels))) % mod
                    if (tags[q, idx % slots] != idx).any():
                        return False
                    w["above"][: len(idx)] = vals[q, idx % slots]
            x = s - lanes
            on = row_ok & (x >= 0) & (x < pixels)
            bv = w["recv"].copy()
            bv[0] = w["above"][s % take]
            f = np.where(row_ok, filters[img, np.minimum(y, h - 1)], 0)
            raw = np.where(on, words[img, np.minimum(y, h - 1), np.clip(x, 0, pixels - 1)], 0).astype(dtype)
            full = step(_masks(f), raw, w["own"], bv, w["up"]).astype(dtype)
            v = np.where(on, full, 0).astype(dtype)
            w["own"], w["up"] = v, np.where(on, bv, 0).astype(dtype)
            for lane in np.flatnonzero(on):
                out[img, y[lane], x[lane] * bpp: (x[lane] + 1) * bpp] = \
                    np.array([v[lane]], dtype).view(np.uint8)[:bpp]
            if writes and on[31]:
                idx = (out_base + x[31]) % mod
                tags[nxt, idx % slots], vals[nxt, idx % slots] = idx, v[31]
            w["recv"] = np.concatenate([full[:1], full[:-1]])  # __shfl_up_sync(w, 1), unmasked
            w["s"] = s + 1
            if w["s"] == pixels + n - 1:
                if reads:
                    counts[q] = (in_base + pixels) % mod
                w["g"], w["k"], w["s"] = g + total, k + 1, 0
                start(w)
            return True

        while True:
            live = [q for q in range(total) if warps[q]["g"] < groups]
            if not live:
                break
            moved = False
            for q in live:
                while warps[q]["g"] < groups and advance(q):
                    moved = True
                    if not greedy:
                        break
            if not moved:
                raise Deadlock(f"every warp of image {img} waits ({plan})")
    return out[..., :rb]


def _port(rows, filters, bpp):
    return unfilter_device_batch(rows, filters, bpp=bpp, device="cpu").numpy()


@pytest.mark.parametrize("label,rows,filters,bpp", CASES, ids=[c[0] for c in CASES])
def test_plain_equals_jax_and_native(label, rows, filters, bpp):
    got = _port(rows, filters, bpp)
    assert got.dtype == np.uint8 and got.shape == rows.shape
    np.testing.assert_array_equal(got, np.asarray(jax_unfilter_batch(rows, filters, bpp=bpp)))
    if ((filters >= 0) & (filters <= 4)).all():
        np.testing.assert_array_equal(got, host_unfilter(rows, filters, bpp))


SHORT = [c for c in CASES if c[1].shape[1] < 1000]


@pytest.mark.parametrize("label,rows,filters,bpp", SHORT, ids=[c[0] for c in SHORT])
def test_kernel_walk_equals_plain(label, rows, filters, bpp):
    np.testing.assert_array_equal(unfilter_walk(rows, filters, bpp), _port(rows, filters, bpp))


@pytest.mark.parametrize("band", [1, 2, 3, 5])
@pytest.mark.parametrize("bpp", [1, 3, 8])
def test_kernel_walk_across_bands_equals_native(band, bpp):
    """Images of ``band`` warps (split over CTAs as 1, 2, 3 and 5 CTAs of
    one warp, or one CTA) whose groups wrap round them twice and more, on
    the least ring the C entry takes, by turns and greedily: every group's
    first row reads the row above from the ring of the warp before, and the
    last warp's ring feeds the first."""
    rng = np.random.default_rng(42 + band + bpp)
    h = 2 * UNFILTER_GROUP * band + 5
    rows = rng.integers(0, 256, (2, h, 4 * bpp + 3), dtype=np.uint8)
    filters = rng.integers(0, 5, (2, h)).astype(np.int32)
    want = host_unfilter(rows, filters, bpp)
    for ctas, warps in {(band, 1), (1, band)}:
        plan = unfilter_plan(2, h, rows.shape[2], bpp, ctas=ctas)._replace(warps=warps, ring_slots=64)
        for greedy in (False, True):
            np.testing.assert_array_equal(unfilter_walk(rows, filters, bpp, plan, greedy), want)


def test_kernel_walk_at_the_band_heights():
    """The walk under the plan's own split on the edge cases' heights
    around and past 1024 rows (``UNFILTER_BAND_ROWS``), whose groups wrap
    round the image's warps."""
    for label, rows, filters, bpp in CASES:
        if rows.shape[1] in UNFILTER_BAND_ROWS:
            np.testing.assert_array_equal(unfilter_walk(rows[:1], filters[:1], bpp),
                                          host_unfilter(rows[:1], filters[:1], bpp), err_msg=label)


@settings(max_examples=25, deadline=None)
@given(b=st.integers(1, 3), h=st.integers(1, 9), rb=st.integers(1, 40), bpp=st.integers(1, 8),
       seed=st.integers(0, 2 ** 32 - 1))
def test_plain_equals_native_hypothesis(b, h, rb, bpp, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (b, h, rb), dtype=np.uint8)
    filters = rng.integers(0, 5, (b, h)).astype(np.int32)
    np.testing.assert_array_equal(_port(rows, filters, bpp), host_unfilter(rows, filters, bpp))


@pytest.mark.parametrize("bpp", [1, 3, 4, 6, 8])
@pytest.mark.parametrize("strategy", [FilterStrategy.SUB, FilterStrategy.PAETH, FilterStrategy.ADAPTIVE,
                                      FilterStrategy.MIN_SUM])
def test_unfilter_undoes_filter_rows(strategy, bpp):
    """unfilter(filter(x)) == x through the port's own filter stage."""
    rng = np.random.default_rng(43 + bpp)
    y, x = np.mgrid[0:9, 0:12 * bpp]
    raw = ((x * 3 + y * 5) % 256 + rng.integers(0, 9, (3, 9, 12 * bpp))).astype(np.uint8)
    out = kernels.filter_rows(torch.from_numpy(raw), bpp=bpp, strategy=strategy, small_image=False,
                              sticky_fast=False).numpy()
    np.testing.assert_array_equal(_port(np.ascontiguousarray(out[..., 1:]), out[..., 0], bpp), raw)


def test_single_image_and_input_forms():
    """``unfilter_device`` is the batch of one; numpy and tensor inputs and
    uint8 or int64 ids give the same rows; a view at a byte offset too."""
    label, rows, filters, bpp = CASES[0]
    want = _port(rows, filters, bpp)
    np.testing.assert_array_equal(unfilter_device(rows[1], filters[1], bpp=bpp, device="cpu").numpy(), want[1])
    flat = torch.empty(rows.size + 3, dtype=torch.uint8)
    view = flat[3:].view(rows.shape).copy_(torch.from_numpy(rows))
    for r, f in ((view, torch.from_numpy(filters).to(torch.uint8)), (rows, filters.astype(np.int64))):
        got = unfilter_device_batch(r, f, bpp=bpp, device="cpu")
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)
    assert unfilter_plain(torch.zeros((2, 0, 5), dtype=torch.uint8), torch.zeros((2, 0)), 3).shape == (2, 0, 5)


def test_bad_inputs_raise():
    rows = np.zeros((1, 2, 3), np.uint8)
    ids = np.zeros((1, 2), np.int32)
    for bpp in (0, 9):
        with pytest.raises(ValueError, match="bpp"):
            unfilter_device_batch(rows, ids, bpp=bpp, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        unfilter_device_batch(rows[0], ids, bpp=1, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        unfilter_device_batch(rows.astype(np.int16), ids, bpp=1, device="cpu")
    with pytest.raises(ValueError, match="filters"):
        unfilter_device_batch(rows, ids[:, :1], bpp=1, device="cpu")
    with pytest.raises(ValueError, match="filters"):
        unfilter_device_batch(rows, ids.astype(np.float32), bpp=1, device="cpu")
    with pytest.raises(ValueError, match="device"):
        unfilter_device_batch(rows, ids, bpp=1, device="meta")


def test_default_device_is_the_card():
    import inspect

    for fn in (unfilter_device_batch, unfilter_device):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
