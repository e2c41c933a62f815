"""The port's device PNG unfilter against the JAX package's and the host
library's, on the CPU.

``unfilter_device_batch(..., device="cpu")`` runs the plain PyTorch
wavefront; it is held bit for bit (tolerance 0: the arithmetic is integer
mod 256) to the JAX package's jit ``unfilter_device_batch`` on XLA:CPU and
to the host library's ``native_png_unfilter``, on every filter id, every
bpp 1 to 8 and the edge shapes of ``chip_smoke.unfilter_edge_cases``.
``unfilter_walk`` runs ``csrc/unfilter.cu``'s schedule in numpy (a thread a
row, bands of rows in turn, the two shared-memory buffers by step parity,
each row's last bpp outputs and bytes above a byte each in one word): a change
to the kernel's walk goes through it first. Inputs come from numpy seeds.
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
    UNFILTER_BAND,
    unfilter_device,
    unfilter_device_batch,
    unfilter_plain,
)

jax.config.update("jax_platforms", "cpu")

CASES = unfilter_edge_cases(np.random.default_rng(41))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_walk(rows, filters, bpp, band=UNFILTER_BAND):
    """``csrc/unfilter.cu``'s schedule in numpy: a CTA an image; in a band of
    up to ``band`` rows, thread r reconstructs byte t - r at step t, reading
    the byte above from the shared buffer of step t - 1's parity (the
    band's first row: from the output row above, written by the band
    before), its a and c from the byte-a-slot words ``own`` and ``up``;
    every step's write goes to the buffer of its own parity."""
    b, h, rb = rows.shape
    out = np.zeros_like(rows)
    shift = np.uint64(8 * (bpp - 1))
    for img in range(b):
        for y0 in range(0, h, band):
            n = min(band, h - y0)
            last = np.zeros((2, band), np.int64)
            own = np.zeros(n, np.uint64)
            up = np.zeros(n, np.uint64)
            f = filters[img, y0: y0 + n].astype(np.int64)
            for t in range(rb + n - 1):
                r = np.arange(n)
                x = t - r
                live = (x >= 0) & (x < rb)
                r, x = r[live], x[live]
                y = y0 + r
                above_row = out[img, max(y0 - 1, 0), x].astype(np.int64)
                bv = np.where(y == 0, 0, np.where(r == 0, above_row, last[(t - 1) & 1, np.maximum(r - 1, 0)]))
                a = ((own[r] >> shift) & np.uint64(0xFF)).astype(np.int64)
                c = ((up[r] >> shift) & np.uint64(0xFF)).astype(np.int64)
                fr = f[r]
                pred = np.select([fr == 1, fr == 2, fr == 3, fr == 4], [a, bv, (a + bv) >> 1, _paeth(a, bv, c)], 0)
                v = (rows[img, y, x].astype(np.int64) + pred) & 0xFF
                out[img, y, x] = v
                last[t & 1, r] = v
                own[r] = (own[r] << np.uint64(8)) | v.astype(np.uint64)
                up[r] = (up[r] << np.uint64(8)) | bv.astype(np.uint64)
    return out


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
    """Bands far smaller than the kernel's put band edges inside every
    image: the walk's first row of a band reads the row above back from the
    output, as the kernel does."""
    rng = np.random.default_rng(42 + band + bpp)
    rows = rng.integers(0, 256, (2, 11, 4 * bpp + 3), dtype=np.uint8)
    filters = rng.integers(0, 5, (2, 11)).astype(np.int32)
    np.testing.assert_array_equal(unfilter_walk(rows, filters, bpp, band=band), host_unfilter(rows, filters, bpp))


def test_kernel_walk_at_the_band_heights():
    """The walk at the kernel's own band, on the heights around it."""
    for label, rows, filters, bpp in CASES:
        if rows.shape[1] in UNFILTER_BAND_ROWS and rows.shape[1] <= UNFILTER_BAND + 1:
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
