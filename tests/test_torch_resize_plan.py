"""The resize kernel's plan and its device taps, on the CPU.

``ops/kernels.py::resize_plan`` decides, by shape alone, how
``csrc/resize.cu`` launches: the horizontal tile (output columns, row groups,
the source span it stages in shared memory) or the direct route, and the
vertical pass's granules, words or bytes. The card tests run each route; here the plan
is held to the tables ``lanczos_taps`` makes: every tile's span fits the
room the plan asks for, and the room fits the card's shared memory. The
kernel's device copy of the taps is padded to a multiple of 4 taps with
zero weights; run through the plain version, it gives the unpadded taps'
bytes, and those of the JAX package's serial numpy mirror. All exact: the
padding adds +0.0 to each sum, which changes no f32 value.
"""

import numpy as np
import pytest
import torch

from pixo_tpu.ops import resize_kernels as jrk

from chip_smoke import resize_cases
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.ops import resize_kernels as rk

CASES = resize_cases(np.random.default_rng(10))
LABELS = [label for label, *_ in CASES]


def _plan(host, dh, dw):
    b, h, w, c = host.shape
    kx = rk._taps_on(w, dw, torch.device("cpu"))[1].shape[1]
    ky = rk._taps_on(h, dh, torch.device("cpu"))[1].shape[1]
    return kernels.resize_plan(b, h, w, c, dh, dw, kx, ky), kx


def _spans(w, dw, cols):
    """The source span of every horizontal tile of ``cols`` columns: from
    the tile's least start to its greatest start plus the padded window."""
    starts, weights = rk.lanczos_taps(w, dw)
    k = -(-weights.shape[1] // 4) * 4
    return [int(starts[t:t + cols].max()) + k - int(starts[t:t + cols].min())
            for t in range(0, dw, cols)]


@pytest.mark.parametrize("case", range(len(CASES)), ids=LABELS)
def test_plan_picks_a_route_and_a_tile(case):
    _, host, dh, dw = CASES[case]
    b, h, w, c = host.shape
    plan, kx = _plan(host, dh, dw)
    n = dw * c
    assert plan.vertical == ("granules" if n % 16 == 0 else "words" if n % 4 == 0 else "bytes")
    if plan.horizontal == "direct":
        assert plan == (0, 0, 0, 0, plan.vertical)
        return
    assert plan.cols in kernels.RESIZE_TILE_COLS and plan.quads in (1, 2, 4, 8)
    assert plan.cols * plan.quads <= kernels.RESIZE_THREADS
    assert plan.cols >= min(dw, kernels.RESIZE_TILE_COLS[-1]) or plan.quads == 1
    assert plan.span >= kx
    assert plan.smem == kernels.resize_smem(plan.cols, plan.quads, plan.span, kx, c)
    assert plan.smem <= kernels.RESIZE_SMEM_BUDGET


@pytest.mark.parametrize("case", range(len(CASES)), ids=LABELS)
def test_every_tile_span_fits_its_room(case):
    _, host, dh, dw = CASES[case]
    plan, _ = _plan(host, dh, dw)
    if plan.horizontal == "tiled":
        assert max(_spans(host.shape[2], dw, plan.cols)) <= plan.span


@pytest.mark.parametrize("w", [1, 7, 100, 255, 256, 1000, 3220])
def test_span_bound_holds_across_scales(w):
    """Down- and upscales of one row length, tiles cut short included."""
    for dw in (1, 3, 31, 64, 127, 128, 129, 300, 513):
        plan = kernels.resize_plan(1, 8, w, 3, 8, dw, -(-rk.lanczos_taps(w, dw)[1].shape[1] // 4) * 4, 4)
        if plan.horizontal == "tiled":
            assert max(_spans(w, dw, plan.cols)) <= plan.span, (w, dw, plan)


def test_a_window_too_large_for_shared_memory_takes_the_direct_route():
    (case,) = [i for i, label in enumerate(LABELS) if label.startswith("a window past")]
    plan, kx = _plan(CASES[case][1], CASES[case][2], CASES[case][3])
    assert kx == 1504 and plan.horizontal == "direct"
    # one window of 32 columns, one row group, already past the budget
    k = kernels.RESIZE_SMEM_BUDGET // (4 * 32)
    assert kernels.resize_plan(1, 4, 1 << 20, 4, 4, 2, k, 4).horizontal == "direct"
    assert kernels.resize_plan(1, 4, 64, 4, 4, 2, 8, 4).horizontal == "tiled"


def test_plan_narrows_the_tile_before_it_goes_direct():
    """The large image: 256 threads' row groups do not fit, one group does."""
    plan = kernels.resize_plan(1, 1812, 3220, 3, 128, 128, 156, 88)
    assert (plan.horizontal, plan.cols, plan.quads) == ("tiled", 128, 1)
    assert kernels.resize_smem(128, 2, plan.span, 156, 3) > kernels.RESIZE_SMEM_BUDGET
    thumb = kernels.resize_plan(64, 256, 256, 3, 128, 128, 16, 16)
    assert (thumb.cols, thumb.quads, thumb.vertical) == (128, 2, "granules")


def test_pad_taps_appends_zero_weights():
    _, weights = rk.lanczos_taps(256, 128)
    padded = rk.pad_taps(torch.from_numpy(weights))
    assert padded.shape == (128, 16) and padded.dtype == torch.float32
    assert torch.equal(padded[:, :14], torch.from_numpy(weights))
    assert not padded[:, 14:].any()
    assert rk.pad_taps(padded).shape == padded.shape


def test_device_taps_are_padded_and_checked():
    starts, weights = rk.lanczos_taps(51, 77)
    sx, wx = kernels._device_taps(starts, weights, torch.device("cpu"), "x")
    assert sx.dtype == torch.int32 and wx.shape[1] % 4 == 0 and wx.data_ptr() % 16 == 0
    again = kernels._device_taps(sx, wx, torch.device("cpu"), "x")
    assert again[0] is sx and again[1] is wx
    with pytest.raises(TypeError):
        kernels._device_taps(starts.astype(np.int64), weights, torch.device("cpu"), "x")


@pytest.mark.parametrize("case", [i for i, label in enumerate(LABELS)
                                  if not label.startswith("one large image")],
                         ids=[label for label in LABELS if not label.startswith("one large image")])
def test_padded_taps_give_the_same_bytes(case):
    _, host, dh, dw = CASES[case]
    imgs = torch.from_numpy(host)
    sx, wx = rk.lanczos_taps(host.shape[2], dw)
    sy, wy = rk.lanczos_taps(host.shape[1], dh)
    want = kernels.resize_lanczos3_plain(imgs, sx, wx, sy, wy)
    px, py = rk._taps_on(host.shape[2], dw, torch.device("cpu")), rk._taps_on(host.shape[1], dh,
                                                                              torch.device("cpu"))
    assert px[1].shape[1] % 4 == 0 and py[1].shape[1] % 4 == 0
    got = kernels.resize_lanczos3_plain(imgs, *px, *py)
    assert torch.equal(got, want)
    for i in range(min(2, len(host))):  # the JAX package's serial numpy order
        np.testing.assert_array_equal(got[i].numpy(),
                                      jrk.resize_lanczos3_np(host[i], dst_w=dw, dst_h=dh))
