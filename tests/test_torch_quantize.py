"""The lossy PNG's host tier, plain versions and dither plan, on the CPU.

``pixo_tpu_torch/png/quantize.py`` is the host tier (numpy and the native
library) and is held to the JAX package's ``png/quantize.py`` function by
function. ``pixo_tpu_torch/ops/quantize_device.py`` holds the plain PyTorch
versions of the JAX package's jit functions (``ops/quantize_device.py``),
batched over images; they are held to those functions under jit on the CPU
with exact equality (every one is integer arithmetic or f32 on dyadic
values), as ``tests/test_kernel_equality.py`` holds the JAX functions to
the host tier. The card tests hold the CUDA kernels to these plain
versions. ``ops/kernels.py::dither_plan`` decides, by shape alone, the dither
kernel's warps, rings and path; ``band_model`` runs the kernel's schedule in
Python and is held to the plain version and the JAX function.
``kmeans_plan`` splits each image's real colours into the k-means kernel's
chunks, and ``kmeans_model`` runs that kernel's chunks and sum widths in
Python against the plain version, the host library and the JAX function.
The batch quantizer's routing past the kernels' limits (the dither's pixels,
the batch) is held with those limits patched small.
"""

import numpy as np
import pytest
import torch

from pixo_tpu.ops import quantize_device as jqd
from pixo_tpu.png import quantize as jq

from chip_smoke import dither_inputs, quantize_edge_cases, quantize_host_oracles
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.ops import quantize_device as qd
from pixo_tpu_torch.png import quantize as q


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The plain LUT (262,144 x 256 distances an image) is the heaviest CPU
    work of the suite: on two threads it leaves the other test workers their
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rng():
    return np.random.default_rng(1234)


def _gradient(h, w, shift=0, noise=6, channels=3, seed=0):
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    img = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy + shift) % 256], -1)
    img = np.clip(img + rng.integers(-noise, noise + 1, (h, w, 3)), 0, 255).astype(np.uint8)
    if channels == 4:
        img = np.concatenate([img, rng.integers(60, 256, (h, w, 1)).astype(np.uint8)], -1)
    return img


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---- the host tier against the JAX package's


@pytest.mark.parametrize("c", [3, 4])
def test_keys_rgba_matches(c):
    px = _rng().integers(0, 256, (1000, c), dtype=np.uint8)
    np.testing.assert_array_equal(q._keys_rgba(px), jq._keys_rgba(px))


@pytest.mark.parametrize("colors", [1, 40, 300, 5000], ids=lambda n: f"{n} colours")
@pytest.mark.parametrize("c", [3, 4])
def test_should_quantize_auto_matches(c, colors):
    rng = _rng()
    table = rng.integers(0, 256, (colors, c), dtype=np.uint8)
    px = table[rng.integers(0, colors, 60_000)]
    for max_colors in (64, 256):
        assert q.should_quantize_auto(px, max_colors) == jq.should_quantize_auto(px, max_colors)
    assert q.should_quantize_auto(px[:0], 64) is False


def test_nearest_palette_indices_matches():
    rng = _rng()
    colors = rng.integers(0, 256, (4096, 4), dtype=np.uint8)
    for k in (1, 7, 8, 100, 256):
        palette = rng.integers(0, 256, (k, 4), dtype=np.uint8)
        np.testing.assert_array_equal(q.nearest_palette_indices(colors, palette),
                                      jq.nearest_palette_indices(colors, palette))


@pytest.mark.parametrize("kind", ["few", "capped", "uniform ties", "strided"])
def test_sampled_histogram_matches(kind):
    """Below the 8192-colour cap, above it with uneven counts, above it with
    every count equal (the multiplicative-hash tie-break decides which
    colours stay), and an image large enough to be sampled with a stride."""
    rng = _rng()
    if kind == "few":
        px = rng.integers(0, 256, (30, 4), dtype=np.uint8)[rng.integers(0, 30, 5000)]
    elif kind == "capped":
        px = rng.integers(0, 256, (20_000, 3), dtype=np.uint8)[rng.zipf(1.5, 40_000) % 20_000]
    elif kind == "uniform ties":
        px = rng.integers(0, 256, (45_000, 3), dtype=np.uint8)
    else:
        px = _gradient(300, 400).reshape(-1, 3)
    colors, counts = q._sampled_histogram(px)
    ref_colors, ref_counts = jq._sampled_histogram(px)
    np.testing.assert_array_equal(colors, ref_colors)
    np.testing.assert_array_equal(counts, ref_counts)
    assert len(colors) <= 8192


@pytest.mark.parametrize("max_colors", [1, 2, 64, 256])
def test_median_cut_matches(max_colors):
    colors, counts = jq._sampled_histogram(_gradient(90, 120, noise=20).reshape(-1, 3))
    for refine in (False, True):
        np.testing.assert_array_equal(q.median_cut_palette(colors, counts, max_colors, refine),
                                      jq.median_cut_palette(colors, counts, max_colors, refine))


def test_median_cut_ties_keep_the_last_box():
    """Boxes of equal score: Rust's max_by_key takes the last, and so the
    palette's order follows; a box of one colour stops the cut."""
    colors = np.array([[0, 0, 0, 255], [10, 0, 0, 255], [100, 0, 0, 255], [110, 0, 0, 255],
                       [200, 0, 0, 255]], np.uint8)
    counts = np.array([5, 5, 5, 5, 1], np.uint32)
    for n in (2, 3, 4, 5, 8):
        np.testing.assert_array_equal(q.median_cut_palette(colors, counts, n, refine=False),
                                      jq.median_cut_palette(colors, counts, n, refine=False))
    empty = np.zeros((0, 4), np.uint8)
    np.testing.assert_array_equal(q.median_cut_palette(empty, np.zeros(0, np.uint32), 8),
                                  jq.median_cut_palette(empty, np.zeros(0, np.uint32), 8))


def test_refine_palette_kmeans_matches():
    rng = _rng()
    colors = rng.integers(0, 256, (1500, 4), dtype=np.uint8)
    counts = rng.integers(1, 900, 1500).astype(np.uint32)
    palette = rng.integers(0, 256, (100, 4), dtype=np.uint8)
    got = q.refine_palette_kmeans(palette, colors, counts)
    np.testing.assert_array_equal(got, jq.refine_palette_kmeans(palette, colors, counts))
    assert not np.array_equal(got, palette)


@pytest.mark.parametrize("k", [1, 8, 9, 64, 256])
def test_palette_lut_and_lookup_many_match(k):
    rng = _rng()
    palette = rng.integers(0, 256, (k, 4), dtype=np.uint8)
    lut, ref = q.PaletteLut(palette), jq.PaletteLut(palette)
    np.testing.assert_array_equal(lut.opaque_lut, np.asarray(ref.opaque_lut))
    rgba = rng.integers(0, 256, (3000, 4), dtype=np.uint8)
    rgba[::3, 3] = 255
    np.testing.assert_array_equal(lut.lookup_many(rgba), ref.lookup_many(rgba))


@pytest.mark.parametrize("has_alpha", [False, True])
def test_dither_native_matches_python_scan(has_alpha):
    """The host library's scan equals the JAX package's pixel-by-pixel one."""
    rng = _rng()
    h, w = 23, 37
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if not has_alpha:
        rgba[..., 3] = 255
    pal = rng.integers(0, 256, (48, 4), dtype=np.uint8)
    ref = jq._dither_fs_py(rgba.reshape(-1, 4), w, h, pal, jq.PaletteLut(pal))
    got = q._dither_floyd_steinberg(rgba.reshape(-1, 4), w, h, pal, q.PaletteLut(pal))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dithering", [False, True], ids=["undithered", "dithered"])
@pytest.mark.parametrize("image", ["gradient RGB", "gradient RGBA", "exact mapping"])
def test_quantize_image_matches(image, dithering):
    if image == "exact mapping":
        px = _rng().integers(0, 256, (50, 3), dtype=np.uint8)[_rng().integers(0, 50, 40 * 56)]
    else:
        px = _gradient(40, 56, channels=4 if "RGBA" in image else 3).reshape(40 * 56, -1)
    for max_colors in (64, 256):
        pal, idx = q.quantize_image(px, 56, 40, max_colors, dithering)
        ref_pal, ref_idx = jq.quantize_image(px, 56, 40, max_colors, dithering, mode="host")
        np.testing.assert_array_equal(pal, ref_pal)
        np.testing.assert_array_equal(idx, ref_idx)
        assert idx.dtype == np.uint8


def test_padding_and_weight_helpers_match():
    rng = _rng()
    colors = rng.integers(0, 256, (700, 4), dtype=np.uint8)
    counts = rng.integers(1, 50, 700).astype(np.uint32) * 7
    for a, b in zip(q._pad_hist(colors, counts), jq._pad_hist(colors, counts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(q._device_kmeans_weights(counts), jq._device_kmeans_weights(counts))
    bad = np.array([2**31 // 255, 2**31 // 255 + 1], np.uint32)
    assert q._device_kmeans_weights(bad) is None and jq._device_kmeans_weights(bad) is None
    zero = np.zeros(5, np.uint32)
    np.testing.assert_array_equal(q._device_kmeans_weights(zero), zero)
    for k in (1, 37, 256):
        pal = rng.integers(0, 256, (k, 4), dtype=np.uint8)
        np.testing.assert_array_equal(q._pad_palette(pal), jq._pad_palette(pal))


# ---- the plain versions against the JAX functions under jit


def test_nearest_palette_matches_jax():
    rng = _rng()
    colors = rng.integers(0, 256, (4096, 4), dtype=np.uint8)
    palette = rng.integers(0, 256, (256, 4), dtype=np.uint8)
    got = qd.nearest_palette(_t(colors), _t(palette))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jqd.nearest_palette_device(colors, palette)))
    np.testing.assert_array_equal(qd.redmean_dist(_t(colors[:9]), _t(palette)).numpy(),
                                  np.asarray(jqd._redmean_dist(colors[:9], palette)))


def test_nearest_palette_ties_prefer_first():
    palette = np.array([[10, 10, 10, 255], [10, 10, 10, 255], [200, 0, 0, 255]], np.uint8)
    colors = np.array([[10, 10, 10, 255], [200, 0, 0, 255]], np.uint8)
    assert qd.nearest_palette(_t(colors), _t(palette)).tolist() == [0, 2]
    assert np.asarray(jqd.nearest_palette_device(colors, palette)).tolist() == [0, 2]


def test_kmeans_refine_padded_matches_jax_and_host():
    rng = _rng()
    colors = rng.integers(0, 256, (1500, 4), dtype=np.uint8)
    counts = rng.integers(1, 900, 1500).astype(np.uint32)
    palette = rng.integers(0, 256, (100, 4), dtype=np.uint8)
    pc, pw = q._pad_hist(colors, counts)
    padded = q._pad_palette(palette)
    got = qd.kmeans_refine(_t(padded)[None], _t(pc)[None], _t(pw.astype(np.int32))[None],
                           torch.tensor([100], dtype=torch.int32))[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jqd.kmeans_refine_device(padded, pc, pw, np.int32(100))))
    np.testing.assert_array_equal(got[:100], q.refine_palette_kmeans(palette, colors, counts))


def test_kmeans_refine_large_image_weights():
    """Stride-scaled counts of a ~12 MP image: reduced by their GCD, the
    weights fit int32 and give the host tier's uint64 centroids."""
    rng = _rng()
    colors = rng.integers(0, 256, (800, 4), dtype=np.uint8)
    counts = (rng.integers(1, 120, 800).astype(np.uint64) * 241).astype(np.uint32)
    assert int(counts.sum(dtype=np.uint64)) * 255 >= 2**31
    palette = rng.integers(0, 256, (64, 4), dtype=np.uint8)
    dw = q._device_kmeans_weights(counts)
    assert dw is not None and int(dw.sum(dtype=np.uint64)) * 255 < 2**31
    pc, pw = q._pad_hist(colors, dw)
    got = qd.kmeans_refine(_t(palette)[None], _t(pc)[None], _t(pw.astype(np.int32))[None],
                           torch.tensor([64], dtype=torch.int32))[0].numpy()
    np.testing.assert_array_equal(got, q.refine_palette_kmeans(palette, colors, counts))
    np.testing.assert_array_equal(got, np.asarray(jqd.kmeans_refine_device(palette, pc, pw, np.int32(64))))


def test_kmeans_refine_batch_matches_vmap():
    """Three images with their own palettes and sizes (k_valid 1, 37 and
    256) in one call: each equals the JAX function on its own."""
    rng = _rng()
    pals = rng.integers(0, 256, (3, 256, 4), dtype=np.uint8)
    colors = rng.integers(0, 256, (3, 2048, 4), dtype=np.uint8)
    weights = rng.integers(0, 400, (3, 2048)).astype(np.int32)
    k_valid = np.array([1, 37, 256], np.int32)
    got = qd.kmeans_refine(_t(pals), _t(colors), _t(weights), _t(k_valid)).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], np.asarray(jqd.kmeans_refine_device(
            pals[i], colors[i], weights[i], np.int32(k_valid[i]))))


def test_palette_lut_matches_jax():
    palette = _rng().integers(0, 256, (64, 4), dtype=np.uint8)
    got = qd.palette_lut(_t(palette)[None])[0].numpy()
    np.testing.assert_array_equal(got, np.asarray(jqd.palette_lut_device(palette)))
    np.testing.assert_array_equal(qd.lut_grid(), jq._lut_grid())


def test_palette_lut_k_valid_matches_jax_on_the_real_entries():
    """Two palettes of 64 entries scanned to their first 9 and 64 (and to 1
    for a k_valid of 0, as the kernel clamps it): each equals the JAX
    function on those entries alone, and a palette padded with entry 0
    gives the same LUT scanned to its real entries or in full."""
    rng = _rng()
    pals = rng.integers(0, 256, (3, 64, 4), dtype=np.uint8)
    k_valid = np.array([9, 64, 0], np.int32)
    got = qd.palette_lut(_t(pals), _t(k_valid)).numpy()
    for i, kv in enumerate((9, 64, 1)):
        np.testing.assert_array_equal(got[i], np.asarray(jqd.palette_lut_device(pals[i, :kv])))
    padded = q._pad_palette(pals[0, :9], 64)[None]
    np.testing.assert_array_equal(qd.palette_lut(_t(padded), _t(k_valid[:1])).numpy(),
                                  qd.palette_lut(_t(padded)).numpy())


@pytest.mark.parametrize("has_alpha", [False, True])
def test_dither_matches_jax(has_alpha):
    """Two 23x37 images with their own palettes in one call."""
    rng = _rng()
    rgba = rng.integers(0, 256, (2, 23, 37, 4), dtype=np.uint8)
    if not has_alpha:
        rgba[..., 3] = 255
    pals = rng.integers(0, 256, (2, 48, 4), dtype=np.uint8)
    luts = np.stack([np.asarray(jq.PaletteLut(p).opaque_lut) for p in pals])
    got = qd.dither_fs(_t(rgba), _t(pals), _t(luts))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, 23, 37)
    ref = np.asarray(jqd.dither_fs_device(rgba, pals, luts, has_alpha=has_alpha))
    np.testing.assert_array_equal(got.numpy().astype(np.int32), ref)
    for i in range(2):
        np.testing.assert_array_equal(
            got[i].numpy().reshape(-1),
            jq._dither_fs_py(rgba[i].reshape(-1, 4), 37, 23, pals[i], jq.PaletteLut(pals[i])))


def test_dither_k_valid_matches_jax_on_the_real_entries():
    """Pixels with alpha take the direct redmean over the first k_valid
    entries only: each image equals the JAX function given those entries."""
    rng = _rng()
    rgba = rng.integers(0, 256, (2, 23, 37, 4), dtype=np.uint8)
    rgba[..., 3] = rng.choice(np.array([0, 128, 255, 255], np.uint8), (2, 23, 37))
    pals = rng.integers(0, 256, (2, 48, 4), dtype=np.uint8)
    k_valid = np.array([11, 48], np.int32)
    luts = np.stack([np.asarray(jq.PaletteLut(pals[i, :kv]).opaque_lut) for i, kv in enumerate(k_valid)])
    got = qd.dither_fs(_t(rgba), _t(pals), _t(luts), _t(k_valid)).numpy()
    for i, kv in enumerate(k_valid):
        ref = jqd.dither_fs_device(rgba[i:i + 1], pals[i:i + 1, :kv], luts[i:i + 1], has_alpha=True)
        np.testing.assert_array_equal(got[i].astype(np.int32), np.asarray(ref)[0])


# the edge cases the card tests hold the kernels to, here through the wrappers
# on the CPU (their plain versions) against the host library; dithers of more
# than 1,000 wavefront steps are left to the card
EDGE = [(name, label, args) for name, cases in quantize_edge_cases(np.random.default_rng(12)).items()
        for label, *args in cases
        if name != "dither_fs" or args[0].shape[2] + 2 * args[0].shape[1] <= 1000]


@pytest.mark.parametrize("case", range(len(EDGE)), ids=[f"{n}-{label}" for n, label, _ in EDGE])
def test_wrappers_on_the_cpu_at_edge_cases_equal_host_library(case):
    name, _, args = EDGE[case]
    if name == "dither_fs":
        args = dither_inputs(*args)
    got = getattr(kernels, name)(*[_t(a) for a in args])
    assert torch.equal(got, getattr(qd, name)(*[_t(a) for a in args]))
    for i, h in enumerate(quantize_host_oracles(name, args)):
        np.testing.assert_array_equal(got[i].numpy()[:len(h)], h)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    pal = torch.zeros((1, 4, 4), dtype=torch.uint8)
    with pytest.raises(ValueError, match="palettes of 1 to 256"):
        kernels.palette_lut(torch.zeros((1, 257, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="palette must be"):
        kernels.palette_lut(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(TypeError, match="int32"):
        kernels.kmeans_refine(pal, pal, torch.zeros((1, 4), dtype=torch.int64),
                              torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.dither_fs(torch.zeros((1, 4, 8, 4), dtype=torch.uint8)[:, :, ::2], pal,
                          torch.zeros((1, kernels.LUT_SIZE), dtype=torch.uint8))
    with pytest.raises(ValueError, match="non-empty"):
        kernels.dither_fs(torch.zeros((1, 0, 4, 4), dtype=torch.uint8), pal,
                          torch.zeros((1, kernels.LUT_SIZE), dtype=torch.uint8))


# ---- the dither kernel's plan and a model of its schedule


PLAN_SHAPES = [(1, 1), (1, 7000), (40, 1), (23, 37), (31, 70), (65, 70), (512, 512), (513, 2000),
               (2000, 513), (7000, 3), (1100, 40), (70, 4000), (1100, 2500), (1056, 55_000),
               (16384, 32767)]


@pytest.mark.parametrize("h,w", PLAN_SHAPES, ids=[f"{h}x{w}" for h, w in PLAN_SHAPES])
def test_dither_plan_fits_the_card(h, w):
    """At most 32 warps and one a band; the least that finishes a band (W +
    62 steps) before its next is due (65 steps a warp later) where the cap
    does not bind; rings of a multiple of 32 slots, 128 where no band waits
    for its warp, holding a row where bands wrap (warps x (slots - 65) >=
    W); in shared memory beside the palette where they fit 227 KB; a path
    of W + 2(H - 1) steps and one a band edge, longer where the cap binds."""
    plan = kernels.dither_plan(h, w)
    lag, bands = kernels.DITHER_LAG, -(-h // 32)
    assert lag == 65
    assert 1 <= plan.warps <= min(kernels.DITHER_MAX_WARPS, bands)
    if plan.warps < min(kernels.DITHER_MAX_WARPS, bands):
        assert lag * plan.warps >= w + 62 > lag * (plan.warps - 1)
    assert plan.ring_slots % 32 == 0 and plan.ring_slots >= 128
    if bands > plan.warps:
        assert plan.warps * (plan.ring_slots - lag) >= w
    else:
        assert plan.ring_slots == 128
    ring_bytes = 4 * plan.warps * plan.ring_slots
    assert plan.ring == ("shared" if ring_bytes <= kernels.DITHER_RING_SMEM else "global")
    assert plan.smem == (ring_bytes if plan.ring == "shared" else 0)
    assert plan.smem + 4096 <= 232448  # the palette's 4 KB beside the rings
    capped = bands > plan.warps and w + 62 > lag * plan.warps
    assert plan.steps == w + 2 * (h - 1) + plan.grown
    assert (plan.grown > bands - 1) == capped and plan.grown >= bands - 1


def test_dither_plan_refuses_an_empty_image():
    for h, w in ((0, 5), (5, 0)):
        with pytest.raises(ValueError, match="at least one pixel"):
            kernels.dither_plan(h, w)


def test_dither_plan_refuses_images_past_32_bit_offsets():
    """The kernel's per-image offsets, 4 bytes a pixel, are 32-bit."""
    assert kernels.dither_plan(1, kernels.DITHER_MAX_PIXELS).warps == 1
    for h, w in ((1, kernels.DITHER_MAX_PIXELS + 1), (65535, 65535)):
        with pytest.raises(ValueError, match="at most"):
            kernels.dither_plan(h, w)


@pytest.mark.parametrize("h,w,grown", [(1100, 2500, 516), (1100, 10_000, 8016)])
def test_dither_plan_steps_where_the_cap_binds(h, w, grown):
    """35 bands on 32 warps of 2,562 and 10,062 steps a band: warp 0's
    second band (band 32) starts when its first ends, not at step 32 x 65,
    and the path grows by that beside its step a band edge."""
    plan = kernels.dither_plan(h, w)
    assert plan.warps == 32 and plan.grown == grown
    assert plan.steps == (w + 62) + 2 * 65 + w + 2 * (h - 34 * 32 - 1)


FREE = None  # a ring slot's free mark (csrc/quantize.cu's kRingFree)


def _redmean_argmin(a, alpha, pal):
    """``csrc/redmean.cuh::nearest`` of colours a [n, 3] with alphas [n]
    over pal [k, 4]."""
    c = np.concatenate([a, alpha[:, None]], 1)[:, None, :]
    p = pal[None].astype(np.int64)
    d = c - p
    rm = (c[..., 0] + p[..., 0]) >> 1
    dist = (((512 + rm) * d[..., 0] ** 2 + 1024 * d[..., 1] ** 2 + (767 - rm) * d[..., 2] ** 2) >> 8
            ) + d[..., 3] ** 2
    return dist.argmin(1)


def band_model(rgba, pal, lut, kv, warps, slots, pixels=True):
    """``csrc/quantize.cu::dither_fs_kernel``'s schedule in Python, for one
    image rgba [H, W, 4] with its palette [K, 4], LUT and k_valid: warp j
    takes bands j, j + warps, ..., a lane a row; each tick every warp that
    can runs one step. At step s, lane 0 takes the row above's column s + 1,
    read at the step before, and reads column s + 2 from its ring (slots a
    column, each holding an error or FREE: it waits for the slot to fill and
    frees it), every lane takes the lane above's error of the last step (the
    shuffle), and lane 31 writes its error into the next warp's
    ring, the last warp's feeding warp 0; at every 32nd column the writer
    waits until the slot 31 ahead is free. What a warp writes or frees in a
    tick, the others see in the next. Returns (indices [H, W], ticks);
    raises where no warp can move (a deadlock). With ``pixels`` False it
    moves the schedule alone."""
    h, w = rgba.shape[:2]
    bands, lanes = -(-h // 32), np.arange(32)
    rings = [[FREE] * slots for _ in range(warps)]
    out = np.zeros((h, w), np.uint8)
    pal = pal.astype(np.int64)
    zero = np.zeros(3, np.int64)

    def band_start(warp):
        warp.update(s=0, pending=None, up=np.zeros((3, 32, 3), np.int64), me=np.zeros((32, 3), np.int64),
                    above=np.zeros(3, np.int64))

    state = [dict(c=j, rs=0, ws=0) for j in range(warps)]
    for warp in state:
        band_start(warp)
    ticks = 0
    while any(warp["c"] < bands for warp in state):
        frees, writes, moved = [], [], False
        for j, warp in enumerate(state):
            c, s = warp["c"], warp["s"]
            if c >= bands:
                continue
            ring_in, out_ring = rings[j], (j + 1) % warps
            if warp["pending"] is None:  # the step's reads and arithmetic
                cols = [x for x in ((0, 1, 2) if s == 0 else (s + 2,)) if x < w] if c > 0 else []
                got = [ring_in[(warp["rs"] + i) % slots] for i in range(len(cols))]
                if any(v is FREE for v in got):
                    continue  # lane 0 waits for the band above
                frees += [(j, (warp["rs"] + i) % slots) for i in range(len(cols))]
                warp["rs"] = (warp["rs"] + len(cols)) % slots
                up = warp["up"]
                if s == 0 and got:  # er(y-1, 0) and er(y-1, 1), read before the first step
                    up[0, 0] = got.pop(0)
                    warp["above"] = got.pop(0) if got else zero
                up[2], up[1] = up[1].copy(), up[0].copy()
                up[0] = np.concatenate([warp["above"][None], warp["me"][:-1]])
                warp["above"] = got[0] if got else zero  # er(y-1, s + 2), read a step ahead
                e = np.zeros((32, 3), np.int64)
                if pixels:
                    y, x = 32 * c + lanes, s - 2 * lanes
                    act = (y < h) & (x >= 0) & (x < w)
                    px = rgba[np.minimum(y, h - 1), np.clip(x, 0, w - 1)].astype(np.int64)
                    a = np.clip((16 * px[:, :3] + 7 * warp["me"] + up[2] + 5 * up[1] + 3 * up[0]) >> 4,
                                0, 255)
                    idx = lut[(a[:, 0] >> 2) << 12 | (a[:, 1] >> 2) << 6 | (a[:, 2] >> 2)].astype(np.int64)
                    if (px[:, 3] != 255).any():
                        idx = np.where(px[:, 3] == 255, idx, _redmean_argmin(a, px[:, 3], pal[:kv]))
                    e = np.where(act[:, None], a - pal[idx, :3], 0)
                    out[y[act], x[act]] = idx[act]
                warp["me"], warp["pending"] = e, e[31]
                moved = True
            x31 = s - 62
            if c + 1 < bands and 0 <= x31 < w:  # lane 31 writes er(y, x31)
                if x31 % 32 == 0 and rings[out_ring][(warp["ws"] + 31) % slots] is not FREE:
                    continue  # the writer waits for free slots
                assert rings[out_ring][warp["ws"]] is FREE
                writes.append((out_ring, warp["ws"], warp["pending"]))
                warp["ws"] = (warp["ws"] + 1) % slots
            moved = True
            warp["pending"], warp["s"] = None, s + 1
            if warp["s"] == w + 2 * (min(32, h - 32 * c) - 1):
                warp["c"] = c + warps
                band_start(warp)
        for r, i in frees:
            rings[r][i] = FREE
        for r, i, v in writes:
            rings[r][i] = v
        ticks += 1
        if not moved:
            raise RuntimeError(f"deadlock after {ticks} ticks")
    return out, ticks


MODEL_CASES = [("3x5", 3, 5, False, None), ("33x9", 33, 9, False, None),
               ("70x40 on 2 warps", 70, 40, False, None), ("alpha, k_valid 10 of 64", 37, 23, True, 10)]


@pytest.mark.parametrize("case", MODEL_CASES, ids=[c[0] for c in MODEL_CASES])
def test_band_model_matches_plain_and_jax(case):
    """The kernel's schedule, laid out as the plan lays it out, gives the
    reference's indices in the plan's steps: held to the plain version and
    to the JAX function."""
    _, h, w, alpha, kv = case
    rng = _rng()
    rgba = rng.integers(0, 256, (1, h, w, 4), dtype=np.uint8)
    if alpha:
        rgba[..., 3] = rng.choice(np.array([0, 128, 255, 255], np.uint8), (1, h, w))
    else:
        rgba[..., 3] = 255
    pal = rng.integers(0, 256, (1, 64, 4), dtype=np.uint8)
    kv = kv or 64
    lut = np.asarray(jq.PaletteLut(pal[0, :kv]).opaque_lut)[None]
    plan = kernels.dither_plan(h, w)
    got, ticks = band_model(rgba[0], pal[0], lut[0], kv, plan.warps, plan.ring_slots)
    assert ticks == plan.steps
    if h == 70:
        assert plan.warps == 2 and -(-h // 32) > plan.warps  # band 2 on warp 0: the ring wraps
    plain = qd.dither_fs(_t(rgba), _t(pal), _t(lut), torch.tensor([kv], dtype=torch.int32))[0].numpy()
    np.testing.assert_array_equal(got, plain)
    ref = jqd.dither_fs_device(rgba, pal[:, :kv], lut, has_alpha=alpha)
    np.testing.assert_array_equal(got.astype(np.int32), np.asarray(ref)[0])


@pytest.mark.parametrize("slots,deadlocks", [(96, True), (None, False)], ids=["96 slots", "the plan's"])
def test_band_model_back_pressure_needs_a_row_of_slots(slots, deadlocks):
    """130x300 forced onto 2 warps: 5 bands of 362 steps wrap round them,
    so each warp's next band waits. With rings of 96 slots (2 x (96 - 64)
    < 300) every warp ends up waiting on a full ring; with
    ``dither_ring_slots``' 224 the model runs through to the reference."""
    rng = _rng()
    rgba = rng.integers(0, 256, (1, 130, 300, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    pal = rng.integers(0, 256, (1, 32, 4), dtype=np.uint8)
    lut = np.asarray(jq.PaletteLut(pal[0]).opaque_lut)
    slots = slots or kernels.dither_ring_slots(300, 2, 5)
    if deadlocks:
        with pytest.raises(RuntimeError, match="deadlock"):
            band_model(rgba[0], pal[0], lut, 32, 2, slots, pixels=False)
        return
    got, _ = band_model(rgba[0], pal[0], lut, 32, 2, slots)
    plain = qd.dither_fs(_t(rgba), _t(pal), _t(lut[None]))[0].numpy()
    np.testing.assert_array_equal(got, plain)


def test_band_model_keeps_the_plans_steps_where_the_cap_binds():
    """1100x2500: 35 bands on 32 warps; the ring that feeds warp 0 fills
    while warp 0 finishes its first band, and the writers' waits add no
    step to the plan's path."""
    plan = kernels.dither_plan(1100, 2500)
    zeros = np.zeros((1100, 2500, 4), np.uint8)
    _, ticks = band_model(zeros, np.zeros((1, 4), np.uint8), np.zeros(kernels.LUT_SIZE, np.uint8), 1,
                          plan.warps, plan.ring_slots, pixels=False)
    assert plan.grown > 0 and ticks == plan.steps


# ---- the batch quantizer against the JAX package's


def test_quantize_batch_on_the_cpu_matches_jax_and_per_image():
    """Three gradients (the device stage) and a 40-colour image (the exact
    mapping), dithered and not: each result equals the JAX package's
    ``quantize_batch`` and the port's per-image ``quantize_image``."""
    imgs = np.stack([_gradient(32, 44, shift=37 * s, seed=s) for s in range(3)]
                    + [_rng().integers(0, 256, (40, 3), dtype=np.uint8)[_rng().integers(0, 40, (32, 44))]])
    for dithering in (True, False):
        batch = q.quantize_host_stage(imgs, 48, dithering)
        assert batch.members == [0, 1, 2] and batch.results[3] is not None
        got = q.quantize_batch(imgs, 48, dithering, device="cpu")
        ref = jq.quantize_batch(imgs, 48, dithering)
        for i in range(4):
            for a, b, c in zip(got[i], ref[i], q.quantize_image(imgs[i].reshape(-1, 3), 44, 32, 48,
                                                                 dithering)):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


def _lossy_images(n, h=24, w=32):
    return np.stack([_gradient(h, w, shift=29 * s, seed=s) for s in range(n)])


def test_quantize_batch_sends_images_past_the_dither_to_the_host_tier(monkeypatch):
    """An image past ``kernels.DITHER_MAX_PIXELS`` (patched to 24 x 32 - 1
    pixels) takes the host tier when dithered and the device stage when
    not; either way each result equals ``quantize_image`` and the JAX
    package's ``quantize_batch``."""
    imgs = _lossy_images(3)
    monkeypatch.setattr(kernels, "DITHER_MAX_PIXELS", 24 * 32 - 1)
    for dithering in (True, False):
        batch = q.quantize_host_stage(imgs, 16, dithering)
        assert batch.members == ([] if dithering else [0, 1, 2])
        assert all((r is not None) == dithering for r in batch.results)
        got = q.quantize_batch(imgs, 16, dithering, device="cpu")
        ref = jq.quantize_batch(imgs, 16, dithering)
        for i in range(3):
            for a, b, c in zip(got[i], ref[i], q.quantize_image(imgs[i].reshape(-1, 3), 32, 24, 16,
                                                                 dithering)):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)


def test_quantize_batch_runs_the_device_stage_in_groups(monkeypatch):
    """With ``kernels.QUANTIZE_MAX_BATCH`` patched to 2, five quantized
    images (and an exact-mapped one between them) go through the wrappers
    in three groups and give the unsplit batch's results, in order."""
    imgs = _lossy_images(6)
    imgs[2] = _rng().integers(0, 256, (10, 3), dtype=np.uint8)[_rng().integers(0, 10, (24, 32))]
    whole = q.quantize_batch(imgs, 16, True, device="cpu")
    calls = []
    plain = kernels.kmeans_refine

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return plain(*args, **kw)

    monkeypatch.setattr(kernels, "QUANTIZE_MAX_BATCH", 2)
    monkeypatch.setattr(kernels, "kmeans_refine", counted)
    got = q.quantize_batch(imgs, 16, True, device="cpu")
    assert calls == [2, 2, 1]
    ref = jq.quantize_batch(imgs, 16, True)
    for g, w, r in zip(got, whole, ref):
        for a, b, c in zip(g, w, r):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_the_wrappers_refuse_a_batch_past_the_limit(monkeypatch):
    monkeypatch.setattr(kernels, "QUANTIZE_MAX_BATCH", 2)
    with pytest.raises(ValueError, match="a batch of 1 to 2 palettes"):
        kernels.palette_lut(torch.zeros((3, 4, 4), dtype=torch.uint8))


# ---- the k-means kernel's schedule and a model of its sums


Q1_COUNTS = (1049, 1024, 1040, 1021, 258, 259, 258, 8192, 8192, 8192, 8192, 656, 659, 644, 655)
PLAN_COUNTS = [Q1_COUNTS, (8192,) * 16, (0, 5), (1,), (63, 64, 65, 1025), (8192,) * 300]


@pytest.mark.parametrize("counts", PLAN_COUNTS, ids=["(q1)", "(q2)", "0 and 5", "1", "63-1025", "300 full"])
def test_kmeans_plan_takes_every_colour_once(counts):
    """Every colour of image i below counts[i] lies in exactly one chunk of
    image i; no chunk crosses an image; each image's chunks are its own
    count and differ in size by at most one, each at most ``per_chunk``
    (64 to 1024); an image without colours has one empty chunk."""
    plan = kernels.kmeans_plan(counts)
    assert kernels.KMEANS_CHUNK_MIN <= plan.per_chunk <= kernels.KMEANS_CHUNK_MAX
    assert plan.chunks.dtype == np.int32 and plan.chunks.shape[1] == 4
    for i, n in enumerate(counts):
        mine = plan.chunks[plan.chunks[:, 0] == i]
        assert len(mine) >= 1 and (mine[:, 3] == len(mine)).all()
        seen = np.zeros(n, np.int64)
        for _, first, last, _ in mine:
            assert 0 <= first <= last <= n and last - first <= plan.per_chunk
            seen[first:last] += 1
        assert (seen == 1).all()
        sizes = mine[:, 2] - mine[:, 1]
        assert sizes.max() - sizes.min() <= 1 and (n == 0) == (sizes.max() == 0)
    images = plan.chunks[:, 0]
    assert (np.diff(images) >= 0).all() and set(images.tolist()) == set(range(len(counts)))


def test_kmeans_plan_fills_the_card_at_q1():
    """(q1)'s 40,291 real colours in 15 images: at least a chunk an SM, and
    no SM held back by one image (the largest chunk is at most twice the
    mean share of an SM's CTA)."""
    plan = kernels.kmeans_plan(Q1_COUNTS)
    assert len(plan.chunks) >= kernels.H100_SMS
    sizes = plan.chunks[:, 2] - plan.chunks[:, 1]
    assert sizes.max() <= 2 * sum(Q1_COUNTS) / len(plan.chunks)


def test_kmeans_wrapper_refuses_bad_counts():
    pal = torch.zeros((2, 4, 4), dtype=torch.uint8)
    cols, w, kv = torch.zeros((2, 8, 4), dtype=torch.uint8), torch.zeros((2, 8), dtype=torch.int32), \
        torch.ones(2, dtype=torch.int32)
    for counts in ((8,), (9, 1), (-1, 3)):
        with pytest.raises(ValueError, match="counts must be"):
            kernels.kmeans_refine(pal, cols, w, kv, counts)
    with pytest.raises(ValueError, match="at least 0"):
        kernels.kmeans_plan((3, -1))


def kmeans_model(pal, colors, weights, k_valid, counts=None):
    """``csrc/quantize.cu::kmeans_refine_kernel``'s two launches in Python:
    the plan's chunks, a warp's 32 colours at a time, each colour's sums
    added to 32-bit sums where the chunk's weight keeps 255 w under 2^32
    (uint32 arithmetic, so an overflow would show), 64-bit sums otherwise,
    then the global sums and the update's 32-bit or 64-bit division."""
    b, k = pal.shape[:2]
    m = colors.shape[1]
    plan = kernels.kmeans_plan(tuple(int(n) for n in (counts if counts is not None else [m] * b)))
    cur = pal.copy()
    for _ in range(2):
        acc = np.zeros((b, k, 5), np.uint64)
        for image, first, last, _ in plan.chunks:
            kv = min(max(int(k_valid[image]), 1), k)
            wt = weights[image].astype(np.uint32)
            narrow = int(wt[first:last].sum(dtype=np.uint64)) <= 0xFFFFFFFF // 255
            sums = np.zeros((k, 5), np.uint32 if narrow else np.uint64)
            for base in range(first, last, 32):
                i = base + np.arange(32)
                on = i < last
                w = np.where(on, wt[np.minimum(i, m - 1)], 0).astype(np.uint32)
                if not w.any():
                    continue
                c = np.where(on[:, None], colors[image][np.minimum(i, m - 1)], 0).astype(np.int64)
                idx = _redmean_argmin(c[:, :3], c[:, 3], cur[image, :kv])
                kind = np.uint32 if narrow else np.uint64
                for lane in np.nonzero(w)[0]:  # uint32 products and sums wrap, so an overflow would show
                    sums[idx[lane]] += np.append(c[lane].astype(kind) * kind(w[lane]), kind(w[lane]))
            acc[image] += sums.astype(np.uint64)
        total = acc[..., 4:]
        cur = np.where(total > 0, acc[..., :4] // np.maximum(total, 1), cur).astype(np.uint8)
    return cur


KMEANS_MODEL_CASES = [(label, args) for label, *args in
                      quantize_edge_cases(np.random.default_rng(12))["kmeans_refine"]
                      if args[1].shape[0] * args[1].shape[1] <= 20_000]


@pytest.mark.parametrize("case", range(len(KMEANS_MODEL_CASES)), ids=[c[0] for c in KMEANS_MODEL_CASES])
def test_kmeans_model_matches_plain_and_jax(case):
    """The kernel's chunks, group sums and sum widths give the plain
    version's palettes and, image by image, the host library's and, where
    its int32 sums hold them (255 x the image's weight below 2^31, as
    ``png/quantize.py`` keeps it), the JAX function's."""
    _, args = KMEANS_MODEL_CASES[case]
    got = kmeans_model(*args)
    np.testing.assert_array_equal(got, qd.kmeans_refine(*[_t(a) for a in args[:4]]).numpy())
    pal, colors, weights, k_valid = args[:4]
    for i, host in enumerate(quantize_host_oracles("kmeans_refine", args)):
        np.testing.assert_array_equal(got[i][:len(host)], host)
        if 255 * int(weights[i].sum(dtype=np.int64)) < 2**31:
            np.testing.assert_array_equal(got[i], np.asarray(jqd.kmeans_refine_device(
                pal[i], colors[i], weights[i], np.int32(k_valid[i]))))
