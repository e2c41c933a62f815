"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so on a machine with the card and
without JAX it runs on its own:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import (
    AAN_COUNTS,
    ADLER_SIZES,
    ADLER_STARTS,
    COUNT_PATTERNS,
    TRELLIS_PATTERNS,
    aan_cases,
    adler_boundary_sizes,
    at_offset,
    check_dither_repeats,
    coeff_edge_cases,
    compact_edge_batch,
    count_edge_blocks,
    count_shares,
    dct_zz_tile_cases,
    dither_global_ring,
    dither_inputs,
    dither_repeat_case,
    bigram_edge_cases,
    env_var,
    filter_edge_cases,
    host_decode,
    host_unfilter,
    lossy_options,
    lz77_cases,
    match_pairs,
    plane_edge_case,
    quantize_edge_cases,
    quantize_host_oracles,
    resize_cases,
    trellis_edge_blocks,
    trellis_mixed_blocks,
    trellis_random_blocks,
    UNFILTER_FORCED,
    unfilter_edge_cases,
    unfilter_launcher,
)
from pixo_tpu_torch import (
    ColorType,
    FilterStrategy,
    JpegOptions,
    PngOptions,
    Subsampling,
    encode_jpeg_batch_sharded,
    encode_png_batch_sharded,
    encode_png_row_sharded,
    jpeg,
    png,
    thumbnail_pipeline,
)
from pixo_tpu_torch.compress import checksums, deflate
from pixo_tpu_torch.decode import decode_jpeg_batch, jpeg_decoder
from pixo_tpu_torch.jpeg.tables import ZIGZAG, QuantizationTables
from pixo_tpu_torch.native import (
    native_count_symbols,
    native_jpeg_coefficients,
    native_jpeg_dct_zz,
    native_png_filter,
    native_resize_lanczos3,
    native_trellis_quantize,
)
from pixo_tpu_torch.ops import (
    dct,
    huffman_device,
    jpeg_decode,
    kernels,
    lz77_assist,
    png_filters,
    png_unfilter,
    quantize_device,
    resize_kernels,
    sparse_pack,
    trellis_device,
)
from pixo_tpu_torch.options import ResizeFilter, ResizeOptions
from pixo_tpu_torch.resize import resize

pytestmark = pytest.mark.cuda

MODES = ["gray", "444", "420", "422"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def seeded():
    return np.random.default_rng(2024)


def _pixels(rng, b, h, w, mode):
    shape = (b, h, w) if mode == "gray" else (b, h, w, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("q", [1, 50, 85, 100])
@pytest.mark.parametrize("mode", MODES)
def test_coeffs_kernel_equals_plain(dev, seeded, mode, q):
    """Odd sizes exercise the clamp padding; q 1..100 the quantizer's range."""
    imgs = torch.from_numpy(_pixels(seeded, 3, 517, 389, mode)).to(dev)
    qt = QuantizationTables(q)
    args = (qt.luminance_table, qt.chrominance_table, mode)
    got = kernels.coeffs(imgs, *args)
    assert got.device.type == "cuda" and got.dtype == torch.int16
    assert torch.equal(got, kernels.coeffs_plain(imgs, *args))
    assert torch.equal(got.cpu(), kernels.coeffs(imgs.cpu(), *args))


def test_coeffs_kernel_rgba_input(dev, seeded):
    rgba = torch.from_numpy(seeded.integers(0, 256, (2, 33, 47, 4), dtype=np.uint8)).to(dev)
    qt = QuantizationTables(85)
    args = (qt.luminance_table, qt.chrominance_table, "420")
    assert torch.equal(kernels.coeffs(rgba, *args), kernels.coeffs_plain(rgba, *args))


EDGE_LABELS = [label for label, _ in coeff_edge_cases(np.random.default_rng(8))]


@pytest.mark.parametrize("case", range(len(EDGE_LABELS)), ids=EDGE_LABELS)
@pytest.mark.parametrize("mode", MODES)
def test_coeffs_kernel_at_tile_edges(dev, mode, case):
    """Batch 1, 8x8 and 17x23 images, rows whose W*C is no multiple of 16,
    widths that end inside a tile, RGBA, a 3220x1812 image: equal to the
    plain version and, image by image, to the host library."""
    _, batch = coeff_edge_cases(np.random.default_rng(8))[case]
    host = np.ascontiguousarray(batch[..., 0] if mode == "gray" else batch)
    qt = QuantizationTables(85)
    args = (qt.luminance_table, qt.chrominance_table, mode)
    imgs = torch.from_numpy(host).to(dev)
    got = kernels.coeffs(imgs, *args)
    assert torch.equal(got, kernels.coeffs_plain(imgs, *args))
    for i in range(len(host)):
        rgb = host[i] if mode == "gray" else np.ascontiguousarray(host[i, ..., :3])
        np.testing.assert_array_equal(got[i].cpu().numpy(),
                                      native_jpeg_coefficients(rgb, mode, *args[:2]))


def test_coeffs_kernel_at_any_image_offset(dev, seeded):
    """A batch sliced from a larger one: every image's rows start at an odd
    byte, though the batch itself is 16-byte aligned."""
    flat = seeded.integers(0, 256, 3 * 21 * 37 * 3 + 16, dtype=np.uint8)
    imgs = torch.from_numpy(flat).to(dev)[16:].view(3, 21, 37, 3)
    qt = QuantizationTables(85)
    for mode in ("444", "420", "422"):
        args = (qt.luminance_table, qt.chrominance_table, mode)
        assert torch.equal(kernels.coeffs(imgs, *args), kernels.coeffs_plain(imgs, *args))


@pytest.mark.parametrize("b,n", [(3, 101), (70, 1), (1, 64)])
@pytest.mark.parametrize("cap", sparse_pack.PADDED_CAP_TIERS)
def test_compact_kernel_edge_counts(dev, cap, b, n):
    """Blocks with 0, cap, cap + 1 and 63 nonzeros; thread blocks that span
    several images (n = 1); a second call leaves the first's outputs alone."""
    zz = torch.from_numpy(compact_edge_batch(np.random.default_rng(9), b, n)).to(dev)
    first = kernels.compact_padded(zz, cap)
    kernels.compact_padded(torch.flip(zz, [1]).contiguous(), cap)
    for got, ref in zip(first, sparse_pack.sparsify_blocks_padded_batch(zz, cap)):
        assert torch.equal(got, ref)


def test_dct_kernel_bit_exact(dev, seeded):
    blocks = torch.from_numpy(seeded.uniform(-128, 127, (20_000, 8, 8)).astype(np.float32))
    got = kernels.dct8x8_aan(blocks.to(dev)).cpu()
    assert torch.equal(got.view(torch.int32), dct.dct8x8_aan(blocks).view(torch.int32))


AAN_IDS = [f"{n} blocks" for n in (*AAN_COUNTS, 100_000)] + ["at a 16-byte offset"]  # aan_cases' order


@pytest.mark.parametrize("case", range(len(AAN_IDS)), ids=AAN_IDS)
def test_dct_kernel_at_tail_sizes_and_offsets(dev, case):
    """Groups of 32 blocks cut short (1, 3, 4, 5, 127, 129 blocks), 100,000
    blocks and a tensor 16 bytes into its buffer, bit for bit."""
    _, blocks = aan_cases(dev, 100_000)[case]
    kernels.dct8x8_aan.launches = 0
    got = kernels.dct8x8_aan(blocks)
    assert kernels.dct8x8_aan.launches == 1
    assert torch.equal(got.cpu().view(torch.int32), dct.dct8x8_aan(blocks.cpu()).view(torch.int32))


@pytest.mark.parametrize("cap", sparse_pack.PADDED_CAP_TIERS)
def test_compact_kernel_equals_plain(dev, seeded, cap):
    zz = np.zeros((4, 3000, 64), np.int16)
    zz[..., 0] = seeded.integers(-2000, 2000, (4, 3000))
    density = seeded.integers(0, 64, (4, 3000, 1)) / 63.0
    mask = seeded.random((4, 3000, 63)) < density
    zz[..., 1:] = np.where(mask, seeded.integers(-1023, 1024, (4, 3000, 63)), 0)
    zz_dev = torch.from_numpy(zz).to(dev)
    for got, ref in zip(kernels.compact_padded(zz_dev, cap),
                        sparse_pack.sparsify_blocks_padded_batch(zz_dev, cap)):
        assert torch.equal(got, ref)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    qt = QuantizationTables(85)
    strided = torch.zeros((1, 16, 32, 3), dtype=torch.uint8, device=dev)[:, :, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        kernels.coeffs(strided, qt.luminance_table, qt.chrominance_table, "444")
    misaligned = torch.zeros(1 + 2 * 64, dtype=torch.int16, device=dev)[1:].view(1, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        kernels.compact_padded(misaligned, 8)
    with pytest.raises(ValueError, match="empty"):
        kernels.dct8x8_aan(torch.zeros((0, 8, 8), device=dev))
    with pytest.raises(ValueError, match="channels"):
        kernels.coeffs(torch.zeros((1, 8, 8, 17), dtype=torch.uint8, device=dev),
                       qt.luminance_table, qt.chrominance_table, "420")


def test_main_path_launches_both_kernels_and_matches_cpu(dev, seeded):
    base = np.add.outer(np.arange(64) * 4, np.arange(64) * 4)[..., None]
    imgs = np.concatenate([
        (base + seeded.normal(0, s, (2, 64, 64, 3))).clip(0, 255).astype(np.uint8)
        for s in (1, 4, 12)
    ])
    imgs = np.concatenate([imgs, seeded.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)])
    for q in (85, 98):
        opts = JpegOptions(width=64, height=64, quality=q, subsampling=Subsampling.S420)
        kernels.coeffs.launches = kernels.compact_padded.launches = 0
        outs = encode_jpeg_batch_sharded(imgs, opts, device=dev)
        assert kernels.coeffs.launches == 1 and kernels.compact_padded.launches >= 1
        assert outs == encode_jpeg_batch_sharded(imgs, opts, device="cpu")


def _count_equal(zz, pattern, ri):
    """The count kernel on ``zz`` equals its plain version on the card and,
    image by image, the host library's count."""
    got = kernels.count_symbols(zz, pattern, ri)
    for g, r in zip(got, huffman_device.count_symbols_plain(zz, pattern, ri)):
        assert g.device == zz.device and g.dtype == torch.int64
        assert torch.equal(g, r)
    dc, ac = (t.cpu().numpy() for t in got)
    host = zz.cpu().numpy()
    for i in range(host.shape[0]):
        ref = native_count_symbols(host[i], pattern, ri)
        assert all(np.array_equal(a, b) for a, b in zip((dc[i, 0], dc[i, 1], ac[i, 0], ac[i, 1]), ref))


@pytest.mark.parametrize("share", [None, 1, 7, 61])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("ri", [None, 1, 2, 7])
@pytest.mark.parametrize("mode", list(COUNT_PATTERNS))
def test_count_kernel_edge_blocks(dev, mode, ri, offset, share):
    """The CPU tests' edge blocks at batch 1 and 64, at byte offsets 0 and
    2 (the kernel's single-load path), under the wrapper's plan and under
    shares of 1, 7 and 61 blocks that start inside MCUs, restart segments
    and images."""
    rng = np.random.default_rng(21)
    edge = np.stack([count_edge_blocks(rng) for _ in range(64)])
    with count_shares(kernels, share):
        for zz in (edge[:1], edge):
            _count_equal(at_offset(zz, offset, dev), COUNT_PATTERNS[mode], ri)


@pytest.mark.parametrize("share", [None, 7])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_count_kernel_on_coefficients(dev, seeded, mode, offset, share):
    """Coefficients of noise and of smooth images from the coefficient
    kernel: 3 images of 517x389 (the wrapper's shares cross images), 3 of
    8x8 and 40x56 (passes end inside a share), one 8x8 image (one block in
    gray), at byte offsets 0 and 2, under the wrapper's plan and shares of
    7 blocks."""
    qt = QuantizationTables(90)
    for b, h, w in ((3, 517, 389), (3, 8, 8), (3, 40, 56), (1, 8, 8)):
        imgs = torch.from_numpy(_pixels(seeded, b, h, w, mode)).to(dev)
        zz = at_offset(kernels.coeffs(imgs, qt.luminance_table, qt.chrominance_table, mode).cpu().numpy(),
                       offset, dev)
        with count_shares(kernels, share):
            _count_equal(zz, COUNT_PATTERNS[mode], None)
            _count_equal(zz, COUNT_PATTERNS[mode], 3)


def test_count_kernel_refuses_what_it_does_not_take(dev):
    zz = torch.zeros((1, 6, 64), dtype=torch.int16, device=dev)
    with pytest.raises(ValueError):
        kernels.count_symbols(zz, COUNT_PATTERNS["420"], 0)
    with pytest.raises(ValueError):
        kernels.count_symbols(zz[:, :5], COUNT_PATTERNS["420"])
    with pytest.raises(ValueError, match="contiguous"):
        kernels.count_symbols(torch.zeros((1, 6, 128), dtype=torch.int16, device=dev)[..., ::2], (0,))


def test_count_kernel_takes_batches_past_65535_images(dev):
    """65,536 and 65,537 images of one and of six blocks in one launch each
    (the grid is 1-D), equal to the plain version and the host library."""
    rng = np.random.default_rng(3)
    for b, pattern in ((65536, (0,)), (65537, COUNT_PATTERNS["420"])):
        zz = np.zeros((b, len(pattern), 64), np.int16)
        zz[..., 0] = rng.integers(-1024, 1024, zz.shape[:2])
        zz[..., 1:] = rng.integers(-3, 4, (b, len(pattern), 63)) * (rng.random((b, len(pattern), 63)) < 0.1)
        kernels.count_symbols.launches = 0
        got = kernels.count_symbols(torch.from_numpy(zz).to(dev), pattern)
        assert kernels.count_symbols.launches == 1
        ref = huffman_device.count_symbols_plain(torch.from_numpy(zz), pattern)
        assert all(torch.equal(g.cpu(), r) for g, r in zip(got, ref))
        for i in (0, 65535, b - 1):
            want = native_count_symbols(zz[i], pattern, None)
            assert all(np.array_equal(a, w) for a, w in zip(
                (got[0][i, 0].cpu().numpy(), got[0][i, 1].cpu().numpy(), got[1][i, 0].cpu().numpy(),
                 got[1][i, 1].cpu().numpy()), want))


def test_compact_kernel_in_groups(dev, monkeypatch):
    """With the group patched to 16 images, a batch of 70 takes five
    launches into slices of one set of outputs, equal to the plain version."""
    monkeypatch.setattr(kernels, "COMPACT_MAX_BATCH", 16)
    zz = torch.from_numpy(compact_edge_batch(np.random.default_rng(9), 70, 3)).to(dev)
    for cap in sparse_pack.PADDED_CAP_TIERS:
        kernels.compact_padded.launches = 0
        got = kernels.compact_padded(zz, cap)
        assert kernels.compact_padded.launches == 5
        for g, r in zip(got, sparse_pack.sparsify_blocks_padded_batch(zz, cap)):
            assert torch.equal(g, r)


@pytest.mark.parametrize("route", ["standard", "balanced"])
def test_jpeg_batch_past_65535_images(dev, route):
    """65,537 images of 8x8 through ``encode_jpeg_batch_sharded`` on the
    card: the count in one launch, the compaction in two groups, every file
    equal to ``device="cpu"``'s."""
    imgs = np.random.default_rng(65537).integers(0, 256, (65537, 8, 8, 3), dtype=np.uint8)
    opts = JpegOptions(width=8, height=8, quality=85, subsampling=Subsampling.S420)
    if route == "balanced":
        opts = opts.replace(optimize_huffman=True)
    kernels.count_symbols.launches = kernels.compact_padded.launches = 0
    got = encode_jpeg_batch_sharded(imgs, opts, device=dev)
    assert kernels.count_symbols.launches == (route == "balanced")
    assert kernels.compact_padded.launches >= 2
    assert got == encode_jpeg_batch_sharded(imgs, opts, device="cpu")


JPEG_ROUTES = {
    "balanced": dict(optimize_huffman=True),
    "optimal": dict(optimal_huffman=True),
    "progressive_sa": dict(progressive=True),
    "progressive_no_sa": dict(progressive=True, progressive_sa=False),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", list(JPEG_ROUTES))
def test_jpeg_routes_on_the_card_equal_the_host_tier(dev, seeded, route, mode):
    """The optimized, optimal and progressive batch routes on the card emit
    each file of the host tier (``jpeg.encode(..., device="cpu")``), with
    one coefficient launch and, on the optimized routes, one count launch;
    ``jpeg.encode`` on the card is a batch of one."""
    base = np.add.outer(np.arange(40) * 3, np.arange(56) * 2)[..., None]
    imgs = (base + seeded.normal(0, 10, (3, 40, 56, 3))).clip(0, 255).astype(np.uint8)
    if mode == "gray":
        imgs = np.ascontiguousarray(imgs[..., 0])
    opts = JpegOptions(width=56, height=40, quality=85, restart_interval=2,
                       color_type=ColorType.GRAY if mode == "gray" else ColorType.RGB,
                       subsampling=Subsampling("444" if mode == "gray" else mode), **JPEG_ROUTES[route])
    kernels.coeffs.launches = kernels.count_symbols.launches = 0
    outs = encode_jpeg_batch_sharded(imgs, opts, device=dev)
    assert kernels.coeffs.launches == 1
    assert kernels.count_symbols.launches == (0 if opts.progressive else 1)
    assert outs == [jpeg.encode(img, opts, device="cpu") for img in imgs]
    assert jpeg.encode(imgs[0], opts) == outs[0]
    assert jpeg.encode_batch(imgs, opts) == outs


@pytest.mark.parametrize("quality", [75, 90, 98])
def test_balanced_route_escalates_on_the_card(dev, seeded, quality):
    """Noise that escalates the compaction cap and that falls back to the
    dense stream, under the balanced preset."""
    base = np.add.outer(np.arange(64) * 4, np.arange(64) * 4)[..., None]
    imgs = np.concatenate([(base + seeded.normal(0, s, (2, 64, 64, 3))).clip(0, 255).astype(np.uint8)
                           for s in (4, 8)] + [seeded.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)])
    opts = JpegOptions.from_preset(64, 64, quality, 1).replace(subsampling=Subsampling.S420)
    assert encode_jpeg_batch_sharded(imgs, opts, device=dev) == \
        [jpeg.encode(img, opts, device="cpu") for img in imgs]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.int32)


@pytest.mark.parametrize("case", range(len(EDGE_LABELS)), ids=EDGE_LABELS)
@pytest.mark.parametrize("mode", MODES)
def test_dct_zz_kernel_equals_plain_and_host_library(dev, mode, case):
    """The coefficient kernel's f32 variant at the tile edges, bit for bit
    against its plain version and, image by image, the host library."""
    _, batch = coeff_edge_cases(np.random.default_rng(8))[case]
    host = np.ascontiguousarray(batch[..., 0] if mode == "gray" else batch)
    imgs = torch.from_numpy(host).to(dev)
    kernels.dct_zz.launches = 0
    got = kernels.dct_zz(imgs, mode)
    assert kernels.dct_zz.launches == 1 and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), kernels.dct_zz_plain(imgs, mode).view(torch.int32))
    for i in range(len(host)):
        rgb = host[i] if mode == "gray" else np.ascontiguousarray(host[i, ..., :3])
        np.testing.assert_array_equal(_bits(got[i]), native_jpeg_dct_zz(rgb, mode).view(np.int32))


@pytest.mark.parametrize("mode", MODES)
def test_dct_zz_kernel_at_odd_sizes_and_offsets(dev, seeded, mode):
    """Odd sizes (the clamp padding) and a batch whose rows start at odd bytes."""
    imgs = torch.from_numpy(_pixels(seeded, 3, 517, 389, mode)).to(dev)
    assert torch.equal(kernels.dct_zz(imgs, mode).view(torch.int32),
                       kernels.dct_zz_plain(imgs, mode).view(torch.int32))
    if mode != "gray":
        flat = seeded.integers(0, 256, 3 * 21 * 37 * 3 + 16, dtype=np.uint8)
        sliced = torch.from_numpy(flat).to(dev)[16:].view(3, 21, 37, 3)
        assert torch.equal(kernels.dct_zz(sliced, mode).view(torch.int32),
                           kernels.dct_zz_plain(sliced, mode).view(torch.int32))


def test_dct_zz_kernel_holds_its_plans_ctas(dev):
    """At its mode's usual channels (gray 1, colour 3) every mode's dct_zz
    kernel fits at least the CTAs an SM that its plan sizes the grid by (its
    __launch_bounds__), so its shares all run at once; with more channels
    the grid takes the CTAs that fit."""
    for mode in MODES:
        plan = kernels.dct_zz_plan_ctas(mode)
        for c in (1,) if mode == "gray" else (3, 4):
            per_sm = kernels.coeffs_ctas_per_sm(mode, c, True)
            assert c == 4 or per_sm >= plan, (mode, c, per_sm)
            assert kernels.dct_zz_slots(dev, mode, c) == kernels._sm_count(dev) * min(per_sm, plan)


@pytest.mark.parametrize("kind", ["below the slots", "twice the slots", "one tile past the slots"])
@pytest.mark.parametrize("mode", MODES)
def test_dct_zz_kernel_at_the_cards_tile_counts(dev, mode, kind):
    """Tile counts below the card's CTA slots, on a multiple of them and one
    tile past, against the plain version and the host library."""
    slots = kernels.dct_zz_slots(dev, mode, 1 if mode == "gray" else 3)
    (label, _, batch), = [c for c in dct_zz_tile_cases({mode: slots}) if c[0].startswith(kind)]
    imgs = torch.from_numpy(batch).to(dev)
    got = kernels.dct_zz(imgs, mode)
    assert torch.equal(got.view(torch.int32), kernels.dct_zz_plain(imgs, mode).view(torch.int32)), label
    for i in range(len(batch)):
        rgb = batch[i] if mode == "gray" else np.ascontiguousarray(batch[i, ..., :3])
        np.testing.assert_array_equal(_bits(got[i]), native_jpeg_dct_zz(rgb, mode).view(np.int32))


TRELLIS_LABELS = [c[0] for c in trellis_edge_blocks(np.random.default_rng(5))]


def _trellis_equal(dct, lum, chrom, pattern):
    """The trellis kernel on ``dct`` equals its plain version on the card and
    the host library's DP."""
    kernels.trellis_quantize.launches = 0
    got = kernels.trellis_quantize(dct, lum, chrom, pattern)
    assert kernels.trellis_quantize.launches == 1 and got.dtype == torch.int16
    assert torch.equal(got, trellis_device.trellis_quantize_batch_plain(dct, lum, chrom, pattern))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  native_trellis_quantize(dct.cpu().numpy(), pattern, lum, chrom))


@pytest.mark.parametrize("case", range(len(TRELLIS_LABELS)), ids=TRELLIS_LABELS)
def test_trellis_kernel_at_ties_and_boundaries(dev, case):
    _, dct, lum, chrom, pattern = trellis_edge_blocks(np.random.default_rng(5))[case]
    _trellis_equal(torch.from_numpy(dct).to(dev), lum, chrom, pattern)


@pytest.mark.parametrize("n", [1, 127, 129, 70_000])
@pytest.mark.parametrize("pname", list(TRELLIS_PATTERNS))
def test_trellis_kernel_on_random_blocks(dev, pname, n):
    """Thread blocks that end inside the batch, a batch not a multiple of
    the pattern, and 70,000 blocks (past 65,535)."""
    rng = np.random.default_rng(n)
    lum, chrom = (rng.integers(1, 80, 64).astype(np.float32) for _ in range(2))
    _trellis_equal(torch.from_numpy(trellis_random_blocks(rng, n)).to(dev), lum, chrom,
                   TRELLIS_PATTERNS[pname])


@pytest.mark.parametrize("n", [1, 129, 4099])
def test_trellis_kernel_on_mixed_warps(dev, n):
    """Warps that mix ZRL steps, steps with no nonzero candidate (exact
    zeros: the whole warp passes its states through where every lane has
    one), dense and ordinary steps and blocks that take the all-zero exit
    (the CTA packs the others onto its first threads): one block, a CTA and
    one past it, and 4099 blocks, in part in warps of one kind."""
    dct, lum, chrom, pattern = trellis_mixed_blocks(np.random.default_rng(n), n)
    _trellis_equal(torch.from_numpy(dct).to(dev), lum, chrom, pattern)


def test_trellis_kernel_occupancy(dev):
    """The kernel's CTAs an SM: at least 5 (20 warps). The launch sizes its
    grid to the card's CTA slots, so a batch of up to 84,480 blocks is one
    wave with every SM holding as many CTAs."""
    assert kernels.load().pixo_trellis_ctas_per_sm() >= 5


@pytest.mark.parametrize("mode", MODES)
def test_trellis_kernel_on_real_dct(dev, seeded, mode):
    """The DCT of noisy gradients from the dct_zz kernel, at q 30 and 90."""
    base = np.add.outer(np.arange(96) * 2, np.arange(120) * 2)[..., None]
    imgs = (base + seeded.normal(0, 12, (4, 96, 120, 3))).clip(0, 255).astype(np.uint8)
    host = np.ascontiguousarray(imgs[..., 0]) if mode == "gray" else imgs
    dct = kernels.dct_zz(torch.from_numpy(host).to(dev), mode).reshape(-1, 64)
    pattern = TRELLIS_PATTERNS[mode]
    for q in (30, 90):
        qt = QuantizationTables(q)
        _trellis_equal(dct, qt.luminance_table[ZIGZAG], qt.chrominance_table[ZIGZAG], pattern)


def test_trellis_kernel_refuses_what_it_does_not_take(dev):
    q = np.ones(64, np.float32)
    with pytest.raises(ValueError, match="empty"):
        kernels.trellis_quantize(torch.zeros((0, 64), device=dev), q, q, (0,))
    with pytest.raises(ValueError, match="aligned"):
        kernels.trellis_quantize(torch.zeros(65 * 64, device=dev)[1:1 + 64 * 64].view(64, 64), q, q, (0,))
    with pytest.raises(TypeError):
        kernels.trellis_quantize(torch.zeros((4, 64), dtype=torch.float16, device=dev), q, q, (0,))


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("case", ["max 4:2:0", "max gray restart 2", "max 4:2:2 no SA"])
def test_max_preset_on_the_card_equals_the_cpu(dev, seeded, case, b):
    """The max preset on the card emits the files of ``device="cpu"``, from
    a batch of one (180 blocks or fewer) up: it launches ``dct_zz`` once and
    ``trellis_quantize`` once, and no ``coeffs``."""
    kw = {"max 4:2:0": {}, "max gray restart 2": dict(color_type=ColorType.GRAY, restart_interval=2),
          "max 4:2:2 no SA": dict(subsampling=Subsampling.S422, progressive_sa=False)}[case]
    opts = JpegOptions.max(120, 96, 85).replace(**kw)
    base = np.add.outer(np.arange(96) * 2, np.arange(120) * 2)[..., None]
    imgs = (base + seeded.normal(0, 12, (b, 96, 120, 3))).clip(0, 255).astype(np.uint8)
    if opts.color_type == ColorType.GRAY:
        imgs = np.ascontiguousarray(imgs[..., 0])
    for k in (kernels.coeffs, kernels.dct_zz, kernels.trellis_quantize):
        k.launches = 0
    outs = encode_jpeg_batch_sharded(imgs, opts, device=dev)
    launches = (kernels.coeffs.launches, kernels.dct_zz.launches, kernels.trellis_quantize.launches)
    assert launches == (0, 1, 1)
    assert outs == jpeg.encode_batch(imgs, opts, device="cpu")
    assert jpeg.encode(imgs[0], opts) == outs[0]


FILTER_BPPS = [1, 2, 3, 4, 6, 8]
STRATEGIES = list(FilterStrategy)


@pytest.mark.parametrize("bpp", FILTER_BPPS)
def test_filter_bank_kernel_equals_plain(dev, seeded, bpp):
    """Odd RB, H = 1, RB = bpp, RB < bpp and a 262,140-byte row."""
    for h, rb in ((1, 37), (17, 301), (5, bpp), (3, max(bpp // 2, 1)), (2, 262140)):
        rows = torch.from_numpy(seeded.integers(0, 256, (2, h, rb), dtype=np.uint8)).to(dev)
        cands, scores = kernels.filter_bank(rows, bpp)
        plain_cands, plain_scores = kernels.filter_bank_plain(rows, bpp)
        assert torch.equal(cands, plain_cands) and torch.equal(scores, plain_scores)


@pytest.mark.parametrize("sticky", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES, ids=lambda s: s.value)
def test_filter_rows_kernel_equals_plain_and_host(dev, seeded, strategy, sticky):
    for bpp in FILTER_BPPS:
        for h, w in ((20, 97), (1, 5), (3, 65535 if bpp == 4 else 9)):
            host = seeded.integers(0, 24 if h == 20 else 256, (2, h, w * bpp), dtype=np.uint8)
            rows = torch.from_numpy(host).to(dev)
            kw = dict(bpp=bpp, strategy=strategy, small_image=False, sticky_fast=sticky)
            out = kernels.filter_rows(rows, **kw)
            assert torch.equal(out, png_filters.filter_rows_plain(rows, **kw))
            mode = png_filters.native_mode(strategy)
            for i in range(2):
                np.testing.assert_array_equal(
                    out[i].cpu().numpy(), native_png_filter(host[i], bpp, mode, sticky and mode == 6))


def test_filter_kernels_take_rows_at_any_offset(dev, seeded):
    """A batch sliced from a larger one starts at any byte."""
    flat = torch.from_numpy(seeded.integers(0, 256, 1 + 2 * 7 * 21, dtype=np.uint8)).to(dev)
    rows = flat[1:].view(2, 7, 21)
    assert rows.data_ptr() % 16
    got, ref = kernels.filter_bank(rows, 3), kernels.filter_bank_plain(rows, 3)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    kw = dict(bpp=3, strategy=FilterStrategy.PAETH, small_image=False, sticky_fast=False)
    assert torch.equal(kernels.filter_rows(rows, **kw), png_filters.filter_rows_plain(rows, **kw))


@pytest.mark.parametrize("bpp", range(1, 9))
def test_filter_kernels_at_strip_and_row_edges(dev, bpp):
    """``filter_edge_cases``: rows of 1, bpp - 1, bpp, 15, 16 and 17 bytes,
    heights around a strip and the sticky limit, tied rows, rows at the
    shared-memory budget (strip kernel and long-row kernel), every strategy,
    the sticky rule off and on, rows at an odd byte offset; and
    ``bigram_edge_cases`` (Bigrams' ties, rows of 1 and 2 bytes, rows at
    mode 7's budget): both kernels against their plain versions and the
    fused one against the host filter."""
    rng = np.random.default_rng(40 + bpp)
    for label, host in filter_edge_cases(rng, bpp) + bigram_edge_cases(rng, bpp):
        flat = torch.empty(host.size + 1, dtype=torch.uint8, device=dev)
        rows = flat[1:].view(host.shape).copy_(torch.from_numpy(host))
        cands, scores = kernels.filter_bank(rows, bpp)
        plain_cands, plain_scores = kernels.filter_bank_plain(rows, bpp)
        assert torch.equal(cands, plain_cands) and torch.equal(scores, plain_scores), label
        for strategy in STRATEGIES:
            mode = png_filters.native_mode(strategy)
            for sticky in (False, True):
                kw = dict(bpp=bpp, strategy=strategy, small_image=False, sticky_fast=sticky)
                out = kernels.filter_rows(rows, **kw)
                assert torch.equal(out, png_filters.filter_rows_plain(rows, **kw)), (label, strategy)
                for i in range(len(host)):
                    np.testing.assert_array_equal(
                        out[i].cpu().numpy(),
                        native_png_filter(host[i], bpp, mode, sticky and mode == 6))


def test_filter_rows_launches_the_kernel_its_plan_names(dev, seeded):
    """Rows just under and just over the strip kernel's budget give equal
    results through either kernel (the C function takes the plan)."""
    h = kernels.FILTER_STRIP_ROWS + 1
    fits = max(rb for rb in range(1, 1 << 17) if kernels.filter_rows_plan(h, rb, False))
    assert kernels.filter_rows_plan(h, fits + 1, False) == 0
    for rb in (fits, fits + 1):
        rows = torch.from_numpy(seeded.integers(0, 7, (1, h, rb), dtype=np.uint8)).to(dev)
        for strategy in (FilterStrategy.ADAPTIVE, FilterStrategy.ADAPTIVE_FAST):
            kw = dict(bpp=4, strategy=strategy, small_image=False, sticky_fast=False)
            assert torch.equal(kernels.filter_rows(rows, **kw),
                               png_filters.filter_rows_plain(rows, **kw))


def test_png_max_batch_on_the_card_equals_per_image_encode(dev, seeded):
    """The max preset (Bigrams in filter_rows' mode 7, optimal DEFLATE on
    the host) on RGB and RGBA batches: every file equals ``png.encode``,
    through one mode-7 launch a group, and so does the row-sharded encode."""
    h, w = 72, 90
    base = np.add.outer(np.arange(h), np.arange(w))[..., None] % 256
    for c, ct in ((3, ColorType.RGB), (4, ColorType.RGBA)):
        imgs = (base + seeded.integers(0, 40, (3, h, w, c))).astype(np.uint8)
        opts = PngOptions.max(w, h).replace(color_type=ct)
        kernels.filter_rows.launches = 0
        outs = encode_png_batch_sharded(imgs, opts, device=dev)
        assert kernels.filter_rows.launches >= 1
        assert outs == [png.encode(img, opts) for img in imgs]
        assert encode_png_row_sharded(imgs[0], opts, device=dev) == outs[0]


def test_png_batch_on_the_card_equals_per_image_encode(dev):
    rng = np.random.default_rng(7)
    h, w = 64, 80
    g = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    noisy = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    noisy[::7, ::3, 3] = 0
    opaque = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    opaque[..., 3] = 255
    gray_alpha = np.concatenate([g, g, g, rng.integers(0, 255, (h, w, 1), dtype=np.uint8)], -1)
    gray = np.concatenate([g, g, g, np.full((h, w, 1), 255, np.uint8)], -1)
    palette = np.zeros((h, w, 4), np.uint8)
    palette[..., 0] = np.arange(w) % 7 * 30
    palette[..., 3] = 255
    imgs = np.stack([noisy, opaque, gray_alpha, gray, palette])
    opts = PngOptions.balanced(w, h)
    kernels.filter_rows.launches = 0
    outs = encode_png_batch_sharded(imgs, opts, device=dev)
    assert kernels.filter_rows.launches == 3  # the pass, strip and ga groups
    assert outs == [png.encode(img, opts) for img in imgs]
    assert outs == encode_png_batch_sharded(torch.from_numpy(imgs).to(dev), opts, device=dev)


I16 = np.array([-32768, -32767, -1024, -1, 0, 1, 1023, 32766, 32767], np.int16)


def _blocks(rng, n, kind):
    if kind == "extreme":  # int16 extremes: int32 wraps once dequantized
        return rng.choice(I16, (n, 64))
    zz = np.zeros((n, 64), np.int16)
    zz[:, 0] = rng.integers(-1024, 1024, n)
    zz[:, 1:] = np.where(rng.random((n, 63)) < 0.3, rng.integers(-200, 201, (n, 63)), 0)
    return zz


@pytest.mark.parametrize("kind", ["conforming", "extreme"])
def test_idct_planes_kernel_equals_plain(dev, seeded, kind):
    """Many planes of odd block grids, a gap of blocks between two, a pitch
    wider than its row, tables of 255 and 65535."""
    dims = [(int(seeded.integers(1, 40)), int(seeded.integers(1, 30))) for _ in range(60)]
    planes, first, off = [], 0, 0
    for k, (bw, bh) in enumerate(dims):
        pitch = 8 * bw + (16 if k % 7 == 3 else 0)
        planes.append((first, bw, bh, off, pitch))
        first += bw * bh + (5 if k % 11 == 4 else 0)
        off += 8 * bh * pitch
    planes = np.asarray(planes, np.int64)
    zz = torch.from_numpy(_blocks(seeded, first, kind)).to(dev)
    q = np.stack([np.full(64, (255, 65535, 1)[k % 3], np.uint16) for k in range(len(planes))])
    kernels.idct_planes.launches = 0
    got = kernels.idct_planes(zz, q, planes)
    assert kernels.idct_planes.launches == 1 and got.device.type == "cuda"
    assert torch.equal(got, kernels.idct_planes_plain(zz, q, planes))
    assert torch.equal(got.cpu(), kernels.idct_planes(zz.cpu(), q, planes))


def test_idct_planes_kernel_at_plane_edges(dev):
    """``plane_edge_case``: three planes in one thread block's range, a plane
    of one block, gaps, wide pitches, blocks outside every plane, a block
    count that is no multiple of a thread block's, int16 extremes."""
    zz, q, planes = plane_edge_case(np.random.default_rng(15))
    coeffs = torch.from_numpy(zz).to(dev)
    got = kernels.idct_planes(coeffs, q, planes)
    assert torch.equal(got, kernels.idct_planes_plain(coeffs, q, planes))
    assert torch.equal(got.cpu(), kernels.idct_planes(coeffs.cpu(), q, planes))
    table = kernels.PlaneTable(planes, len(zz), q)
    desc = kernels.upload_pinned(table.packed, dev)
    kernels.idct_planes.launches = 0
    assert torch.equal(kernels.idct_planes_table(coeffs, table, desc), got)
    assert torch.equal(kernels.idct_planes_table(coeffs, table), got)
    assert kernels.idct_planes.launches == 2
    with pytest.raises(ValueError, match="packed plane table"):
        kernels.idct_planes_table(coeffs, table, desc[:-1])


def test_idct_planes_kernel_with_many_tiny_planes(dev, seeded):
    """Planes of one to three blocks: a thread block spans dozens of them,
    more than it keeps descriptors for in shared memory."""
    dims = [(int(seeded.integers(1, 4)), 1) for _ in range(300)]
    planes, first, off = [], 3, 0
    for bw, bh in dims:
        planes.append((first, bw, bh, off, 8 * bw))
        first += bw * bh
        off += 64 * bw * bh
    planes = np.asarray(planes, np.int64)
    zz = torch.from_numpy(_blocks(seeded, first + 2, "extreme")).to(dev)
    q = seeded.integers(1, 65536, (len(planes), 64))
    assert torch.equal(kernels.idct_planes(zz, q, planes), kernels.idct_planes_plain(zz, q, planes))


def test_decode_stages_coefficients_and_table_in_one_pinned_copy(dev):
    files = _decode_batch_files()
    batch = jpeg_decoder._host_stage(files, 4, pinned=True)
    assert batch.staging.is_pinned() and batch.coeffs.base is not None
    coeffs, desc = batch.to_device(dev)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(coeffs.cpu().numpy(), batch.coeffs)
    np.testing.assert_array_equal(desc.cpu().numpy(), batch.layout.table.packed)
    plain = jpeg_decoder._host_stage(files, 4)
    assert plain.staging is None
    np.testing.assert_array_equal(plain.coeffs, batch.coeffs)
    assert torch.equal(kernels.idct_planes_table(coeffs, batch.layout.table, desc),
                       kernels.idct_planes(coeffs, plain.qtables, plain.layout.planes))


@pytest.mark.parametrize("kind", ["conforming", "extreme", "int32"])
def test_idct8x8_int_kernel_equals_plain(dev, seeded, kind):
    if kind == "int32":
        natural = seeded.integers(-2**31, 2**31, (20_000, 8, 8)).astype(np.int32)
    else:
        deq = _blocks(seeded, 20_000, kind).astype(np.int32) * 65535
        natural = np.ascontiguousarray(deq.reshape(-1, 8, 8))
    blocks = torch.from_numpy(natural).to(dev)
    got = kernels.idct8x8_int(blocks)
    assert torch.equal(got, jpeg_decode.idct8x8_int(blocks))
    assert torch.equal(got.cpu(), jpeg_decode.idct8x8_int(blocks.cpu()))


def test_idct_wrappers_refuse_what_the_kernels_do_not_take(dev):
    planes = np.asarray([[0, 1, 1, 0, 8]])
    q = np.ones((1, 64))
    misaligned = torch.zeros(1 + 64, dtype=torch.int16, device=dev)[1:].view(1, 64)
    with pytest.raises(ValueError, match="aligned"):
        kernels.idct_planes(misaligned, q, planes)
    with pytest.raises(ValueError, match="empty"):
        kernels.idct_planes(torch.zeros((0, 64), dtype=torch.int16, device=dev), q, planes)
    with pytest.raises(ValueError, match="empty"):
        kernels.idct8x8_int(torch.zeros((0, 8, 8), dtype=torch.int32, device=dev))


def _decode_batch_files():
    rng = np.random.default_rng(9)
    files = []
    for sub, gray, (h, w), restart in (
        (Subsampling.S420, False, (61, 47), None), (Subsampling.S420, False, (61, 47), 2),
        (Subsampling.S444, True, (37, 29), None), (Subsampling.S444, False, (23, 45), 1),
        (Subsampling.S422, False, (50, 19), 3), (Subsampling.S420, False, (64, 64), None),
    ):
        img = rng.integers(0, 256, (1, h, w) if gray else (1, h, w, 3), dtype=np.uint8)
        opts = JpegOptions(width=w, height=h, quality=85, subsampling=sub, restart_interval=restart,
                           color_type=ColorType.GRAY if gray else ColorType.RGB)
        files.append(encode_jpeg_batch_sharded(img, opts, device="cpu")[0])
    here = os.path.dirname(os.path.abspath(__file__))
    for name in ("web", "playground"):
        with open(os.path.join(here, "fixtures", f"progressive_{name}.jpg"), "rb") as f:
            files.append(f.read())
    return files


@pytest.mark.parametrize("fancy", [False, True], ids=["nearest", "fancy"])
def test_decode_batch_on_the_card_equals_host_decode(dev, fancy):
    """A mixed batch (gray, 4:4:4, 4:2:0, 4:2:2, odd sizes, restarts,
    progressive) decoded on the card in one tail equals the host library's
    two-stage decode and the port's decode on the CPU, image by image."""
    files = _decode_batch_files()
    kernels.idct_planes.launches = 0
    got = decode_jpeg_batch(files, fancy_upsampling=fancy, device=dev)
    assert kernels.idct_planes.launches == 1
    on_cpu = decode_jpeg_batch(files, fancy_upsampling=fancy, device="cpu")
    for img, cpu, data in zip(got, on_cpu, files):
        np.testing.assert_array_equal(img.pixels, host_decode(data, fancy))
        np.testing.assert_array_equal(img.pixels, cpu.pixels)


RESIZE_LABELS = [label for label, *_ in resize_cases(np.random.default_rng(10))]


@pytest.mark.parametrize("case", range(len(RESIZE_LABELS)), ids=RESIZE_LABELS)
def test_resize_kernel_equals_plain_and_host_library(dev, case):
    """The thumbnail chunk, up- and downscales at odd sizes with 1 to 4
    channels, a target of one pixel, sources one pixel wide and high, one
    3220x1812 image, batches of 1 and 64: bit-equal to the plain version, to
    the plain version on the CPU and, image by image, to the host library;
    also from an odd byte offset."""
    _, host, dh, dw = resize_cases(np.random.default_rng(10))[case]
    taps = (*resize_kernels.lanczos_taps(host.shape[2], dw),
            *resize_kernels.lanczos_taps(host.shape[1], dh))
    imgs = torch.from_numpy(host).to(dev)
    before = kernels.resize_lanczos3.launches
    got = kernels.resize_lanczos3(imgs, *taps)
    assert kernels.resize_lanczos3.launches == before + 1
    assert got.device.type == "cuda" and tuple(got.shape) == (host.shape[0], dh, dw, host.shape[3])
    assert torch.equal(got, kernels.resize_lanczos3_plain(imgs, *taps))
    if host.size < 4_000_000:
        assert torch.equal(got.cpu(), kernels.resize_lanczos3(imgs.cpu(), *taps))
    flat = torch.empty(host.size + 3, dtype=torch.uint8, device=dev)
    shifted = flat[3:].view(host.shape).copy_(imgs)
    assert torch.equal(kernels.resize_lanczos3(shifted, *taps), got)
    got_h = got.cpu().numpy()
    for i in range(len(host)):
        np.testing.assert_array_equal(got_h[i], native_resize_lanczos3(host[i], *taps))


RESIZE_ROUTES = [  # (label, [B, H, W, C], dst_h, dst_w, the plan's cols, quads, vertical)
    ("two tiles of 128, the second cut short", (2, 40, 300, 3), 30, 200, 128, 2, "words"),
    ("tiles of 32 columns", (8, 20, 64, 4), 10, 20, 32, 8, "granules"),
    ("tiles of 64 columns, one channel", (3, 30, 100, 1), 15, 50, 64, 4, "bytes"),
    ("one row group a tile", (1, 40, 3220, 3), 20, 128, 128, 1, "granules"),
    ("direct", (2, 3, 16000, 3), 2, 64, 0, 0, "granules"),
    ("upscale, vertical bytes", (2, 37, 51, 3), 100, 77, 128, 2, "bytes"),
]


@pytest.mark.parametrize("case", RESIZE_ROUTES, ids=[r[0] for r in RESIZE_ROUTES])
def test_resize_kernel_takes_each_route_of_its_plan(dev, case):
    """Each route of ``resize_plan`` on a shape that takes it, bit-equal to
    the plain version and to the host library."""
    _, shape, dh, dw, cols, quads, vertical = case
    host = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    px, py = resize_kernels._taps_on(shape[2], dw, dev), resize_kernels._taps_on(shape[1], dh, dev)
    plan = kernels.resize_plan(*shape, dh, dw, px[1].shape[1], py[1].shape[1])
    assert (plan.cols, plan.quads, plan.vertical) == (cols, quads, vertical)
    imgs = torch.from_numpy(host).to(dev)
    got = kernels.resize_lanczos3(imgs, *px, *py)
    assert torch.equal(got, kernels.resize_lanczos3_plain(imgs, *px, *py))
    taps = (*resize_kernels.lanczos_taps(shape[2], dw), *resize_kernels.lanczos_taps(shape[1], dh))
    assert torch.equal(kernels.resize_lanczos3(imgs, *taps), got)  # unpadded host tables
    for i in range(len(host)):
        np.testing.assert_array_equal(got[i].cpu().numpy(), native_resize_lanczos3(host[i], *taps))


@pytest.mark.parametrize("offset", range(1, 16))
def test_resize_kernel_at_any_byte_offset(dev, offset):
    """A group of a decoded batch lies at any byte offset of its buffer:
    every offset of a 16-byte granule, on output rows of two tiles."""
    host = np.random.default_rng(offset).integers(0, 256, (2, 45, 301, 3), dtype=np.uint8)
    taps = (*resize_kernels.lanczos_taps(301, 203), *resize_kernels.lanczos_taps(45, 33))
    flat = torch.empty(host.size + offset, dtype=torch.uint8, device=dev)
    shifted = flat[offset:].view(host.shape).copy_(torch.from_numpy(host))
    got = kernels.resize_lanczos3(shifted, *taps)
    assert torch.equal(got, kernels.resize_lanczos3_plain(torch.from_numpy(host).to(dev), *taps))


def test_resize_kernel_with_starts_out_of_order(dev, seeded):
    """Tables that are not ``lanczos_taps``': starts out of order, below 0
    and past the row, so a tile's span outruns the plan's room and its
    pixels come from global memory; the bytes still equal the plain
    version's, whose indices are clamped alike."""
    host = seeded.integers(0, 256, (3, 24, 90, 3), dtype=np.uint8)
    sx = seeded.integers(-20, 110, 40).astype(np.int32)
    wx = seeded.uniform(-0.3, 0.6, (40, 8)).astype(np.float32)
    sy, wy = resize_kernels.lanczos_taps(24, 11)
    assert sx.max() + 8 - sx.min() > kernels.resize_plan(3, 24, 90, 3, 11, 40, 8, 12).span
    imgs = torch.from_numpy(host).to(dev)
    got = kernels.resize_lanczos3(imgs, sx, wx, sy, wy)
    assert torch.equal(got, kernels.resize_lanczos3_plain(imgs, sx, wx, sy, wy))
    assert torch.equal(got.cpu(), kernels.resize_lanczos3(imgs.cpu(), sx, wx, sy, wy))


def test_resize_kernel_refuses_what_it_does_not_take(dev):
    sx, wx = resize_kernels.lanczos_taps(8, 4)
    five = torch.zeros((1, 8, 8, 5), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="at most 4 channels"):
        kernels.resize_lanczos3(five, sx, wx, sx, wx)
    with pytest.raises(ValueError, match="non-empty"):
        kernels.resize_lanczos3(five[:0], sx, wx, sx, wx)
    assert tuple(kernels.resize_lanczos3(five.cpu(), sx, wx, sx, wx).shape) == (1, 4, 4, 5)


@pytest.mark.parametrize("f", list(ResizeFilter), ids=[f.name for f in ResizeFilter])
def test_public_resize_on_the_card_equals_the_cpu(dev, seeded, f):
    for (sh, sw, dh, dw), ct in (((37, 51, 100, 77), ColorType.RGB), ((64, 48, 20, 9), ColorType.RGBA),
                                 ((40, 40, 13, 13), ColorType.GRAY)):
        img = seeded.integers(0, 256, (sh, sw, ct.bytes_per_pixel), dtype=np.uint8)
        opts = ResizeOptions(src_width=sw, src_height=sh, dst_width=dw, dst_height=dh,
                             color_type=ct, filter=f)
        np.testing.assert_array_equal(resize(img, opts, device=dev), resize(img, opts, device="cpu"))


def _thumbnail_inputs():
    rng = np.random.default_rng(31)
    files = _decode_batch_files()
    rgba = rng.integers(0, 256, (33, 50, 4), dtype=np.uint8)
    files.insert(2, png.encode(rgba, PngOptions.fast(50, 33).replace(color_type=ColorType.RGBA)))
    gray = rng.integers(0, 256, (50, 33, 1), dtype=np.uint8)
    files.insert(5, png.encode(gray, PngOptions.fast(33, 50).replace(color_type=ColorType.GRAY)))
    files.append(b"P6 40 30 255\n" + rng.integers(0, 256, (30, 40, 3), dtype=np.uint8).tobytes())
    files.append(b"P5 40 30 255\n" + rng.integers(0, 256, (30, 40), dtype=np.uint8).tobytes())
    return files


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_thumbnail_pipeline_on_the_card_equals_the_cpu(dev, chunk):
    """Mixed inputs (JPEGs of every sampling, progressive, PNG, PNM): the
    same bytes as on the CPU, with one coefficient and one compaction launch
    a chunk, one decode tail a chunk that holds a JPEG and a resize launch
    for every shape group."""
    files = _thumbnail_inputs()
    wrappers = (kernels.resize_lanczos3, kernels.coeffs, kernels.compact_padded, kernels.idct_planes)
    for fn in wrappers:
        fn.launches = 0
    got = thumbnail_pipeline(files, thumb_size=32, quality=80, chunk_size=chunk, device=dev)
    resized, coeffs, compact, idct = (fn.launches for fn in wrappers)
    assert got == thumbnail_pipeline(files, thumb_size=32, quality=80, chunk_size=chunk, device="cpu")
    chunks = [files[lo:lo + chunk] for lo in range(0, len(files), chunk)]
    assert coeffs == len(chunks) and compact >= len(chunks)
    assert idct == sum(any(d[:2] == b"\xff\xd8" for d in c) for c in chunks)
    assert len(chunks) <= resized <= len(files)


def test_decoded_pixels_stay_on_the_card(dev):
    """``_device_tail`` leaves every image's pixels on the card, laid out as
    ``_pixel_groups`` says, equal to the decode's host images."""
    files = _decode_batch_files()
    batch = jpeg_decoder._host_stage(files, 4, pinned=True)
    pixels, groups = jpeg_decoder._device_tail(batch, False, dev), jpeg_decoder._pixel_groups(batch)
    assert pixels.device.type == "cuda" and pixels.dtype == torch.uint8
    images = decode_jpeg_batch(files, device=dev)
    seen = []
    for members, shape, offset in groups:
        n = int(np.prod(shape))
        block = pixels[offset: offset + len(members) * n].view(len(members), *shape).cpu().numpy()
        for k, i in enumerate(members):
            np.testing.assert_array_equal(block[k], images[i].pixels)
        seen += members
    assert sorted(seen) == list(range(len(files)))


QUANTIZE_CASES = [(name, label, args) for name, cases in
                  quantize_edge_cases(np.random.default_rng(12)).items() for label, *args in cases]


@pytest.mark.parametrize("case", range(len(QUANTIZE_CASES)),
                         ids=[f"{n}-{label}" for n, label, _ in QUANTIZE_CASES])
def test_quantize_kernels_equal_plain_and_host_library(dev, case):
    """Each quantization kernel on its edge cases (K = 1, duplicates,
    k_valid below K, zero weights, ties, H = 1, W = 1, the dither's band
    edges, bands that wrap round its warps, its warp cap,
    alpha other than 255), at byte offsets 0, 1 and 3 of its buffers:
    equal to its plain version and, image by image, to the host library."""
    name, _, args = QUANTIZE_CASES[case]
    if name == "dither_fs":
        args = dither_inputs(*args)
    ref = getattr(quantize_device, name)(*[at_offset(a, 0, dev) for a in args])
    host = quantize_host_oracles(name, args)
    for offset in (0, 1, 3):
        got = getattr(kernels, name)(*[at_offset(a, offset, dev) for a in args])
        assert torch.equal(got, ref)
        for i, h in enumerate(host):
            np.testing.assert_array_equal(got[i].cpu().numpy()[:len(h)], h)


def test_dither_kernel_repeats_equal(dev):
    """One input whose rings fill, 20 times: every output equal to the
    first and to the host library (a race in the rings shows only so)."""
    check_dither_repeats(dev, dither_repeat_case(np.random.default_rng(15)))


def _global_ring_case(rng):
    """33 bands of 55,000 columns: rings of 32 warps past shared memory."""
    rgba = rng.integers(0, 256, (1, 1056, 55_000, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    pal = rng.integers(0, 256, (1, 64, 4), dtype=np.uint8)
    return dither_inputs(rgba, pal, np.array([64], np.int32))


@pytest.mark.parametrize("through", ["C entry", "wrapper"])
def test_dither_kernel_with_global_rings(dev, through):
    """The rings in a global scratch: through the C entry at 1100x40 (the
    bands wrap round 2 warps), and through the wrapper at the width where
    the plan leaves shared memory; equal to the host library."""
    rng = np.random.default_rng(16)
    if through == "C entry":
        rgba = rng.integers(0, 256, (2, 1100, 40, 4), dtype=np.uint8)
        rgba[..., 3] = 255
        args = dither_inputs(rgba, rng.integers(0, 256, (2, 32, 4), dtype=np.uint8),
                             np.array([32, 20], np.int32))
        got = dither_global_ring(args, dev)
    else:
        args = _global_ring_case(rng)
        assert kernels.dither_plan(*args[0].shape[1:3]).ring == "global"
        got = kernels.dither_fs(*[torch.from_numpy(a).to(dev) for a in args])
    for i, h in enumerate(quantize_host_oracles("dither_fs", args)):
        np.testing.assert_array_equal(got[i].cpu().numpy(), h)


def test_quantize_wrappers_refuse_what_the_kernels_do_not_take(dev):
    pal = torch.zeros((1, 257, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="palettes of 1 to 256"):
        kernels.palette_lut(pal)
    with pytest.raises(TypeError, match="uint8"):
        kernels.palette_lut(pal[:, :4].float())
    rgba = torch.zeros((1, 4, 4, 4), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="lut must be"):
        kernels.dither_fs(rgba, pal[:, :4], torch.zeros((1, 10), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="several devices"):
        kernels.dither_fs(rgba, pal[:, :4].cpu(),
                          torch.zeros((1, kernels.LUT_SIZE), dtype=torch.uint8, device=dev))
    with pytest.raises(ValueError, match="weights must be"):
        kernels.kmeans_refine(pal[:, :4], rgba.view(1, 16, 4),
                              torch.zeros((1, 15), dtype=torch.int32, device=dev),
                              torch.ones(1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dithering", [True, False], ids=["dithered", "undithered"])
@pytest.mark.parametrize("color_type", ["RGB", "RGBA"])
def test_lossy_png_batch_on_the_card_equals_per_image_encode(dev, color_type, dithering):
    """Three images of 48x64, one of them with 40 colours (exact mapping),
    FORCE at 64 colours: each file equals the per-image ``png.encode``, and
    each kernel of the path launches once in the call (the dither only when
    dithering)."""
    rng = np.random.default_rng(14)
    c = 4 if color_type == "RGBA" else 3
    imgs = rng.integers(0, 256, (3, 48, 64, c), dtype=np.uint8)
    imgs[1] = rng.integers(0, 256, (40, c), dtype=np.uint8)[rng.integers(0, 40, (48, 64))]
    if c == 4:
        imgs[..., 3] = np.maximum(imgs[..., 3], 200)
        imgs[2, :, 32:, 3] = 255
    opts = lossy_options(64, dithering, color_type=color_type).replace(width=64, height=48)
    for name in ("kmeans_refine", "palette_lut", "dither_fs"):
        getattr(kernels, name).launches = 0
    got = encode_png_batch_sharded(imgs, opts, device=dev)
    launches = [kernels.kmeans_refine.launches, kernels.palette_lut.launches,
                kernels.dither_fs.launches]
    assert launches == [1, 1, int(dithering)]
    assert got == [png.encode(img, opts) for img in imgs]


def test_kmeans_kernel_leaves_its_scratch_zero(dev):
    """Two batches of other sizes one after the other, each twice: the same
    palettes each time, equal to the plain version, and the wrapper's
    scratch (sums and tickets) zero after every call."""
    cases = {label: args for label, *args in quantize_edge_cases(np.random.default_rng(12))["kmeans_refine"]}
    for label in ("counts of 1 to 4000", "k_valid < K", "counts of 1 to 4000"):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in cases[label][:4]]
        counts = cases[label][4] if len(cases[label]) > 4 else None
        ref = quantize_device.kmeans_refine(*args)
        for _ in range(2):
            assert torch.equal(kernels.kmeans_refine(*args, counts), ref)
            scratch = kernels._kmeans_scratch[(args[0].device, kernels._stream(args[0]))]
            assert int(scratch.count_nonzero()) == 0


@pytest.mark.parametrize("limit", ["dither pixels", "batch"])
def test_lossy_batch_on_the_card_past_the_kernels_limits(dev, monkeypatch, limit):
    """With the dither's pixel limit patched below the images (they take the
    host tier) or the batch limit patched to 2 (five members in three
    groups): the files equal the CPU tier's and the per-image ``png.encode``."""
    rng = np.random.default_rng(17)
    imgs = rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8)
    opts = lossy_options(64, True).replace(width=56, height=40)
    if limit == "dither pixels":
        monkeypatch.setattr(kernels, "DITHER_MAX_PIXELS", 40 * 56 - 1)
    else:
        monkeypatch.setattr(kernels, "QUANTIZE_MAX_BATCH", 2)
    kernels.kmeans_refine.launches = 0
    got = encode_png_batch_sharded(imgs, opts, device=dev)
    assert kernels.kmeans_refine.launches == (0 if limit == "dither pixels" else 3)
    assert got == encode_png_batch_sharded(imgs, opts, device="cpu")
    assert got == [png.encode(img, opts) for img in imgs]


@pytest.fixture(scope="module")
def lz77_inputs():
    return lz77_cases(np.random.default_rng(29))


def _on(dev, data):
    return torch.from_numpy(np.ascontiguousarray(data).copy()).to(dev)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_chain_candidates_kernel_equals_plain(dev, lz77_inputs, k):
    """The stable counting sort and the rows' walk on every ``lz77_cases``
    input (one bucket, noise, 256 buckets of 65,536, partial tiles, n = 0 to
    5): the candidates in chain order and their lengths, exactly."""
    for label, data in lz77_inputs.items():
        t = _on(dev, data)
        cand, lens = lz77_assist.chain_candidates(t, k=k)
        ref_cand, ref_lens = lz77_assist.chain_candidates_plain(t, k)
        assert torch.equal(cand, ref_cand), label
        assert torch.equal(lens, ref_lens), label


def test_hash4_and_match_lengths_kernels_equal_plain(dev, lz77_inputs):
    rng = np.random.default_rng(31)
    for label, data in lz77_inputs.items():
        t = _on(dev, data)
        assert torch.equal(lz77_assist.hash4(t), lz77_assist.hash4_plain(t)), label
        pos, cand = (_on(dev, a) for a in match_pairs(rng, len(data), 20_000))
        for max_len in (3, 258):
            got = lz77_assist.batched_match_lengths(t, pos, cand, max_len=max_len)
            assert torch.equal(got, lz77_assist.batched_match_lengths_plain(t, pos, cand, max_len)), label


@pytest.mark.parametrize("n", ADLER_SIZES)
def test_adler32_kernel_equals_zlib(dev, n):
    import zlib

    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    data[::3] = 255
    t = _on(dev, data)
    for start in ADLER_STARTS:
        got = checksums.adler32_device(t, start)
        assert got == checksums.adler32_plain(t, start) == zlib.adler32(data.tobytes(), start)


def test_adler32_kernel_at_the_plans_grid_boundary(dev):
    """Where ``adler32_plan`` turns from 4096-byte shares to a grid of the
    card's CTA slots (a byte either side), and 16 MiB + 17 bytes on that
    grid: against zlib from every start value."""
    import zlib

    for n in adler_boundary_sizes(checksums._adler_slots(dev)):
        data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
        data[::3] = 255
        t = _on(dev, data)
        for start in ADLER_STARTS:
            assert checksums.adler32_device(t, start) == zlib.adler32(data.tobytes(), start), n


def test_chain_candidates_and_adler32_concurrent_calls(dev):
    """Eight threads call ``chain_candidates`` and ``adler32_device`` at
    once, each on an input of its own and a stream of its own (the kernels
    overlap), three times over: each result equals the plain version (a
    flag or ticket that calls shared would mix them)."""
    import concurrent.futures
    import zlib

    rng = np.random.default_rng(43)
    inputs = [rng.integers(0, 4 + 36 * i, 40_000 + 4099 * i, dtype=np.uint8) for i in range(8)]
    on = [_on(dev, d) for d in inputs]
    want = [lz77_assist.chain_candidates_plain(t, 16) for t in on]
    sums = [zlib.adler32(d.tobytes(), 7 + i) for i, d in enumerate(inputs)]
    streams = [torch.cuda.Stream() for _ in range(8)]
    torch.cuda.synchronize()

    def both(i):
        with torch.cuda.stream(streams[i]):
            cand, lens = lz77_assist.chain_candidates(on[i], k=16)
            got = checksums.adler32_device(on[i], 7 + i)
        streams[i].synchronize()
        return torch.equal(cand, want[i][0]) and torch.equal(lens, want[i][1]), got == sums[i]

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        for _ in range(3):
            assert list(ex.map(both, range(8))) == [(True, True)] * 8


def test_lz77_route_on_the_card_equals_the_host_route(dev):
    """``deflate_optimal_zlib`` under PIXO_TPU_LZ77=device on the card: one
    ``chain_candidates`` launch, the host route's bytes; the max-preset batch
    under the route, the CPU route's files."""
    import zlib

    rng = np.random.default_rng(37)
    data = rng.integers(-3, 4, 200_000).astype(np.int8).astype(np.uint8)
    data[rng.random(data.size) < 0.6] = 0
    with env_var("PIXO_TPU_LZ77", None):
        host = deflate.deflate_optimal_zlib(data.tobytes(), 5)
    with env_var("PIXO_TPU_LZ77", "device"):
        before = lz77_assist.chain_candidates.launches
        got = deflate.deflate_optimal_zlib(data.tobytes(), 5, device=dev)
        assert lz77_assist.chain_candidates.launches == before + 1
        imgs = rng.integers(0, 256, (3, 64, 80, 3), dtype=np.uint8)
        opts = PngOptions.max(80, 64).replace(color_type=ColorType.RGB)
        files = encode_png_batch_sharded(imgs, opts, device=dev)
        assert files == encode_png_batch_sharded(imgs, opts, device="cpu")
    assert got == host and zlib.decompress(got) == data.tobytes()


def test_lz77_launch_count_exact_under_threads(dev):
    import concurrent.futures

    t = _on(dev, np.random.default_rng(41).integers(0, 4, 50_000, dtype=np.uint8))
    before = lz77_assist.chain_candidates.launches
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        outs = list(ex.map(lambda _: lz77_assist.chain_candidates(t, k=16), range(64)))
    assert lz77_assist.chain_candidates.launches == before + 64
    ref = lz77_assist.chain_candidates_plain(t, 16)
    assert all(torch.equal(c, ref[0]) and torch.equal(ln, ref[1]) for c, ln in outs)


# ------------------------------------- the streams, meshes, service and front ends

STREAM_ROUTES = {
    "standard 4:2:0": JpegOptions(width=96, height=64, quality=85, subsampling=Subsampling.S420),
    "balanced": JpegOptions.from_preset(96, 64, 85, 1).replace(subsampling=Subsampling.S420),
    "optimal, restarts": JpegOptions(width=96, height=64, quality=80, optimal_huffman=True,
                                     restart_interval=3),
    "progressive": JpegOptions(width=96, height=64, quality=85, progressive=True),
    "max": JpegOptions.max(96, 64, 85),
    "gray": JpegOptions(width=96, height=64, quality=90, color_type=ColorType.GRAY),
}


def _stream_batches(route: str):
    """A smooth batch, a noise batch (the cap escalates, or the dense
    stream), a lightly noisy one."""
    rng = np.random.default_rng(60)
    base = np.add.outer(np.arange(64) * 3, np.arange(96) * 2)[..., None]
    smooth = (base + rng.normal(0, 2, (5, 64, 96, 3))).clip(0, 255).astype(np.uint8)
    noise = rng.integers(0, 256, (3, 64, 96, 3), dtype=np.uint8)
    light = (base + rng.normal(0, 6, (4, 64, 96, 3))).clip(0, 255).astype(np.uint8)
    batches = [smooth, noise, light]
    if STREAM_ROUTES[route].color_type == ColorType.GRAY:
        batches = [np.ascontiguousarray(b[..., 0]) for b in batches]
    return batches


@pytest.mark.parametrize("route", list(STREAM_ROUTES))
@pytest.mark.parametrize("overlapped", [False, True])
def test_streams_on_the_card_equal_the_host_tier(dev, route, overlapped):
    from pixo_tpu_torch.parallel import encode_jpeg_stream, encode_jpeg_stream_overlapped

    opts = STREAM_ROUTES[route]
    batches = _stream_batches(route)
    stream = encode_jpeg_stream_overlapped if overlapped else encode_jpeg_stream
    want = [[jpeg.encode(im, opts, device="cpu") for im in b] for b in batches]
    assert list(stream(batches, opts, device=dev)) == want
    assert list(stream(batches, opts)) == want  # the default device


def test_stream_launches_and_stats_on_the_card(dev):
    """One ``coeffs`` and one ``compact`` a batch, one more ``compact`` (on
    the copy thread) for the batch whose cap escalates; the stats' order."""
    from pixo_tpu_torch.parallel import encode_jpeg_stream_overlapped

    opts = JpegOptions(width=96, height=64, quality=75)
    smooth, noise, light = _stream_batches("standard 4:2:0")
    base = np.add.outer(np.arange(64) * 3, np.arange(96) * 2)[..., None]
    cap16 = (base + np.random.default_rng(61).normal(0, 8, (2, 64, 96, 3))).clip(0, 255).astype(np.uint8)
    zz = kernels.coeffs(torch.from_numpy(cap16).to(dev), QuantizationTables(75).luminance_table,
                        QuantizationTables(75).chrominance_table, "444")
    assert int(kernels.compact_padded(zz, 8)[5].max()) > 8  # the cap escalates on this batch
    before = (kernels.coeffs.launches, kernels.compact_padded.launches)
    stats = {}
    got = list(encode_jpeg_stream_overlapped([smooth, cap16, smooth], opts, device=dev, stats=stats))
    assert got == [[jpeg.encode(im, opts, device="cpu") for im in b] for b in (smooth, cap16, smooth)]
    assert kernels.coeffs.launches - before[0] == 3 and kernels.compact_padded.launches - before[1] == 4
    for (c0, c1), (p0, p1), d in zip(stats["copy_iv"], stats["pack_iv"], stats["dispatch_t"]):
        assert d <= c0 <= c1 <= p0 <= p1


def test_streams_on_a_stream_of_the_callers(dev):
    """The kernels launch on the caller's current stream; each batch's copy
    stream waits on an event recorded there, not on the default stream."""
    from pixo_tpu_torch.parallel import encode_jpeg_stream, encode_jpeg_stream_overlapped

    opts = STREAM_ROUTES["balanced"]
    batches = _stream_batches("balanced")
    want = [[jpeg.encode(im, opts, device="cpu") for im in b] for b in batches]
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        assert list(encode_jpeg_stream(batches, opts, device=dev)) == want
        assert list(encode_jpeg_stream_overlapped(batches * 3, opts, device=dev, depth=1)) == want * 3
        assert encode_jpeg_batch_sharded(batches[1], opts, device=dev) == want[1]


def test_mesh_of_the_visible_cards(dev):
    from pixo_tpu_torch.parallel import (encode_jpeg_stream_overlapped, jpeg_coeffs_sharded,
                                         make_mesh)

    mesh = make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
    opts = STREAM_ROUTES["standard 4:2:0"]
    imgs = np.concatenate(_stream_batches("standard 4:2:0"))
    want = encode_jpeg_batch_sharded(imgs, opts, device=dev)
    assert encode_jpeg_batch_sharded(imgs, opts, mesh=mesh) == want
    assert list(encode_jpeg_stream_overlapped([imgs[:5], imgs[5:]], opts, mesh=mesh)) == \
        [want[:5], want[5:]]
    coeffs = jpeg_coeffs_sharded(imgs, opts, mesh=mesh)
    assert coeffs.device == mesh.devices[0]
    assert torch.equal(coeffs, jpeg_coeffs_sharded(imgs, opts, device=dev).to(mesh.devices[0]))
    with pytest.raises(ValueError):
        encode_jpeg_batch_sharded(imgs, opts, mesh=mesh, device="cuda")
    with pytest.raises(ValueError):
        make_mesh(torch.cuda.device_count() + 1)


def test_pinned_upload_and_copies_back(dev):
    """The pipeline's copy up through pinned memory from numpy, from a CPU
    tensor and from a non-contiguous view; a tensor on the card stays; the
    pinned copies back equal ``.cpu()``."""
    from pixo_tpu_torch.parallel import pipeline

    host = np.random.default_rng(62).integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    for src in (host, torch.from_numpy(host), host[:, ::-1], torch.from_numpy(host).flip(1)):
        up = pipeline._to_device(src, dev)
        ref = src if torch.is_tensor(src) else torch.from_numpy(np.ascontiguousarray(src))
        assert up.device.type == "cuda" and up.is_contiguous() and torch.equal(up.cpu(), ref)
    on = torch.from_numpy(host).to(dev)
    assert pipeline._to_device(on, dev) is on
    stream = torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        got = pipeline._landed([on, on[:, ::2]], stream)  # the second not contiguous
    assert np.array_equal(got[0], host) and np.array_equal(got[1], host[:, ::2])


@pytest.mark.parametrize("mode", MODES)
def test_compute_coefficients_on_the_card_equals_the_host(dev, mode):
    rng = np.random.default_rng(63)
    img = _pixels(rng, 1, 37, 53, mode)[0]
    gray = mode == "gray"
    opts = JpegOptions(width=53, height=37, quality=70, color_type=ColorType.GRAY if gray else ColorType.RGB,
                       subsampling=Subsampling("444" if gray else mode))
    q = QuantizationTables(70)
    assert np.array_equal(jpeg.compute_coefficients(img, opts, q),
                          jpeg.compute_coefficients(img, opts, q, device="cpu"))
    out = bytearray(b"x")
    jpeg.encode_into(out, img, opts)
    assert bytes(out) == jpeg.encode(img, opts, device="cpu")


def test_bindings_on_the_card_equal_the_cpu(dev):
    from pixo_tpu_torch import bindings

    img = np.random.default_rng(64).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    for preset, sub in ((0, False), (1, True), (2, False)):
        assert bindings.encode_jpeg(img, 64, 48, 2, 85, preset, sub) == \
            bindings.encode_jpeg(img, 64, 48, 2, 85, preset, sub, device="cpu")
        assert bindings.encode_png(img, 64, 48, 2, preset, True) == \
            bindings.encode_png(img, 64, 48, 2, preset, True, device="cpu")
    assert bindings.resize_image(img, 64, 48, 20, 15, 2) == \
        bindings.resize_image(img, 64, 48, 20, 15, 2, device="cpu")


def _front_inputs(tmp_path):
    rng = np.random.default_rng(65)
    base = np.add.outer(np.arange(96), np.arange(128))[..., None]
    img = (base + rng.normal(0, 9, (96, 128, 3))).clip(0, 255).astype(np.uint8)
    photo = jpeg.encode(img, JpegOptions(width=128, height=96, quality=90,
                                         subsampling=Subsampling.S420), device="cpu")
    still = png.encode(img, PngOptions.fast(128, 96).replace(color_type=ColorType.RGB), device="cpu")
    (tmp_path / "in.jpg").write_bytes(photo)
    (tmp_path / "in.png").write_bytes(still)
    return photo, still


@pytest.mark.parametrize("src, flags, dst, kernel", [
    ("in.jpg", [], "out.png", "idct_planes"),
    ("in.jpg", ["--fancy-upsampling", "--resize", "40x30"], "out.jpg", "resize_lanczos3"),
    ("in.png", ["--resize", "64x48", "--grayscale", "-q", "80"], "out.jpg", "coeffs"),
    ("in.png", ["--preset", "balanced", "--subsampling", "s420"], "out.jpg", "count_symbols"),
])
def test_cli_on_the_card_equals_the_cpu(dev, tmp_path, src, flags, dst, kernel):
    from pixo_tpu_torch import cli

    _front_inputs(tmp_path)
    wrapper = getattr(kernels, kernel)
    before = wrapper.launches
    assert cli.main([str(tmp_path / src), "-o", str(tmp_path / f"card_{dst}"), "--quiet", *flags]) == 0
    assert wrapper.launches > before
    assert cli.main([str(tmp_path / src), "-o", str(tmp_path / f"cpu_{dst}"), "--quiet", *flags,
                     "--device", "cpu"]) == 0
    assert (tmp_path / f"card_{dst}").read_bytes() == (tmp_path / f"cpu_{dst}").read_bytes()


def test_playground_job_on_the_card_equals_the_cpu(dev, tmp_path):
    from pixo_tpu_torch.playground import compress_bytes

    photo, still = _front_inputs(tmp_path)
    for data, params in ((photo, {"name": "a.jpg", "rw": "32", "rh": "24", "sub420": "true"}),
                         (still, {"name": "a.png", "lossless": "true"}),
                         (photo, {"name": "a.png"})):
        out, meta = compress_bytes(data, params)
        want, want_meta = compress_bytes(data, params, device="cpu")
        assert out == want and meta["out_size"] == want_meta["out_size"]


def test_service_on_the_card_equals_the_cpu(dev, tmp_path):
    import functools

    from pixo_tpu_torch.parallel import CompressService
    from pixo_tpu_torch.playground import compress_bytes

    photo, _ = _front_inputs(tmp_path)
    img = np.random.default_rng(66).integers(0, 256, (64, 96, 3), dtype=np.uint8)
    jopts = JpegOptions(width=96, height=64, quality=85, subsampling=Subsampling.S420)
    ropts = ResizeOptions(src_width=96, src_height=64, dst_width=24, dst_height=16,
                          color_type=ColorType.RGB, filter=ResizeFilter.LANCZOS3)
    params = {"name": "a.jpg", "rw": "32", "rh": "24"}
    with CompressService(workers=1, device="cuda") as svc:
        got_jpeg = svc.submit_jpeg(img, jopts).result()
        got_small = svc.submit_resize(img, ropts).result()
        got_job = svc.submit_raw(compress_bytes, photo, params).result()[0]
        assert svc.submit_raw(torch.cuda.is_initialized).result() is True
    assert got_jpeg == jpeg.encode(img, jopts, device="cpu")
    assert np.array_equal(got_small, resize(img, ropts, device="cpu"))
    assert got_job == functools.partial(compress_bytes, device="cpu")(photo, params)[0]


def test_profile_trace_sees_the_kernels(dev, tmp_path):
    import json

    from pixo_tpu_torch.utils import profile_trace

    img = np.random.default_rng(67).integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    opts = JpegOptions(width=64, height=64, quality=85)
    with profile_trace(str(tmp_path)) as prof:
        encode_jpeg_batch_sharded(img, opts, device=dev)
    assert any("coeffs_kernel" in e.key for e in prof.key_averages())
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]


UNFILTER_CASES = unfilter_edge_cases(np.random.default_rng(41))


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("case", range(len(UNFILTER_CASES)), ids=[c[0] for c in UNFILTER_CASES])
def test_unfilter_kernel_equals_plain_and_host(dev, case, offset):
    """Every bpp and filter id, the edge shapes, the heights around the
    schedule's group, CTA and cluster and those whose groups wrap round the
    warps, at byte offsets 0, 1 and 3: one launch under the plan's split,
    bit for bit its plain version on the card and, for ids 0-4, the host
    library's png_unfilter."""
    label, rows, filters, bpp = UNFILTER_CASES[case]
    t = at_offset(rows, offset, dev)
    ids = torch.from_numpy(filters).to(dev)
    before = png_unfilter.unfilter_device_batch.launches
    got = png_unfilter.unfilter_device_batch(t, ids, bpp=bpp, device=dev)
    torch.cuda.synchronize()
    assert png_unfilter.unfilter_device_batch.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.uint8 and got.shape == t.shape
    assert torch.equal(got, png_unfilter.unfilter_plain(t, ids, bpp)), label
    if ((filters >= 0) & (filters <= 4)).all():
        np.testing.assert_array_equal(got.cpu().numpy(), host_unfilter(rows, filters, bpp))


@pytest.mark.parametrize("forced", range(len(UNFILTER_FORCED)), ids=[f[0] for f in UNFILTER_FORCED])
@pytest.mark.parametrize("case", range(len(UNFILTER_CASES)), ids=[c[0] for c in UNFILTER_CASES])
def test_unfilter_kernel_under_forced_splits(dev, case, forced):
    """The C entry under each of ``UNFILTER_FORCED`` (one SM an image, a
    cluster of 2 CTAs, 8 CTAs of one warp, global rings) on every edge case
    at byte offset 3: bit for bit the plain version."""
    label, rows, filters, bpp = UNFILTER_CASES[case]
    name, ctas, warps, ring = UNFILTER_FORCED[forced]
    t = at_offset(rows, 3, dev)
    ids = torch.from_numpy(filters).to(dev)
    plan = png_unfilter.unfilter_plan(*rows.shape, bpp, ctas=ctas, warps=warps, ring=ring)
    out = torch.empty(rows.shape, dtype=torch.uint8, device=dev)
    lib = kernels.load()
    assert unfilter_launcher(lib, t, ids, bpp, plan, out)() == 0, f"{label} {name}"
    torch.cuda.synchronize()
    assert torch.equal(out, png_unfilter.unfilter_plain(t, ids, bpp)), f"{label} {name} {plan}"


def test_unfilter_entry_refuses_rings_below_the_rule(dev):
    """Groups that wrap round two warps with rows of 200 pixels need rings
    of at least ceil(200 / 2) + 8 slots: 64 are refused, the plan's 128
    taken."""
    rows = torch.zeros((1, 96, 200), dtype=torch.uint8, device=dev)
    ids = torch.zeros((1, 96), dtype=torch.int32, device=dev)
    plan = png_unfilter.unfilter_plan(1, 96, 200, 1, ctas=1, warps=2)
    lib, out = kernels.load(), torch.empty_like(rows)
    assert unfilter_launcher(lib, rows, ids, 1, plan._replace(ring_slots=64), out)() != 0
    assert unfilter_launcher(lib, rows, ids, 1, plan, out)() == 0
    torch.cuda.synchronize()
    assert torch.equal(out, rows)


@pytest.mark.parametrize("strategy", [FilterStrategy.ADAPTIVE, FilterStrategy.PAETH, FilterStrategy.BIGRAMS])
def test_unfilter_kernel_undoes_filter_rows(dev, strategy):
    rng = np.random.default_rng(44)
    y, x = np.mgrid[0:300, 0:3 * 333]
    raw = ((x + 2 * y) % 256 + rng.integers(0, 6, (3, 300, 999))).astype(np.uint8)
    out = kernels.filter_rows(torch.from_numpy(raw).to(dev), bpp=3, strategy=strategy, small_image=False,
                              sticky_fast=False)
    got = png_unfilter.unfilter_device_batch(out[..., 1:].contiguous(), out[..., 0], bpp=3, device=dev)
    np.testing.assert_array_equal(got.cpu().numpy(), raw)


def test_unfilter_kernel_on_numpy_input_and_bad_input(dev):
    label, rows, filters, bpp = UNFILTER_CASES[0]
    got = png_unfilter.unfilter_device(rows[0], filters[0], bpp=bpp)  # the card by default
    assert got.device.type == "cuda"
    np.testing.assert_array_equal(got.cpu().numpy(), host_unfilter(rows[:1], filters[:1], bpp)[0])
    before = png_unfilter.unfilter_device_batch.launches
    with pytest.raises(ValueError):
        png_unfilter.unfilter_device_batch(rows, filters, bpp=9, device=dev)
    empty = png_unfilter.unfilter_device_batch(np.zeros((2, 0, 5), np.uint8), np.zeros((2, 0), np.int32), bpp=1,
                                               device=dev)
    assert empty.shape == (2, 0, 5) and png_unfilter.unfilter_device_batch.launches == before


def test_decode_host_tier_on_the_card(dev, monkeypatch):
    """PIXO_TPU_DECODE_PIXELS=host with a CUDA device: the host library's
    tier, no tail launch, the same pixels as the device tier."""
    rng = np.random.default_rng(45)
    imgs = rng.integers(0, 256, (3, 40, 56, 3), dtype=np.uint8)
    files = encode_jpeg_batch_sharded(imgs, JpegOptions(width=56, height=40, quality=85), device="cpu")
    monkeypatch.delenv("PIXO_TPU_DECODE_PIXELS", raising=False)
    device_tier = decode_jpeg_batch(files, device=dev)
    monkeypatch.setenv("PIXO_TPU_DECODE_PIXELS", "host")
    before = kernels.idct_planes.launches
    host_tier = decode_jpeg_batch(files, device=dev)
    assert kernels.idct_planes.launches == before
    for a, b in zip(device_tier, host_tier):
        np.testing.assert_array_equal(a.pixels, b.pixels)
