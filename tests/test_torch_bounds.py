"""The kernels' bounds, and the plain versions at the kernels' edge shapes,
on the CPU.

``chip_smoke.kernel_work`` counts the bytes each kernel must move (each
input byte read once, each output byte written once); the card's bound is
those bytes over its memory rate. The counts are held to hand counts at the
main paths' shapes. The plain versions of the two main-path kernels are held
bit for bit against the JAX package at the shapes where the tiled kernels
have their edges: the card tests hold the kernels to these plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.jpeg import tables as jtables
from pixo_tpu.jpeg.encoder import compute_coefficients_host
from pixo_tpu.ops import sparse_pack as jsparse
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import Subsampling as JaxSubsampling

from chip_smoke import (
    EDGE_COUNTS,
    H100_BYTES_PER_S,
    coeff_edge_cases,
    compact_edge_batch,
    kernel_bound,
    kernel_work,
)
from pixo_tpu_torch.jpeg.tables import QuantizationTables
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.ops.sparse_pack import PADDED_CAP_TIERS, sparsify_blocks_padded_batch

MODES = ["gray", "444", "420", "422"]
BLOCKS_420 = 16 * 6 * 32 * 32  # 16 images of 512x512 at 4:2:0: 98,304 blocks

# (kernel, shape, bytes counted by hand, bound in microseconds as PERF.md's
# table rounds it, where the table gives one)
HAND_COUNTS = [
    ("coeffs", dict(b=16, h=512, w=512, c=3, mode="420"), 12_582_912 + BLOCKS_420 * 128, 7.51),
    # the f32 variant: the pixels read, 64 f32 a block written
    ("dct_zz", dict(b=16, h=512, w=512, c=3, mode="420"), 12_582_912 + BLOCKS_420 * 256, 11.27),
    ("dct_zz", dict(b=12, h=512, w=512, c=3, mode="444"), 9_437_184 + 12 * 3 * 4096 * 256, None),
    ("compact", dict(b=16, n=BLOCKS_420 // 16, cap=8),
     12_582_912 + 196_608 + 98_304 + 786_432 + 1_572_864, 4.55),
    ("compact", dict(b=16, n=BLOCKS_420 // 16, cap=16), 12_582_912 + BLOCKS_420 * (3 + 48), None),
    ("compact", dict(b=16, n=BLOCKS_420 // 16, cap=32), 12_582_912 + BLOCKS_420 * (3 + 96), None),
    # the balanced route: the coefficients read, 536 int64 counters an image written
    ("count_symbols", dict(b=16, n=BLOCKS_420 // 16), 12_582_912 + 16 * 536 * 8, 3.78),
    ("count_symbols", dict(b=1, n=1), 128 + 536 * 8, None),
    ("filter_rows", dict(b=16, h=512, rb=1536), 12_582_912 + 16 * 512 * 1537, 7.51),
    ("filter_bank", dict(b=16, h=512, rb=1536), 6 * 12_582_912 + 16 * 512 * 5 * 4, 22.59),
    ("idct_planes", dict(n=BLOCKS_420, out_bytes=16 * (512 * 512 + 2 * 256 * 256)),
     12_582_912 + 6_291_456, 5.63),
    ("dct8x8_aan", dict(n=100_000), 51_200_000, 15.28),
    ("idct8x8_int", dict(n=100_000), 32_000_000, 9.55),
    # the thumbnail chunk: 64 images of 256x256x3 read, 64 of 128x128x3 written; the uint8
    # intermediate (64x256x128x3 = 6,291,456 B, written and read again) is not in the bound
    ("resize_lanczos3", dict(b=64, h=256, w=256, c=3, dh=128, dw=128, ky=14, kx=14),
     12_582_912 + 3_145_728, 4.70),
    ("resize_lanczos3", dict(b=1, h=1812, w=3220, c=3, dh=128, dw=128, ky=87, kx=153),
     1812 * 3220 * 3 + 128 * 128 * 3, None),
    # one (e) stream (512 rows of 1 + 1536 bytes) read, its [n, 16] int32 candidates and
    # lengths written
    ("chain_candidates", dict(n=786_944, k=16), 786_944 + 786_944 * 16 * 8, 30.30),
    ("chain_candidates", dict(n=1 << 24, k=16), (1 << 24) * 129, None),
    ("adler32", dict(n=1 << 24), 1 << 24, 5.01),
]


@pytest.mark.parametrize("name,shape,nbytes,us", HAND_COUNTS,
                         ids=[f"{n}-{s.get('cap', '')}" for n, s, _, _ in HAND_COUNTS])
def test_kernel_bytes_match_hand_counts(name, shape, nbytes, us):
    assert kernel_work(name, **shape)[0] == nbytes
    bound, by = kernel_bound(name, **shape)
    assert by == "bytes"  # every kernel moves more than it computes
    assert bound == pytest.approx(nbytes / H100_BYTES_PER_S * 1e3)
    if us is not None:
        assert round(bound * 1e3, 2) == us


def test_coeffs_operations_under_the_byte_bound():
    nbytes, ops = kernel_work("coeffs", b=16, h=512, w=512, c=3, mode="420")
    assert ops == BLOCKS_420 * (16 * 42 + 3 * 64)
    assert 0 < ops / 67e12 < nbytes / H100_BYTES_PER_S


def test_resize_operations_under_the_byte_bound():
    """A multiply and an add a tap: the horizontal pass over the
    intermediate's samples, the vertical pass over the output's."""
    from pixo_tpu_torch.ops.resize_kernels import lanczos_taps

    kx, ky = lanczos_taps(256, 128)[1].shape[1], lanczos_taps(256, 128)[1].shape[1]
    assert (kx, ky) == (14, 14)
    nbytes, ops = kernel_work("resize_lanczos3", b=64, h=256, w=256, c=3, dh=128, dw=128, ky=ky, kx=kx)
    assert ops == 2 * 14 * (64 * 256 * 128 * 3 + 64 * 128 * 128 * 3)
    assert 0 < ops / 67e12 < nbytes / H100_BYTES_PER_S


@pytest.mark.parametrize("shape", [dict(b=64, h=256, w=256, c=3, dh=128, dw=128, ky=14, kx=14),
                                   dict(b=1, h=1812, w=3220, c=3, dh=128, dw=128, ky=87, kx=153)],
                         ids=["t1 chunk", "large image"])
def test_resize_passes_split_the_work(shape):
    """Each launch alone: the horizontal pass reads the source and writes
    the intermediate, the vertical pass reads it and writes the result; the
    two together move the intermediate twice more than the function must."""
    both = kernel_work("resize_lanczos3", **shape)
    h = kernel_work("resize_lanczos3", passes="horizontal", **shape)
    v = kernel_work("resize_lanczos3", passes="vertical", **shape)
    mid = shape["b"] * shape["h"] * shape["dw"] * shape["c"]
    assert h[0] + v[0] == both[0] + 2 * mid and h[1] + v[1] == both[1]
    assert h[0] == shape["b"] * shape["h"] * shape["w"] * shape["c"] + mid
    assert kernel_bound("resize_lanczos3", passes="vertical", **shape)[1] == "bytes"


# The lossy cells: 16 palettes padded to 256 entries, 16 LUTs, 16 images of
# 512x512; the k-means of 14 members with 8192 weighted colours each.
LOSSY_COUNTS = [
    ("palette_lut", dict(b=16, k=256), 16 * (1024 + 262_144), 16 * 262_144 * 256 * 20, "operations"),
    ("kmeans_refine", dict(b=14, k=256, m=8192, distances=2 * 14 * 8192 * 256, assigned=2 * 14 * 8192),
     14 * (2048 + 65_536 + 4), 2 * 14 * 8192 * (256 * 20 + 10), "operations"),
    ("dither_fs", dict(b=16, h=512, w=512, k=256, alpha_pixels=0),
     16 * 512 * 512 * 5 + 16 * (1024 + 262_144), 16 * 512 * 512 * 44, "bytes"),
    # a small image: reading its LUT takes longer than its operations
    ("dither_fs", dict(b=1, h=23, w=37, k=48, alpha_pixels=100),
     23 * 37 * 5 + 192 + 262_144, 23 * 37 * 44 + 100 * 48 * 20, "bytes"),
    # each image's own real entries: the LUT scans 64 and 256 of its padded 256
    ("palette_lut", dict(b=2, k=[64, 256]), 2 * 262_144 + 4 * 320, 262_144 * 320 * 20, "operations"),
    # the direct redmean: 10 alpha pixels over 16 entries, 30 over 200
    ("dither_fs", dict(b=2, h=23, w=37, k=[16, 200], alpha_pixels=[10, 30]),
     2 * 23 * 37 * 5 + 4 * 216 + 2 * 262_144, 2 * 23 * 37 * 44 + (10 * 16 + 30 * 200) * 20, "bytes"),
]


@pytest.mark.parametrize("name,shape,nbytes,ops,by", LOSSY_COUNTS,
                         ids=[f"{n}-{s['b']}" for n, s, _, _, _ in LOSSY_COUNTS])
def test_quantization_kernels_count_int32_operations(name, shape, nbytes, ops, by):
    """Each input byte read once (a dither's LUT whole), each output byte
    written once, and the integer operations of the redmean distances (20
    each), the k-means accumulation (10 a weighted colour) and the dither's
    pixels (44 each, and the direct redmean of each pixel with alpha), over
    132 SMs x 128 lanes (the SM's issue rate) x 1.98 GHz."""
    from chip_smoke import H100_INT32_OPS_PER_S

    assert kernel_work(name, **shape) == (nbytes, ops)
    assert H100_INT32_OPS_PER_S == 132 * 128 * 1.98e9
    bound = max(nbytes / H100_BYTES_PER_S, ops / H100_INT32_OPS_PER_S) * 1e3
    assert kernel_bound(name, **shape) == (pytest.approx(bound), by)


@pytest.mark.parametrize("n,dp,by", [(73_728, 73_728, "operations"), (98_304, 0, "bytes"),
                                     (98_304, 2_000, "bytes"), (1, 1, "operations")],
                         ids=["all through the DP", "all exit", "few through the DP", "one block"])
def test_trellis_counts_the_dp_this_data_runs(n, dp, by):
    """256 bytes in and 128 out a block; the all-zero exit's test for every
    block and the DP's steps for the ``dp`` blocks that run it, at one
    operation a lane a clock (no multiply-add among them)."""
    from chip_smoke import H100_INT32_OPS_PER_S, TRELLIS_EXIT_OPS, TRELLIS_STEP_OPS

    nbytes, ops = kernel_work("trellis_quantize", n=n, dp=dp)
    assert nbytes == 384 * n
    assert (TRELLIS_EXIT_OPS, TRELLIS_STEP_OPS) == (189, 168)
    assert ops == 189 * n + 63 * 168 * dp
    bound = max(nbytes / H100_BYTES_PER_S, ops / H100_INT32_OPS_PER_S) * 1e3
    assert kernel_bound("trellis_quantize", n=n, dp=dp) == (pytest.approx(bound), by)


def test_unknown_kernel_has_no_work_model():
    with pytest.raises(ValueError):
        kernel_work("resize", n=1)


def _jax_options(mode, h, w):
    opts = JaxJpegOptions(width=w, height=h, quality=85,
                          subsampling=JaxSubsampling("444" if mode == "gray" else mode))
    return opts.replace(color_type=JaxColorType.GRAY) if mode == "gray" else opts


CASES = coeff_edge_cases(np.random.default_rng(8))


@pytest.mark.parametrize("case", range(len(CASES)), ids=[label for label, _ in CASES])
@pytest.mark.parametrize("mode", MODES)
def test_plain_coeffs_at_edge_shapes_match_jax_host(mode, case):
    _, batch = CASES[case]
    host = np.ascontiguousarray(batch[..., 0] if mode == "gray" else batch)
    qt = QuantizationTables(85)
    got = kernels.coeffs(torch.from_numpy(host), qt.luminance_table, qt.chrominance_table, mode)
    assert got.dtype == torch.int16
    ref_q = jtables.QuantizationTables(85)
    opts = _jax_options(mode, host.shape[1], host.shape[2])
    for i in range(len(host)):
        rgb = host[i] if mode == "gray" else np.ascontiguousarray(host[i, ..., :3])
        np.testing.assert_array_equal(got[i].numpy(), compute_coefficients_host(rgb, opts, ref_q))


@pytest.mark.parametrize("b,n", [(3, 101), (70, 1), (1, 64)])
@pytest.mark.parametrize("cap", PADDED_CAP_TIERS)
def test_plain_compaction_at_edge_counts_matches_jax(cap, b, n):
    zz = compact_edge_batch(np.random.default_rng(9), b, n)
    counts = (zz[..., 1:] != 0).sum(-1)
    assert set(counts.ravel()) == set(EDGE_COUNTS)
    got = sparsify_blocks_padded_batch(torch.from_numpy(zz), cap)
    ref = jsparse.sparsify_blocks_padded_batch(jnp.asarray(zz), cap_per_block=cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
