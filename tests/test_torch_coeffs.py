"""The port's coefficient stage against the JAX package, on the CPU.

Inputs come from a seeded numpy generator and go through both the JAX
package's function (its NumPy mirror, its native host tier, or its Pallas
kernel in interpret mode) and the port's plain PyTorch version. Integer
stages and the f32 DCT are held exactly; only the interpreted Pallas DCT
gets a tolerance (see ``test_dct_close_to_pallas_interpret``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pixo_tpu.color import rgb_to_ycbcr_np
from pixo_tpu.jpeg import tables as jtables
from pixo_tpu.jpeg.encoder import compute_coefficients_host
from pixo_tpu.ops import blockify as jblockify
from pixo_tpu.ops.dct import dct8x8_aan_np
from pixo_tpu.ops.pallas_kernels import dct8x8_aan_pallas
from pixo_tpu.ops.quantize import quantize_blocks_np, round_half_away_np, zigzag_blocks_np
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import Subsampling as JaxSubsampling

from pixo_tpu_torch import color, errors
from pixo_tpu_torch.jpeg import tables
from pixo_tpu_torch.jpeg.encoder import _device_coeffs_batch, _validate
from pixo_tpu_torch.ops import blockify, dct, kernels, quantize
from pixo_tpu_torch.options import JpegOptions

SIZES = [(1, 1), (17, 33), (100, 75), (64, 48)]
MODES = ["gray", "444", "420", "422"]


def _batch(rng, h, w, mode, b=2):
    shape = (b, h, w) if mode == "gray" else (b, h, w, 3)
    return rng.integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("h,w", SIZES)
def test_rgb_to_ycbcr_exact(rng, h, w):
    imgs = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    got = color.rgb_to_ycbcr(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, rgb_to_ycbcr_np(imgs))


def test_rgb_to_ycbcr_all_colors_exact():
    """Every value of each channel against the others' extremes: the
    arithmetic shift and the clamp, on the 2**8 x 3 x 4 corner grid."""
    v = np.arange(256)
    grid = np.stack(np.meshgrid(v, [0, 255], [0, 128, 255], indexing="ij"), -1)
    rgb = np.concatenate([np.roll(grid, k, axis=-1) for k in range(3)]).astype(np.uint8)
    np.testing.assert_array_equal(
        color.rgb_to_ycbcr(torch.from_numpy(rgb)).numpy(), rgb_to_ycbcr_np(rgb)
    )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("h,w", SIZES)
def test_blocks_exact(rng, mode, h, w):
    imgs = _batch(rng, h, w, mode)
    got = getattr(blockify, f"blocks_{mode}")(torch.from_numpy(imgs)).numpy()
    ref_fn = getattr(jblockify, f"blocks_{mode}_np")
    for i in range(len(imgs)):
        np.testing.assert_array_equal(got[i], ref_fn(imgs[i]))


@pytest.mark.parametrize("color_,sub", [("gray", "444"), ("rgb", "444"), ("rgb", "420"), ("rgb", "422")])
@pytest.mark.parametrize("w,h", [(1, 1), (33, 17), (512, 512)])
def test_scan_layout_matches(color_, sub, w, h):
    assert blockify.scan_layout(w, h, color_, sub) == jblockify.scan_layout(w, h, color_, sub)


def test_dct_bit_exact_against_numpy_mirror(rng):
    blocks = rng.uniform(-128, 127, (50_000, 8, 8)).astype(np.float32)
    got = dct.dct8x8_aan(torch.from_numpy(blocks)).numpy()
    ref = dct8x8_aan_np(blocks)
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_dct_wrapper_uses_plain_version_on_cpu(rng):
    blocks = torch.from_numpy(rng.uniform(-128, 127, (300, 8, 8)).astype(np.float32))
    before = kernels.dct8x8_aan.launches
    assert torch.equal(kernels.dct8x8_aan(blocks), dct.dct8x8_aan(blocks))
    assert kernels.dct8x8_aan.launches == before  # no kernel launch on the CPU


def test_dct_close_to_pallas_interpret(rng):
    """The Pallas kernel interpreted on XLA:CPU is FMA-contracted by LLVM
    (tests/test_pallas_kernels.py:46-53), so it is held with atol=2e-3."""
    blocks = rng.uniform(-128, 127, (1500, 8, 8)).astype(np.float32)
    ref = np.asarray(dct8x8_aan_pallas(jnp.asarray(blocks), interpret=True))
    got = dct.dct8x8_aan(torch.from_numpy(blocks)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3)


def test_dct_constants_match():
    from pixo_tpu.ops import dct as jdct

    for name in ("A1", "A2", "A3", "A4", "A5", "S"):
        np.testing.assert_array_equal(getattr(dct, name), getattr(jdct, name))


def test_round_half_away_ties():
    x = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.49999997, -0.49999997, 3.0, -0.0],
                 np.float32)
    got = quantize.round_half_away(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, round_half_away_np(x))
    np.testing.assert_array_equal(got[:6], [1, -1, 2, -2, 3, -3])


def test_quantize_exact_with_ties(rng):
    """Random DCT values plus exact +-x.5 quotients for every table entry."""
    qt = tables.QuantizationTables(50).luminance_table.reshape(8, 8)
    dctv = rng.uniform(-1024, 1024, (4000, 8, 8)).astype(np.float32)
    k = rng.integers(-20, 20, (1000, 8, 8)).astype(np.float32)
    ties = ((k + np.float32(0.5)) * qt).astype(np.float32)  # quotient exactly k + 0.5
    dctv = np.concatenate([dctv, ties, -ties])
    got = quantize.quantize_blocks(torch.from_numpy(dctv), torch.from_numpy(qt)).numpy()
    np.testing.assert_array_equal(got, quantize_blocks_np(dctv, qt))


def test_zigzag_exact(rng):
    c = rng.integers(-500, 500, (7, 8, 8)).astype(np.int16)
    got = quantize.zigzag_blocks(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, zigzag_blocks_np(c))
    flat = quantize.zigzag_blocks(torch.from_numpy(c.reshape(7, 64))).numpy()
    np.testing.assert_array_equal(flat, got)


@pytest.mark.parametrize("q", [1, 50, 85, 100])
@pytest.mark.parametrize("mode", MODES)
def test_plain_chain_matches_host_coefficients(rng, mode, q):
    """The whole plain chain against the JAX package's host coefficient
    tier, on sizes that are not multiples of 8 or 16."""
    for h, w in [(17, 33), (100, 75)]:
        imgs = _batch(rng, h, w, mode)
        qt = tables.QuantizationTables(q)
        got = _device_coeffs_batch(
            torch.from_numpy(imgs), qt.luminance_table, qt.chrominance_table,
            color="gray" if mode == "gray" else "rgb",
            subsampling="444" if mode == "gray" else mode,
        ).numpy()
        opts = JaxJpegOptions(
            width=w, height=h, quality=q,
            subsampling=JaxSubsampling("444" if mode == "gray" else mode),
        )
        if mode == "gray":
            from pixo_tpu.color import ColorType as JaxColorType

            opts = opts.replace(color_type=JaxColorType.GRAY)
        ref_q = jtables.QuantizationTables(q)
        for i in range(len(imgs)):
            np.testing.assert_array_equal(got[i], compute_coefficients_host(imgs[i], opts, ref_q))


def test_plain_chain_rgba_uses_first_three_channels(rng):
    rgba = rng.integers(0, 256, (2, 19, 21, 4), dtype=np.uint8)
    qt = tables.QuantizationTables(85)
    a = kernels.coeffs(torch.from_numpy(rgba), qt.luminance_table, qt.chrominance_table, "420")
    b = kernels.coeffs(torch.from_numpy(np.ascontiguousarray(rgba[..., :3])),
                       qt.luminance_table, qt.chrominance_table, "420")
    assert torch.equal(a, b)
    assert a.shape == (2, blockify.num_blocks(19, 21, "420"), 64)


def test_quantization_tables_carried_across():
    """The port's "weights": the quality-scaled tables for q = 1..100."""
    for q in range(1, 101):
        mine, ref = tables.QuantizationTables(q), jtables.QuantizationTables(q)
        for name in ("luminance_table", "chrominance_table", "luminance_table_int",
                     "chrominance_table_int", "luminance", "chrominance"):
            a, b = getattr(mine, name), getattr(ref, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_huffman_tables_and_zigzag_carried_across():
    mine, ref = tables.HuffmanTables.default(), jtables.HuffmanTables.default()
    for kind in ("dc_lum", "dc_chrom", "ac_lum", "ac_chrom"):
        for part in ("bits", "vals"):
            assert getattr(mine, f"{kind}_{part}") == getattr(ref, f"{kind}_{part}")
        for part in ("codes", "lengths"):
            a, b = getattr(mine, f"{kind}_{part}"), getattr(ref, f"{kind}_{part}")
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tables.ZIGZAG, jtables.ZIGZAG)
    np.testing.assert_array_equal(tables.ZIGZAG_INV, jtables.ZIGZAG_INV)


def test_coeffs_wrapper_rejects_bad_input():
    qt = tables.QuantizationTables(85)
    args = (qt.luminance_table, qt.chrominance_table)
    with pytest.raises(TypeError):
        kernels.coeffs(torch.zeros((1, 8, 8, 3), dtype=torch.int32), *args, "444")
    with pytest.raises(ValueError):
        kernels.coeffs(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), *args, "411")
    with pytest.raises(ValueError):
        kernels.coeffs(torch.zeros((1, 8, 8), dtype=torch.uint8), *args, "420")
    with pytest.raises(ValueError):
        kernels.coeffs(torch.zeros((1, 8, 8, 3), dtype=torch.uint8), *args, "gray")
    with pytest.raises(ValueError):
        kernels.coeffs(torch.zeros((1, 8, 16, 3), dtype=torch.uint8)[:, :, ::2], *args, "444")


@pytest.mark.parametrize(
    "kwargs,exc",
    [
        (dict(quality=0), errors.InvalidQuality),
        (dict(quality=101), errors.InvalidQuality),
        (dict(restart_interval=0), errors.InvalidRestartInterval),
        (dict(width=0), errors.InvalidDimensions),
        (dict(width=70000, height=1), errors.ImageTooLarge),
    ],
)
def test_validate_errors(kwargs, exc):
    opts = JpegOptions(width=8, height=8, quality=85).replace(**kwargs)
    with pytest.raises(exc):
        _validate(opts, opts.width * opts.height * 3)


def test_validate_data_length():
    opts = JpegOptions(width=8, height=8, quality=85)
    assert _validate(opts, 192) == 3
    with pytest.raises(errors.InvalidDataLength):
        _validate(opts, 191)
