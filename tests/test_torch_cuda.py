"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so on a machine with the card and
without JAX it runs on its own:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded
from pixo_tpu_torch.jpeg.tables import QuantizationTables
from pixo_tpu_torch.ops import dct, kernels, sparse_pack

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


def test_dct_kernel_bit_exact(dev, seeded):
    blocks = torch.from_numpy(seeded.uniform(-128, 127, (20_000, 8, 8)).astype(np.float32))
    got = kernels.dct8x8_aan(blocks.to(dev)).cpu()
    assert torch.equal(got.view(torch.int32), dct.dct8x8_aan(blocks).view(torch.int32))


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
