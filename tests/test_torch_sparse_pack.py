"""The port's per-block compaction against the JAX package, on the CPU.

Compaction is integer work, so the JAX ``sparsify_blocks_padded_batch``
(jit on XLA:CPU) and the port's plain version must agree exactly, absent
slots and overflowing blocks included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pixo_tpu import native as jnative
from pixo_tpu.jpeg.tables import HuffmanTables as JaxHuffmanTables
from pixo_tpu.ops import sparse_pack as jsparse

from pixo_tpu_torch import native
from pixo_tpu_torch.jpeg.tables import HuffmanTables
from pixo_tpu_torch.ops import kernels, sparse_pack

FIELDS = ("dc", "counts", "poss", "vals", "total", "maxcount")
DTYPES = (torch.int16, torch.uint8, torch.uint8, torch.int16, torch.int32, torch.int32)


def _zz(rng, b=3, n=50):
    """Zigzag blocks with 0..63 nonzero ACs each: empty blocks, sparse
    ones, and blocks far over every cap tier."""
    zz = np.zeros((b, n, 64), np.int16)
    zz[..., 0] = rng.integers(-2000, 2000, (b, n))
    density = rng.integers(0, 64, (b, n, 1)) / 63.0
    mask = rng.random((b, n, 63)) < density
    zz[..., 1:] = np.where(mask, rng.integers(-1023, 1024, (b, n, 63)), 0)
    zz[0, 0, 1:] = 0  # an empty block
    zz[0, 1, 1:] = -1  # a full block
    zz[0, 2, 1:] = 0
    zz[0, 2, 63] = 5  # the last position only
    return zz


@pytest.mark.parametrize("cap", sparse_pack.PADDED_CAP_TIERS)
def test_compaction_exact_against_jax(rng, cap):
    zz = _zz(rng)
    got = sparse_pack.sparsify_blocks_padded_batch(torch.from_numpy(zz), cap)
    ref = jsparse.sparsify_blocks_padded_batch(jnp.asarray(zz), cap_per_block=cap)
    assert int(got[5].max()) > cap  # overflow blocks are part of the case
    for name, dtype, g, r in zip(FIELDS, DTYPES, got, ref):
        assert g.dtype == dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("cap", sparse_pack.PADDED_CAP_TIERS)
def test_wrapper_uses_plain_version_on_cpu(rng, cap):
    zz = torch.from_numpy(_zz(rng, b=2, n=9))
    before = kernels.compact_padded.launches
    for g, r in zip(kernels.compact_padded(zz, cap),
                    sparse_pack.sparsify_blocks_padded_batch(zz, cap)):
        assert torch.equal(g, r)
    assert kernels.compact_padded.launches == before


def test_single_image_is_batch_of_one(rng):
    zz = torch.from_numpy(_zz(rng, b=1, n=20))
    single = sparse_pack.sparsify_blocks_padded(zz[0], 16)
    batch = sparse_pack.sparsify_blocks_padded_batch(zz, 16)
    for s, b in zip(single, batch):
        assert torch.equal(s, b[0])


def test_padded_rows_hold_first_nonzeros_in_zigzag_order(rng):
    """Independent of both implementations: walk each block by hand."""
    zz = _zz(rng, b=1, n=40)[0]
    dc, counts, poss, vals, total, maxcount = sparse_pack.sparsify_blocks_padded(
        torch.from_numpy(zz), 8
    )
    for i, blk in enumerate(zz):
        nz = np.nonzero(blk[1:])[0] + 1
        assert int(counts[i]) == len(nz) and int(dc[i]) == blk[0]
        k = min(len(nz), 8)
        np.testing.assert_array_equal(poss[i, :k].numpy(), nz[:k])
        np.testing.assert_array_equal(vals[i, :k].numpy(), blk[nz[:k]])
        assert not poss[i, k:].any() and not vals[i, k:].any()
    assert int(total) == int((zz[:, 1:] != 0).sum())
    assert int(maxcount) == int((zz[:, 1:] != 0).sum(1).max())


def test_cap_tiers_match_reference():
    assert sparse_pack.PADDED_CAP_TIERS == jsparse.PADDED_CAP_TIERS
    assert sparse_pack.PADDED_CAP_PER_BLOCK == jsparse.PADDED_CAP_PER_BLOCK


def test_wrapper_rejects_bad_input(rng):
    zz = torch.from_numpy(_zz(rng, b=1, n=4))
    with pytest.raises(ValueError):
        kernels.compact_padded(zz, 12)
    with pytest.raises(TypeError):
        kernels.compact_padded(zz.to(torch.int32), 8)
    with pytest.raises(ValueError):
        kernels.compact_padded(zz[0], 8)


@pytest.mark.parametrize("restart", [None, 3])
def test_host_packers_agree_with_each_other_and_the_jax_package(rng, restart):
    """The port's bindings of the dense, batch and padded packers give the
    JAX package's dense packer's bytes on the same coefficients."""
    # baseline tables code DC differences up to 2047 and ACs up to 1023
    zz = np.clip(_zz(rng, b=2, n=36), -1000, 1000)
    zz[1, :, 33:] = 0  # image 1 fits the cap-32 padded layout
    pattern = (0, 0, 0, 0, 1, 2)
    huff = HuffmanTables.default()
    refs = [jnative.native_pack_scan(z, pattern, JaxHuffmanTables.default(), restart) for z in zz]
    assert native.native_pack_scan_batch(zz, pattern, huff, restart, nthreads=2) == refs
    assert [native.native_pack_scan(z, pattern, huff, restart) for z in zz] == refs
    dc, counts, poss, vals, _, maxcount = sparse_pack.sparsify_blocks_padded(
        torch.from_numpy(zz[1]), 32
    )
    assert int(maxcount) <= 32
    assert native.native_pack_scan_padded(
        dc.numpy(), counts.numpy(), poss.numpy(), vals.numpy(), pattern, huff, restart
    ) == refs[1]
