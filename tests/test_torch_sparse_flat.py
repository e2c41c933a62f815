"""The port's flat compaction route against the JAX package, on the CPU.

``sparsify_blocks`` and ``sparsify_blocks_batch`` are integer work, so the
JAX jit versions (on XLA:CPU) and the port's plain PyTorch must agree
exactly, overflowing images included. ``padded_to_flat`` turns the padded
rows into the same streams, and ``native_pack_scan_sparse`` packs them into
the bytes of the dense and padded packers and of the JAX package's binding.
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
from pixo_tpu_torch.ops import sparse_pack

FIELDS = ("dc", "counts", "poss", "vals", "total")
DTYPES = (torch.int16, torch.uint8, torch.uint8, torch.int16, torch.int32)


def _zz(rng, b=3, n=40, density=None):
    """Zigzag blocks with 0..63 nonzero ACs each (``density`` scales the
    share of nonzeros): an empty block, a full one, one with only the last
    position, ACs in the baseline tables' range."""
    zz = np.zeros((b, n, 64), np.int16)
    zz[..., 0] = rng.integers(-1000, 1001, (b, n))  # DC differences within 2047
    share = rng.integers(0, 64, (b, n, 1)) / 63.0 if density is None else density
    mask = rng.random((b, n, 63)) < share
    zz[..., 1:] = np.where(mask, rng.integers(-1000, 1001, (b, n, 63)), 0)
    zz[0, 0, 1:] = 0
    zz[0, 1, 1:] = -1
    zz[0, 2, 1:] = 0
    zz[0, 2, 63] = 5
    return zz


def _check_equal(got, ref):
    for name, dtype, g, r in zip(FIELDS, DTYPES, got, ref):
        assert g.dtype == dtype, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


@pytest.mark.parametrize("cap", [1, sparse_pack.DEFAULT_CAP_PER_BLOCK, 16, 63])
def test_flat_batch_exact_against_jax(rng, cap):
    """Every image at every cap, the overflowing ones (total > cap) too:
    their streams hold the first ``cap`` entries, as the JAX package's."""
    zz = _zz(rng)
    got = sparse_pack.sparsify_blocks_batch(torch.from_numpy(zz), cap)
    ref = jsparse.sparsify_blocks_batch(jnp.asarray(zz), cap_per_block=cap)
    _check_equal(got, ref)
    if cap < 63:
        assert int(got[4].max()) > cap * zz.shape[1]  # an overflow is part of the case
    assert got[2].shape == (zz.shape[0], cap * zz.shape[1])


@pytest.mark.parametrize("n", [1, 7, 64])
def test_flat_single_exact_against_jax(rng, n):
    zz = _zz(rng, b=1, n=max(n, 3))[0, :n]
    got = sparse_pack.sparsify_blocks(torch.from_numpy(zz))
    _check_equal(got, jsparse.sparsify_blocks(jnp.asarray(zz)))
    for s, b in zip(got, sparse_pack.sparsify_blocks_batch(torch.from_numpy(zz[None]))):
        assert torch.equal(s, b[0])


def test_flat_streams_by_hand(rng):
    """Independent of both implementations: every block's nonzero ACs in
    zigzag order, block after block, then zeros."""
    zz = _zz(rng, b=1, n=30, density=0.1)[0]
    dc, counts, poss, vals, total = sparse_pack.sparsify_blocks(torch.from_numpy(zz), 8)
    nz = [np.nonzero(blk[1:])[0] + 1 for blk in zz]
    want_pos = np.concatenate(nz).astype(np.uint8)
    want_val = np.concatenate([blk[p] for blk, p in zip(zz, nz)])
    t = int(total)
    assert t == len(want_pos) <= len(poss)
    np.testing.assert_array_equal(poss[:t].numpy(), want_pos)
    np.testing.assert_array_equal(vals[:t].numpy(), want_val)
    assert not poss[t:].any() and not vals[t:].any()
    np.testing.assert_array_equal(counts.numpy(), [len(p) for p in nz])
    np.testing.assert_array_equal(dc.numpy(), zz[:, 0])


def test_constants_match_reference():
    assert sparse_pack.DEFAULT_CAP_PER_BLOCK == jsparse.DEFAULT_CAP_PER_BLOCK
    assert sparse_pack.PADDED_CAP_MAX == jsparse.PADDED_CAP_MAX


@pytest.mark.parametrize("cap", sparse_pack.PADDED_CAP_TIERS)
def test_padded_to_flat_gives_the_flat_streams(rng, cap):
    """The port's padded compaction, flattened, is the flat route's streams
    up to ``total``, and the JAX ``padded_to_flat`` of the same rows."""
    zz = _zz(rng, b=2, n=50, density=0.05)
    zz[1, :, cap + 1:] = 0  # image 1 fits the tier whatever the draw
    for img in zz:
        dc, counts, poss, vals, total, maxcount = sparse_pack.sparsify_blocks_padded(
            torch.from_numpy(img), cap)
        if int(maxcount) > cap:
            continue
        fpos, fval = sparse_pack.padded_to_flat(counts.numpy(), poss.numpy(), vals.numpy())
        flat = sparse_pack.sparsify_blocks(torch.from_numpy(img), 64)
        t = int(flat[4])
        assert int(total) == t == len(fpos)
        np.testing.assert_array_equal(fpos, flat[2][:t].numpy())
        np.testing.assert_array_equal(fval, flat[3][:t].numpy())
        jpos, jval = jsparse.padded_to_flat(counts.numpy(), poss.numpy(), vals.numpy())
        np.testing.assert_array_equal(fpos, jpos)
        np.testing.assert_array_equal(fval, jval)


@pytest.mark.parametrize("restart", [None, 1, 5])
@pytest.mark.parametrize("pattern", [(0,), (0, 1, 2), (0, 0, 0, 0, 1, 2)])
def test_sparse_packer_bytes(rng, restart, pattern):
    """``native_pack_scan_sparse`` on the flat streams gives the bytes of
    ``native_pack_scan_padded`` on the padded rows and of the dense packer,
    and of the JAX package's sparse binding on the same streams."""
    zz = _zz(rng, b=1, n=36, density=0.08)[0]
    zz[:, 33:] = 0  # every block fits the cap-32 padded tier
    huff, jhuff = HuffmanTables.default(), JaxHuffmanTables.default()
    dc, counts, poss, vals, total = (a.numpy() for a in sparse_pack.sparsify_blocks(
        torch.from_numpy(zz), 64))
    t = int(total)
    got = native.native_pack_scan_sparse(dc, counts, poss[:t], vals[:t], pattern, huff, restart)
    pdc, pcounts, pposs, pvals, _, maxcount = (a.numpy() for a in sparse_pack.sparsify_blocks_padded(
        torch.from_numpy(zz), sparse_pack.PADDED_CAP_MAX))
    assert int(maxcount) <= sparse_pack.PADDED_CAP_MAX
    assert got == native.native_pack_scan_padded(pdc, pcounts, pposs, pvals, pattern, huff, restart)
    assert got == native.native_pack_scan(zz, pattern, huff, restart)
    assert got == jnative.native_pack_scan_sparse(dc, counts, poss, vals, pattern, jhuff, restart)


def test_sparse_packer_rejects_short_streams(rng):
    zz = _zz(rng, b=1, n=8, density=0.3)[0]
    dc, counts, poss, vals, total = (a.numpy() for a in sparse_pack.sparsify_blocks(
        torch.from_numpy(zz), 64))
    huff = HuffmanTables.default()
    with pytest.raises(ValueError):
        native.native_pack_scan_sparse(dc, counts, poss[:int(total) - 1], vals[:int(total) - 1],
                                       (0,), huff, None)
    with pytest.raises(ValueError):
        native.native_pack_scan_sparse(dc, counts[:-1], poss, vals, (0,), huff, None)
