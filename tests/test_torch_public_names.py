"""Public names of the JAX package that no path of the port runs, against
their JAX counterparts, on the CPU: the LSB-first bit writer and reader
(``bits.py``), the matrix DCT and its inverse (``ops/dct.py``), the dense
Lanczos weight matrix (``ops/resize_kernels.py``) and the redmean distance
(``png/quantize.py``).

Tolerance: the matrix DCT is two float32 products whose summation order is
the library's (torch's here, XLA:CPU's in the JAX package), so it is held to
the JAX package's and to a float64 reference within 2e-3 absolute on inputs
in [-128, 128) (outputs up to about 1024); everything else is exact.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixo_tpu import bits as jbits
from pixo_tpu.ops import dct as jdct
from pixo_tpu.ops import resize_kernels as jresize
from pixo_tpu.png import quantize as jquantize

from pixo_tpu_torch import bits, native
from pixo_tpu_torch.ops import dct, resize_kernels
from pixo_tpu_torch.png import quantize

jax.config.update("jax_platforms", "cpu")

DCT_ATOL = 2e-3


def _writes(rng, n=400):
    """(op, arguments) of a seeded write sequence: fields of 0 to 32 bits,
    single bits, raw bytes at and off byte boundaries, flushes."""
    ops = []
    for _ in range(n):
        kind = rng.integers(0, 10)
        if kind < 6:
            nbits = int(rng.integers(0, 33))
            ops.append(("write_bits", (int(rng.integers(0, 1 << 33)), nbits)))
        elif kind < 8:
            ops.append(("write_bit", (bool(rng.integers(0, 2)),)))
        elif kind == 8:
            raw = rng.integers(0, 256, int(rng.integers(0, 6))).astype(np.uint8).tobytes()
            ops.append(("write_bytes", (raw,)))
        else:
            ops.append(("flush", ()))
    return ops


def _write(cls, ops):
    w = cls()
    trace = []
    for name, args in ops:
        getattr(w, name)(*args)
        trace.append((len(w), w.bit_position))
    return w.finish(), trace


@pytest.mark.parametrize("seed", range(4))
def test_lsb_writer_equals_jax(seed):
    ops = _writes(np.random.default_rng(seed))
    assert _write(bits.BitWriterLsb, ops) == _write(jbits.BitWriterLsb, ops)


def _read(cls, data, ops):
    r = cls(data)
    out = []
    for name, args in ops:
        try:
            out.append((name, getattr(r, name)(*args), r.byte_position))
        except EOFError:
            out.append((name, "EOF", r.byte_position))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_lsb_reader_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    data = rng.integers(0, 256, 300).astype(np.uint8).tobytes()
    ops = []
    for _ in range(300):
        kind = rng.integers(0, 5)
        if kind == 0:
            ops.append(("read_bits", (int(rng.integers(0, 25)),)))
        elif kind == 1:
            ops.append(("peek_bits", (int(rng.integers(0, 25)),)))
        elif kind == 2:
            ops.append(("consume", (int(rng.integers(0, 9)),)))
        elif kind == 3:
            ops.append(("align_to_byte", ()))
        else:
            ops.append(("read_aligned_bytes", (int(rng.integers(0, 5)),)))
    got = _read(bits.BitReaderLsb, data, ops)
    assert got == _read(jbits.BitReaderLsb, data, ops)
    assert any(v == "EOF" for _, v, _ in got)  # the stream's end is part of the case


@pytest.mark.parametrize("seed", range(3))
def test_lsb_round_trip(seed):
    """What the writer packs, the reader reads back, field by field."""
    rng = np.random.default_rng(200 + seed)
    fields = [(int(rng.integers(0, 1 << 20)), int(rng.integers(1, 21))) for _ in range(500)]
    w = bits.BitWriterLsb()
    for v, n in fields:
        w.write_bits(v, n)
    data = w.finish()
    assert len(data) == -(-sum(n for _, n in fields) // 8)
    r = bits.BitReaderLsb(data)
    assert [r.read_bits(n) for _, n in fields] == [v & ((1 << n) - 1) for v, n in fields]


def test_lsb_reader_walks_a_stored_deflate_block():
    """Independent of both packages: the reader parses zlib's own stored
    block (BFINAL, BTYPE 00, LEN, NLEN, the bytes) and the writer rebuilds
    the raw stream byte for byte."""
    payload = bytes(range(256)) * 3
    raw = zlib.compress(payload, 0)[2:-4]  # the DEFLATE stream, no zlib wrapper
    r = bits.BitReaderLsb(raw)
    assert (r.read_bits(1), r.read_bits(2)) == (1, 0)
    r.align_to_byte()
    n = r.read_bits(16)
    assert (n, r.read_bits(16)) == (len(payload), len(payload) ^ 0xFFFF)
    assert r.read_aligned_bytes(n) == payload and r.byte_position == len(raw)
    w = bits.BitWriterLsb()
    w.write_bit(True)
    w.write_bits(0, 2)
    w.flush()
    w.write_bits(n, 16)
    w.write_bits(n ^ 0xFFFF, 16)
    w.write_bytes(payload)
    assert w.finish() == raw


def test_dct_matrix_is_the_jax_packages():
    assert dct.DCT_MATRIX.dtype == np.float32
    np.testing.assert_array_equal(dct.DCT_MATRIX, jdct.DCT_MATRIX)


@pytest.mark.parametrize("shape", [(8, 8), (5, 8, 8), (2, 3, 8, 8)])
def test_matrix_dct_and_inverse(rng, shape):
    """Within ``DCT_ATOL`` of the JAX package's and of a float64 product;
    the inverse undoes the forward transform within the same bound."""
    x = rng.integers(-128, 128, shape).astype(np.float32)
    fwd = dct.dct8x8_matmul(torch.from_numpy(x))
    inv = dct.idct8x8(torch.from_numpy(x))
    assert fwd.dtype == inv.dtype == torch.float32 and fwd.shape == inv.shape == shape
    d64 = dct.DCT_MATRIX.astype(np.float64)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jdct.dct8x8_matmul(jnp.asarray(x))), rtol=0,
                               atol=DCT_ATOL)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jdct.idct8x8(jnp.asarray(x))), rtol=0,
                               atol=DCT_ATOL)
    np.testing.assert_allclose(fwd.numpy(), d64 @ x @ d64.T, rtol=0, atol=DCT_ATOL)
    np.testing.assert_allclose(inv.numpy(), d64.T @ x @ d64, rtol=0, atol=DCT_ATOL)
    np.testing.assert_allclose(dct.idct8x8(fwd).numpy(), x, rtol=0, atol=DCT_ATOL)


def test_matrix_dct_takes_integer_blocks(rng):
    x = rng.integers(-128, 128, (4, 8, 8)).astype(np.int16)
    got = dct.dct8x8_matmul(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdct.dct8x8_matmul(jnp.asarray(x))), rtol=0,
                               atol=DCT_ATOL)


@pytest.mark.parametrize("src,dst", [(100, 37), (37, 100), (64, 64), (7, 1), (1, 5), (3220, 128)])
def test_lanczos_weight_matrix_equals_jax(src, dst):
    got = resize_kernels.lanczos_weight_matrix(src, dst)
    want = jresize.lanczos_weight_matrix(src, dst)
    assert got.dtype == np.float32 and got.shape == (dst, src)
    np.testing.assert_array_equal(got, want)
    starts, weights = resize_kernels.lanczos_taps(src, dst)
    for d in range(dst):  # each row is its window, in place
        k = min(weights.shape[1], src - starts[d])
        np.testing.assert_array_equal(got[d, starts[d]:starts[d] + k], weights[d, :k])


def test_lanczos_weight_matrix_leaves_the_cached_taps_alone():
    starts, weights = resize_kernels.lanczos_taps(50, 20)
    before = weights.copy()
    resize_kernels.lanczos_weight_matrix(50, 20)[:] = 7.0
    np.testing.assert_array_equal(resize_kernels.lanczos_taps(50, 20)[1], before)


@pytest.mark.parametrize("n,k", [(1, 1), (500, 16), (2000, 256)])
def test_perceptual_distance_equals_jax(rng, n, k):
    """Exact, broadcast over [n, 1, 4] x [1, k, 4], uint8 and int inputs,
    and its argmin (the first on ties) is the host library's nearest entry."""
    colors = rng.integers(0, 256, (n, 4)).astype(np.uint8)
    palette = rng.integers(0, 256, (k, 4)).astype(np.uint8)
    got = quantize.perceptual_distance_sq(colors[:, None], palette[None])
    assert got.dtype == np.int64 and got.shape == (n, k)
    np.testing.assert_array_equal(got, jquantize.perceptual_distance_sq(colors[:, None], palette[None]))
    np.testing.assert_array_equal(
        quantize.perceptual_distance_sq(colors.astype(np.int32), colors[::-1].astype(np.int64)),
        jquantize.perceptual_distance_sq(colors.astype(np.int32), colors[::-1].astype(np.int64)))
    np.testing.assert_array_equal(np.argmin(got, axis=1), native.native_nearest_palette(colors, palette))
