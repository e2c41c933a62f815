"""The port's device-assisted LZ77 route against the JAX package's, on the
CPU: ``ops/lz77_assist.py`` (``hash4``, ``batched_match_lengths``,
``chain_candidates``), ``adler32_device``, and the optimal DEFLATE and the
max-preset PNG batch under ``PIXO_TPU_LZ77=device``.

On the CPU each wrapper runs its plain version. Inputs come from a numpy
seed; the tolerance is exact equality, since all of it is integer. The JAX
``batched_match_lengths`` builds [pairs, 258] arrays on the CPU, so every
input that reaches it holds at most 20,000 bytes, as the JAX package's own
test does.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pixo_tpu import compress as jax_compress
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.compress.checksums import adler32_jnp
from pixo_tpu.ops import lz77_assist as jax_lz77
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.parallel.pipeline import encode_png_batch_sharded as jax_encode_batch

from chip_smoke import lz77_edge_cases
from pixo_tpu_torch import ColorType, PngOptions, encode_png_batch_sharded
from pixo_tpu_torch.compress import deflate
from pixo_tpu_torch.compress.checksums import adler32_device, adler32_plain
from pixo_tpu_torch.ops import lz77_assist

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain match lengths are many small steps: on one thread they leave
    the other test workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _residual(rng, n):
    """PNG-residual-like bytes: small signed deltas, most of them zero."""
    r = rng.integers(-3, 4, n).astype(np.int8).astype(np.uint8)
    r[rng.random(n) < 0.6] = 0
    return r


def _inputs():
    rng = np.random.default_rng(19)
    return {
        "repetitive": np.tile(rng.integers(0, 256, 37, dtype=np.uint8), 120),
        "all zero": np.zeros(3000, np.uint8),
        "noise": rng.integers(0, 256, 5000, dtype=np.uint8),
        "values 0-3": rng.integers(0, 4, 6000, dtype=np.uint8),
        "png residual": _residual(rng, 8000),
    }


INPUTS = _inputs()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


# ---------------------------------------------------------------- hash4

@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 257])
def test_hash4_equals_jax_with_its_tail(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    out = lz77_assist.hash4(_t(data))
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(jax_lz77.hash4(jnp.asarray(data))))


@pytest.mark.parametrize("name", list(INPUTS))
def test_hash4_equals_jax(name):
    data = INPUTS[name]
    assert np.array_equal(lz77_assist.hash4(_t(data)).numpy(), np.asarray(jax_lz77.hash4(jnp.asarray(data))))
    assert np.array_equal(lz77_assist.hash4(_t(data)).numpy(), jax_lz77.hash4_np(data))


def test_hash4_of_all_ones_needs_no_int64_overflow():
    data = np.full(8, 255, np.uint8)
    assert np.array_equal(lz77_assist.hash4(_t(data)).numpy(), jax_lz77.hash4_np(data))


# ------------------------------------------------------- match lengths

def _pairs(rng, n, m):
    """Pairs anywhere: cand > pos, pos >= n, negative indices, near the end."""
    pos = rng.integers(-3, n + 8, m)
    cand = rng.integers(-5, n + 10, m)
    tail = np.arange(max(n - 12, 0), n)
    pos[: len(tail)], cand[: len(tail)] = tail - 3, tail  # cand > pos near the end
    return pos.astype(np.int32), cand.astype(np.int32)


@pytest.mark.parametrize("max_len", [3, 258])
@pytest.mark.parametrize("name", ["values 0-3", "all zero", "repetitive"])
def test_match_lengths_equal_jax(name, max_len):
    data = INPUTS[name][:1500]
    pos, cand = _pairs(np.random.default_rng(max_len), len(data), 3000)
    out = lz77_assist.batched_match_lengths(_t(data), _t(pos), _t(cand), max_len=max_len)
    ref = jax_lz77.batched_match_lengths(jnp.asarray(data), jnp.asarray(pos), jnp.asarray(cand),
                                         max_len=max_len)
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_match_lengths_of_one_byte_and_past_the_end():
    data = np.array([7], np.uint8)
    pos = np.array([0, 0, 1, 5, -1], np.int32)
    cand = np.array([0, 3, 0, 0, 0], np.int32)
    out = lz77_assist.batched_match_lengths(_t(data), _t(pos), _t(cand))
    ref = jax_lz77.batched_match_lengths(jnp.asarray(data), jnp.asarray(pos), jnp.asarray(cand))
    assert np.array_equal(out.numpy(), np.asarray(ref))
    assert out.tolist()[:4] == [1, 1, 0, 0]


def test_match_lengths_exact_values():
    data = np.frombuffer(b"abcabcabcXabc", np.uint8)
    out = lz77_assist.batched_match_lengths(_t(data), _t(np.array([3, 10], np.int32)),
                                            _t(np.array([0, 0], np.int32)))
    assert out.tolist() == [6, 3]


def test_plain_match_lengths_in_steps(monkeypatch):
    """The plain version takes its pairs ``PLAIN_PAIRS`` at a time."""
    data = INPUTS["values 0-3"][:1000]
    pos, cand = _pairs(np.random.default_rng(3), len(data), 500)
    whole = lz77_assist.batched_match_lengths_plain(_t(data), _t(pos), _t(cand))
    monkeypatch.setattr(lz77_assist, "PLAIN_PAIRS", 7)
    assert torch.equal(lz77_assist.batched_match_lengths_plain(_t(data), _t(pos), _t(cand)), whole)


# ----------------------------------------------------- chain candidates

@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("name", list(INPUTS))
def test_chain_candidates_equal_jax(name, k):
    data = INPUTS[name]
    cand, lens = lz77_assist.chain_candidates(_t(data), k=k)
    ref_cand, ref_lens = jax_lz77.chain_candidates(jnp.asarray(data), k=k)
    assert cand.dtype == lens.dtype == torch.int32 and tuple(cand.shape) == (len(data), k)
    assert np.array_equal(cand.numpy(), np.asarray(ref_cand))
    assert np.array_equal(lens.numpy(), np.asarray(ref_lens))


EDGES = lz77_edge_cases(np.random.default_rng(20))


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("name", list(EDGES))
def test_chain_candidates_at_the_kernels_tile_edges_equal_jax(name, k):
    """``chip_smoke.lz77_edge_cases``: a bucket across the rows' tiles,
    buckets of k and k + 1, zero runs ending at and near the end, runs of
    one byte, n at a multiple of the rows' tile and a byte either side."""
    data = EDGES[name]
    cand, lens = lz77_assist.chain_candidates(_t(data), k=k)
    ref_cand, ref_lens = jax_lz77.chain_candidates(jnp.asarray(data), k=k)
    assert np.array_equal(cand.numpy(), np.asarray(ref_cand))
    assert np.array_equal(lens.numpy(), np.asarray(ref_lens))


@pytest.mark.parametrize("n", range(6))
def test_chain_candidates_of_tiny_inputs(n):
    for data in (np.zeros(n, np.uint8), np.arange(n, dtype=np.uint8)):
        for k in (1, 4, 16):
            cand, lens = lz77_assist.chain_candidates(_t(data), k=k)
            ref_cand, ref_lens = jax_lz77.chain_candidates(jnp.asarray(data), k=k)
            assert np.array_equal(cand.numpy(), np.asarray(ref_cand).reshape(n, k))
            assert np.array_equal(lens.numpy(), np.asarray(ref_lens).reshape(n, k))
            if n <= 4:
                assert (cand == -1).all() and (lens == 0).all()


def test_chain_candidates_equal_the_chain_walk():
    """Against the JAX package's literal walk of the host's hash chain."""
    data = np.random.default_rng(5).integers(0, 6, 3000, dtype=np.uint8)
    cand, lens = lz77_assist.chain_candidates(_t(data), k=4)
    ref_cand, ref_lens = jax_lz77.chain_candidates_np(data, k=4)
    assert np.array_equal(cand.numpy(), ref_cand) and np.array_equal(lens.numpy(), ref_lens)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        lz77_assist.hash4(torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        lz77_assist.chain_candidates(torch.zeros((2, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        lz77_assist.chain_candidates(torch.zeros(8, dtype=torch.uint8), k=0)
    with pytest.raises(ValueError):
        lz77_assist.batched_match_lengths(torch.zeros(8, dtype=torch.uint8),
                                          torch.zeros(3, dtype=torch.int32),
                                          torch.zeros(4, dtype=torch.int32))


def test_launch_count_exact_under_threads():
    """``count_launch``, which every wrapper here calls after its launch,
    loses no update with 16 threads switching every microsecond, even where
    the add yields between the read and the write (an unlocked ``+=`` keeps
    some 500 of these 8,000)."""
    import sys
    import threading
    import time

    from pixo_tpu_torch.ops.kernels import count_launch

    class Yielding(int):
        def __add__(self, other):
            time.sleep(0)
            return Yielding(int(self) + other)

    def wrapper():
        pass

    wrapper.launches = Yielding(0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(wrapper) for _ in range(500)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 500


# ---------------------------------------------------------------- Adler-32

ADLER_SIZES = [0, 1, 15, 16, 17, 2047, 2048, 2049, 4095, 4096, 4097, 5552, 5553, 8207, 1 << 24]


@pytest.mark.parametrize("start", [1, 0x12345678])
@pytest.mark.parametrize("n", ADLER_SIZES)
def test_adler32_device_equals_jax_and_zlib(n, start):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8)
    if n > 6000:
        data[::3] = 255  # the largest weighted sums a chunk can have, on a third of the bytes
    got = adler32_device(_t(data), start)
    assert got == int(adler32_jnp(jnp.asarray(data), start)) == zlib.adler32(data.tobytes(), start)


def test_adler32_plain_of_all_255s():
    data = np.full(3 * 2048 + 5, 255, np.uint8)
    assert adler32_plain(_t(data)) == zlib.adler32(data.tobytes())


# ------------------------------------------------------- the route

@pytest.mark.parametrize("parity", ["0", "1"])
@pytest.mark.parametrize("iterations", [5, 2])
@pytest.mark.parametrize("name", ["png residual", "repetitive", "noise"])
def test_deflate_route_equals_jax_and_the_host_route(name, iterations, parity, monkeypatch):
    data = INPUTS[name].tobytes()
    monkeypatch.setenv("PIXO_TPU_DEFLATE_PARITY", parity)
    monkeypatch.delenv("PIXO_TPU_LZ77", raising=False)
    host = deflate.deflate_optimal_zlib(data, iterations)
    monkeypatch.setenv("PIXO_TPU_LZ77", "device")
    calls = []
    real = lz77_assist.chain_candidates
    monkeypatch.setattr(lz77_assist, "chain_candidates", lambda t, k: calls.append(t.device) or real(t, k=k))
    out = deflate.deflate_optimal_zlib(data, iterations, device="cpu")
    assert out == host == jax_compress.deflate_optimal_zlib(data, iterations)
    assert zlib.decompress(out) == data
    # parity mode is the reference's own parse, before the route
    assert calls == ([] if parity == "1" else [torch.device("cpu")])


def test_deflate_route_reads_the_tables(monkeypatch):
    """Tables with no candidate change the stream (the host then stops each
    walk at once): the route does hand its tables to the host parse."""
    data = INPUTS["png residual"].tobytes()
    monkeypatch.delenv("PIXO_TPU_DEFLATE_PARITY", raising=False)
    monkeypatch.setenv("PIXO_TPU_LZ77", "device")
    real = lz77_assist.chain_candidates

    def empty(t, k):
        cand, lens = real(t, k=k)
        return torch.full_like(cand, -1), torch.zeros_like(lens)

    good = deflate.deflate_optimal_zlib(data, 2, device="cpu")
    monkeypatch.setattr(lz77_assist, "chain_candidates", empty)
    worse = deflate.deflate_optimal_zlib(data, 2, device="cpu")
    assert worse != good and zlib.decompress(worse) == data


def test_png_max_batch_under_the_route_equals_jax(monkeypatch):
    """The max preset's batch (Bigrams, then the optimal DEFLATE of each
    image under the route) at 65x64 RGB: 12,544 filtered bytes an image."""
    monkeypatch.delenv("PIXO_TPU_DEFLATE_PARITY", raising=False)
    monkeypatch.setenv("PIXO_TPU_LZ77", "device")
    rng = np.random.default_rng(23)
    base = rng.integers(0, 256, (1, 64, 65, 3), dtype=np.uint8)
    imgs = np.concatenate([base, np.clip(base.astype(int) + rng.integers(-2, 3, base.shape), 0, 255)]
                          ).astype(np.uint8)
    opts = PngOptions.max(65, 64).replace(color_type=ColorType.RGB)
    jopts = JaxPngOptions.max(65, 64).replace(color_type=JaxColorType.RGB)
    outs = encode_png_batch_sharded(imgs, opts, device="cpu", host_workers=1)
    assert outs == jax_encode_batch(imgs, jopts, host_workers=1)
    monkeypatch.delenv("PIXO_TPU_LZ77")
    assert outs == encode_png_batch_sharded(imgs, opts, device="cpu", host_workers=1)
