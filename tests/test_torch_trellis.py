"""The port's trellis quantizer and ``max`` JPEG preset against the JAX
package, on the CPU. Every comparison is exact (tolerance 0).

- The DP: the port's host-library binding and its plain batched version
  (``ops/trellis_device.py``, the plain version of the trellis kernel)
  against the JAX package's Python mirror and host library, on random blocks, the JAX package's extremes and the built
  ties and boundaries of ``chip_smoke.trellis_edge_blocks`` under every MCU
  pattern; the plain version also against the JAX package's jit
  ``trellis_quantize_batch_device``. Where the JAX package's tiers disagree
  (zero children of one run, the DC's f32 rounding), the port follows its
  host library, whose bytes ``pixo_tpu.jpeg.encode`` emits: one test each.
- The front end: ``ops/kernels.py::dct_zz_plain`` (the plain version of the
  ``dct_zz`` kernel) and the port's ``native_jpeg_dct_zz`` against the JAX
  package's ``native_jpeg_dct_zz``, bit for bit, in every mode at odd
  sizes. Not against the JAX package's jit ``_device_dct_zz`` on XLA:CPU,
  which contracts multiply-adds into FMAs.
- The slice: ``jpeg.encode``, ``jpeg.encode_batch`` and
  ``encode_jpeg_batch_sharded``, all with ``device="cpu"``, byte for byte
  against the JAX package's ``jpeg.encode``; and the batch route's choice of
  trellis by where the DCT lies.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.jpeg.encoder import encode as jax_encode
from pixo_tpu.jpeg.trellis import trellis_quantize_block as jax_trellis_block
from pixo_tpu.native import native_jpeg_dct_zz as jax_native_dct_zz
from pixo_tpu.native import native_trellis_quantize as jax_native_trellis
from pixo_tpu.ops.trellis_device import trellis_quantize_batch_device
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import Subsampling as JaxSubsampling

from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, encode_jpeg_batch_sharded, jpeg
from pixo_tpu_torch.jpeg.tables import ZIGZAG, QuantizationTables
from pixo_tpu_torch.native import native_jpeg_dct_zz, native_trellis_quantize
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.ops.trellis_device import RATE_LUT, _step, block_tables, trellis_quantize_batch_plain
from pixo_tpu_torch.parallel import pipeline

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import (  # noqa: E402
    TRELLIS_PATTERNS,
    read_png,
    trellis_edge_blocks,
    trellis_mixed_blocks,
    trellis_random_blocks,
)

jax.config.update("jax_platforms", "cpu")

MODES = ["gray", "444", "420", "422"]
EDGE_LABELS = [c[0] for c in trellis_edge_blocks(np.random.default_rng(5))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The plain DP is some 70 small operations a step on [B, 8..12] tensors:
    on one thread it runs as fast as on many and leaves the other test
    workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tables(pattern, lum, chrom, n):
    return block_tables(lum, chrom, pattern, n, "cpu").numpy()


def _plain(dct, lum, chrom, pattern):
    return trellis_quantize_batch_plain(torch.from_numpy(dct), lum, chrom, pattern).numpy()


def _mirror(block_fn, dct, q):
    return np.stack([block_fn(dct[i], q[i]) for i in range(dct.shape[0])])


@pytest.mark.parametrize("case", range(len(EDGE_LABELS)), ids=EDGE_LABELS)
def test_dp_edge_blocks_equal_jax_package(case):
    """Ties, boundaries, ZRL runs, DC edges and extremes, each pattern with
    distinct tables: the plain version and the port's host library against
    the JAX package's host library and mirror."""
    _, dct, lum, chrom, pattern = trellis_edge_blocks(np.random.default_rng(5))[case]
    want = jax_native_trellis(dct, pattern, lum, chrom)
    q = _tables(pattern, lum, chrom, dct.shape[0])
    np.testing.assert_array_equal(_mirror(jax_trellis_block, dct, q), want)
    np.testing.assert_array_equal(native_trellis_quantize(dct, pattern, lum, chrom), want)
    np.testing.assert_array_equal(_plain(dct, lum, chrom, pattern), want)


@pytest.mark.parametrize("pname", list(TRELLIS_PATTERNS))
def test_dp_random_blocks_equal_jax_package(pname):
    """3000 random blocks through the host libraries (8 threads and 1) and
    the plain version; 200 of them through the JAX package's mirror."""
    rng = np.random.default_rng(40)
    pattern = TRELLIS_PATTERNS[pname]
    dct = trellis_random_blocks(rng, 3000)
    lum, chrom = (rng.integers(1, 80, 64).astype(np.float32) for _ in range(2))
    want = jax_native_trellis(dct, pattern, lum, chrom)
    np.testing.assert_array_equal(native_trellis_quantize(dct, pattern, lum, chrom), want)
    np.testing.assert_array_equal(native_trellis_quantize(dct, pattern, lum, chrom, nthreads=1), want)
    np.testing.assert_array_equal(_plain(dct, lum, chrom, pattern), want)
    q = _tables(pattern, lum, chrom, 200)
    np.testing.assert_array_equal(_mirror(jax_trellis_block, dct[:200], q), want[:200])


def test_plain_equals_jax_device_random(rng):
    """The JAX package's own random case (``test_kernel_equality.py``): 48
    blocks, per-block tables, against its jit DP on XLA:CPU."""
    dct = rng.normal(0, 80, (48, 64)).astype(np.float32)
    dct[:, 0] = rng.normal(0, 500, 48).astype(np.float32)
    dct[rng.random((48, 64)) < 0.5] = 0.0
    lum, chrom = (rng.integers(1, 80, 64).astype(np.float32) for _ in range(2))
    pattern = (0, 1, 2)
    q = _tables(pattern, lum, chrom, 48)
    want = np.asarray(trellis_quantize_batch_device(dct, q))
    np.testing.assert_array_equal(_plain(dct, lum, chrom, pattern), want)


def test_plain_equals_jax_device_extremes(rng):
    """The JAX package's extremes: an all-zero block, a dense one, a lone
    tail coefficient and one at a rounding boundary, q = 16."""
    q16 = np.full(64, 16.0, np.float32)
    dct = np.zeros((4, 64), np.float32)
    dct[1] = rng.normal(0, 400, 64).astype(np.float32)
    dct[2, 63] = 100.0
    dct[3, 1] = 8.0
    want = np.asarray(trellis_quantize_batch_device(dct, np.tile(q16, (4, 1))))
    np.testing.assert_array_equal(_plain(dct, q16, q16, (0,)), want)


def test_dc_rounds_as_the_host_library():
    """At dct / q = +-0.49999997 the f32 sum x + 0.5 rounds up to 1: both host
    tiers of the JAX package (its library and its mirror) give +-1 there and
    its jit DP 0. The port follows the host tiers, whose bytes
    ``pixo_tpu.jpeg.encode`` emits."""
    x = np.float32(0.49999997)
    dct = np.zeros((2, 64), np.float32)
    dct[0, 0], dct[1, 0] = x, -x
    q = np.ones(64, np.float32)
    got = _plain(dct, q, q, (0,))
    np.testing.assert_array_equal(got[:, 0], [1, -1])
    np.testing.assert_array_equal(got, jax_native_trellis(dct, (0,), q, q))
    np.testing.assert_array_equal(got[0], jax_trellis_block(dct[0], q))


# A luma block of a noisy gradient's DCT (the dct_zz chain) where the DP has
# two states of one run: the host library keeps both zero children, the JAX
# package's mirror and jit DP merge them. f32 bits, zigzag order.
SPLIT_RUN_BLOCK = """
447bf802 c0afbe86 c0a86b68 bfb2de81 c06122ff becd5b9a 3e2830a7 bf1bce92 3f891332 bfeddc07 3f90004f
3f032d73 3fc0554a 403659aa bdfffffd 3e7f628c 4019f4d2 4010396a be097806 3e906748 3f8850e4 3fc351e8
3f99a0df c055d099 bfae6db7 3fe0e1fb bfd07a9f 4051cafd 3f540f8d 405b1af0 bfbbaa5f 3e9bdd55 3eeaf242
bfc928a3 3fcd6462 40166e69 3fb5930f bfdb5053 3ee8656b 40a40001 3f30fb57 3fc4afb4 4069fbb4 3f1eb3db
3fa7d7e9 4024a13b 40a9eeec bffdcb2f bfd9abae bf44883c 3fa69fed 4094579b 4003dc56 c01bad56 3e32ae36
3fbe1a60 3fb3e285 3ef6e959 bff592e1 bfc05545 c025d540 c08dcbc0 c05676d1 c030555a"""


def test_zero_children_of_one_run_as_the_host_library():
    """Where two states reach one run through a zero, the port keeps both
    children, as the host library does (whose bytes ``pixo_tpu.jpeg.encode``
    emits); the JAX package's mirror and its jit DP merge them into the cheaper one, and give ACs 13 and 16 the value 1
    where the library gives 0."""
    dct = np.array([int(h, 16) for h in SPLIT_RUN_BLOCK.split()], np.uint32).view(np.float32)[None]
    q = QuantizationTables(90).luminance_table[ZIGZAG].astype(np.float32)
    want = jax_native_trellis(dct, (0,), q, q)
    np.testing.assert_array_equal(_plain(dct, q, q, (0,)), want)
    np.testing.assert_array_equal(native_trellis_quantize(dct, (0,), q, q), want)
    merged = jax_trellis_block(dct[0], q)
    np.testing.assert_array_equal(np.asarray(trellis_quantize_batch_device(dct, q[None]))[0], merged)
    assert np.flatnonzero(merged != want[0]).tolist() == [13, 16]
    assert (merged[[13, 16]].tolist(), want[0, [13, 16]].tolist()) == ([1, 1], [0, 0])


def test_all_zero_exit_is_what_the_dp_gives():
    """The kernel and the host library skip the DP where every AC has
    2|coef| < q (the AC is then all zero); the plain version runs the DP,
    and gives zero there too, up to the boundary."""
    rng = np.random.default_rng(41)
    lum = rng.integers(1, 100, 64).astype(np.float32)
    q = np.tile(lum, (2000, 1))
    dct = (rng.uniform(-1, 1, (2000, 64)) * q / 2).astype(np.float32)
    top = np.nextafter(q / 2, np.float32(0)) * np.sign(dct)  # the largest |coef| below the boundary
    dct = np.where(np.abs(dct) * 2 < q, dct, top).astype(np.float32)
    dct[::2, 1:] = top[::2, 1:]
    dct[:, 0] = rng.normal(0, 300, 2000)
    got = _plain(dct, lum, lum, (0,))
    assert not got[:, 1:].any()


def test_rate_lut_is_the_host_librarys():
    """The LUT (the JAX package's f64 estimate, rounded) equals the host
    library's f32 formula ((3 + run * 0.5) + size * 0.3, then + size)."""
    f = np.float32
    special = {0x00: 4.0, 0x01: 2.0, 0x02: 2.5, 0x03: 3.0, 0x04: 4.0, 0x11: 3.0, 0x12: 4.0,
               0x21: 4.0, 0xF0: 10.0}
    for rs in range(256):
        run, size = rs >> 4, rs & 15
        est = f(special[rs]) if rs in special else f(f(f(3.0) + f(f(run) * f(0.5))) + f(f(size) * f(0.3)))
        assert f(est + f(size)) == RATE_LUT[rs]


def _merge_premise(dct, lum, chrom, pattern):
    """Runs the plain DP's steps on [N, 64] ``dct`` and checks, before every
    step, what the trellis kernel's merge by counting rests on: the valid
    states are a prefix of the 8 slots, sorted by (cost, slot); the zero
    children of the parents without a ZRL (run < 15), in parent order, are
    in order of cost, and so are those of the parents with one (run 15, +10:
    both are sorted parents plus one constant, so a ZRL child only moves
    later). Returns (the block-steps with a ZRL, the most states of run 15
    in one step)."""
    d = torch.from_numpy(dct)
    b = d.shape[0]
    q = block_tables(lum, chrom, pattern, b, "cpu")
    lam, lut = torch.tensor(1.0), torch.as_tensor(RATE_LUT)
    cost = torch.full((b, 8), float("inf"))
    cost[:, 0] = 0.0
    run = torch.zeros((b, 8), dtype=torch.int64)
    zrl_steps, most = 0, 0
    for zz in range(1, 64):
        valid = torch.isfinite(cost)
        assert not (valid[:, 1:] & ~valid[:, :-1]).any(), f"step {zz}: the valid states are no prefix"
        pairs = valid[:, 1:]
        assert not (pairs & (cost[:, 1:] < cost[:, :-1])).any(), f"step {zz}: the states are not sorted"
        coef = d[:, zz]
        zrl = valid & (run == 15)
        zc = (cost + torch.where(zrl, 10.0, 0.0)) + lam * (coef * coef)[:, None]
        for cls in (zrl, valid & ~zrl):  # each class in parent order: never a cheaper child later
            held = torch.where(cls, zc, torch.tensor(float("-inf")))
            assert (held.cummax(dim=1).values <= torch.where(cls, zc, torch.tensor(float("inf")))).all(), \
                f"step {zz}: zero children out of order"
        zrl_steps += int(zrl.any(dim=1).sum())
        most = max(most, int(zrl.sum(dim=1).max()))
        cost, run, _, _ = _step(cost, run, coef, q[:, zz], lam, lut)
    return zrl_steps, most


def _corpus_dct(name: str, quality: int):
    img = read_png(str(Path(__file__).resolve().parent / "fixtures" / f"corpus_{name}_512.png"))[..., :3]
    dct = kernels.dct_zz_plain(torch.from_numpy(np.ascontiguousarray(img[None])), "420").reshape(-1, 64)
    qt = QuantizationTables(quality)
    return (dct.numpy(), qt.luminance_table[ZIGZAG].astype(np.float32),
            qt.chrominance_table[ZIGZAG].astype(np.float32), TRELLIS_PATTERNS["420"])


MERGE_PREMISE_SETS = {
    "edge blocks": lambda: trellis_edge_blocks(np.random.default_rng(5)),
    "random blocks": lambda: [("random", trellis_random_blocks(np.random.default_rng(40), 3000),
                               *(np.random.default_rng(41).integers(1, 80, (2, 64)).astype(np.float32)),
                               TRELLIS_PATTERNS["420"])],
    "mixed warps": lambda: [("mixed", *trellis_mixed_blocks(np.random.default_rng(129), 1000))],
    "corpus browser q85": lambda: [("browser", *_corpus_dct("browser", 85))],
    "corpus browser q50": lambda: [("browser", *_corpus_dct("browser", 50))],
    "corpus rocket q85": lambda: [("rocket", *_corpus_dct("rocket", 85))],
    "corpus rocket q50": lambda: [("rocket", *_corpus_dct("rocket", 50))],
}


@pytest.mark.parametrize("name", list(MERGE_PREMISE_SETS))
def test_merge_premise_holds_after_every_step(name):
    """The trellis kernel cannot run here; its merge's premise can, on the
    plain DP (see ``_merge_premise``): on every pattern of the edge blocks,
    random blocks, the kernel tests' mixed warps and the DCT of two corpus
    fixtures at q85 and q50. Each set has steps with a ZRL, so the premise
    is tested where the zero children are two lists."""
    zrl_steps = 0
    for _, dct, lum, chrom, pattern in MERGE_PREMISE_SETS[name]():
        zrl_steps += _merge_premise(dct, lum, chrom, pattern)[0]
    assert zrl_steps > 0


@pytest.mark.parametrize("name", ["edge blocks", "mixed warps", "corpus rocket q50"])
def test_more_than_three_states_share_run_15(name):
    """The corpus at q85 has at most 3 states of run 15 in a step, but these
    sets have more (5, 8 and 4): the kernel's count of out-of-order zero
    children takes any number of ZRL children, not a fixed few."""
    assert max(_merge_premise(*case[1:])[1] for case in MERGE_PREMISE_SETS[name]()) > 3


def test_trellis_wrapper_on_cpu_equals_host_library(rng):
    """``ops/kernels.py::trellis_quantize`` on a CPU tensor (its plain
    version, no launch) against the port's host library."""
    dct = trellis_random_blocks(rng, 600)
    lum, chrom = (rng.integers(1, 60, 64).astype(np.float32) for _ in range(2))
    pattern = TRELLIS_PATTERNS["422"]
    host = native_trellis_quantize(dct, pattern, lum, chrom)
    before = kernels.trellis_quantize.launches
    np.testing.assert_array_equal(
        kernels.trellis_quantize(torch.from_numpy(dct), lum, chrom, pattern).numpy(), host)
    assert kernels.trellis_quantize.launches == before  # the plain version launches nothing


def test_trellis_wrapper_refuses_what_the_kernel_does_not_take():
    q = np.ones(64, np.float32)
    with pytest.raises(TypeError):
        kernels.trellis_quantize(torch.zeros((4, 64), dtype=torch.float64), q, q, (0,))
    with pytest.raises(ValueError, match=r"\[N, 64\]"):
        kernels.trellis_quantize(torch.zeros((4, 8, 8)), q, q, (0,))
    with pytest.raises(ValueError, match="pattern"):
        kernels.trellis_quantize(torch.zeros((4, 64)), q, q, (0,) * 9)


@pytest.mark.parametrize("size", [(8, 8), (17, 23), (33, 200), (61, 47)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", MODES)
def test_dct_zz_equals_host_library(rng, mode, size):
    """The plain ``dct_zz`` chain, the wrapper's CPU route and the port's host
    binding against the JAX package's host library, bit for bit."""
    h, w = size
    imgs = rng.integers(0, 256, (2, h, w) if mode == "gray" else (2, h, w, 3), dtype=np.uint8)
    got = kernels.dct_zz_plain(torch.from_numpy(imgs), mode).numpy()
    assert got.dtype == np.float32 and got.shape[2] == 64
    assert np.array_equal(kernels.dct_zz(torch.from_numpy(imgs), mode).numpy().view(np.int32),
                          got.view(np.int32))
    for i in range(2):
        want = jax_native_dct_zz(imgs[i], mode)
        assert np.array_equal(got[i].view(np.int32), want.view(np.int32))
        assert np.array_equal(native_jpeg_dct_zz(imgs[i], mode).view(np.int32), want.view(np.int32))


def _jax_options(o: JpegOptions) -> JaxJpegOptions:
    return JaxJpegOptions(
        width=o.width, height=o.height, quality=o.quality,
        color_type=JaxColorType(int(o.color_type)),
        subsampling=JaxSubsampling(o.subsampling.value),
        restart_interval=o.restart_interval,
        optimize_huffman=o.optimize_huffman, optimal_huffman=o.optimal_huffman,
        progressive=o.progressive, progressive_sa=o.progressive_sa,
        trellis_quant=o.trellis_quant,
    )


def _images(rng, gray: bool, h: int, w: int, b: int = 2):
    """A gradient with noise ([b, h, w] for gray): the DP runs on most
    blocks, and some take the all-zero exit."""
    base = np.add.outer(np.arange(h) * 3, np.arange(w) * 2)[..., None]
    imgs = (base + rng.normal(0, 14, (b, h, w, 3))).clip(0, 255).astype(np.uint8)
    return np.ascontiguousarray(imgs[..., 0]) if gray else imgs


def _all_entries_equal_jax(imgs, opts):
    ref = [jax_encode(im, _jax_options(opts)) for im in imgs]
    assert [jpeg.encode(im, opts, device="cpu") for im in imgs] == ref
    assert jpeg.encode_batch(imgs, opts, device="cpu") == ref
    assert encode_jpeg_batch_sharded(imgs, opts, device="cpu", host_workers=2) == ref
    return ref


MAX_CASES = {
    "max rgb": dict(),
    "max gray": dict(color_type=ColorType.GRAY),
    "444": dict(subsampling=Subsampling.S444),
    "422": dict(subsampling=Subsampling.S422),
    "optimal": dict(optimal_huffman=True),
    "no SA": dict(progressive_sa=False),
    "restart 2": dict(restart_interval=2),
    "q30": dict(quality=30),
    "q98 gray 422": dict(quality=98, color_type=ColorType.GRAY, subsampling=Subsampling.S422),
}


@pytest.mark.parametrize("size", [(24, 24), (40, 56), (37, 61)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(MAX_CASES))
def test_max_preset_bytes_equal_jax_package(rng, case, size):
    """The ``max`` preset (progressive with SA, optimized tables, trellis)
    and its variants, under 2048 blocks: the SA fallback runs too."""
    h, w = size
    opts = JpegOptions.max(w, h, 85).replace(**MAX_CASES[case])
    outs = _all_entries_equal_jax(_images(rng, opts.color_type == ColorType.GRAY, h, w), opts)
    assert all(o[:2] == b"\xff\xd8" and o[-2:] == b"\xff\xd9" and b"\xff\xc2" in o for o in outs)


def test_max_preset_over_2048_blocks_equals_jax_package(rng):
    """400x304 at 4:4:4 (5,700 blocks): no SA fallback, and the host
    library's DP on 8 threads."""
    opts = JpegOptions.max(400, 304, 85).replace(subsampling=Subsampling.S444)
    _all_entries_equal_jax(_images(rng, False, 304, 400, b=1), opts)


@pytest.mark.parametrize("kw", [dict(), dict(optimize_huffman=True), dict(restart_interval=3)],
                         ids=["standard", "optimized", "restart 3"])
def test_baseline_with_trellis_is_baseline(rng, kw):
    """A baseline encode ignores ``trellis_quant`` (the reference's baseline
    scan never reads it): the same bytes as without it, and as the JAX
    package's."""
    opts = JpegOptions(width=40, height=32, quality=85, subsampling=Subsampling.S420,
                       trellis_quant=True, **kw)
    imgs = _images(rng, False, 32, 40)
    ref = _all_entries_equal_jax(imgs, opts)
    assert jpeg.encode_batch(imgs, opts.replace(trellis_quant=False), device="cpu") == ref


def test_batch_trellis_is_computed_once(rng, monkeypatch):
    """With ``device="cpu"`` the batch route runs the host library's DP once
    for the whole batch, on ``host_workers`` threads, with no
    plain-quantized coefficients and no trellis kernel wrapper."""
    imgs = _images(rng, False, 24, 24, b=3)
    opts = JpegOptions.max(24, 24, 85)
    calls = []
    real = pipeline.native_trellis_quantize
    monkeypatch.setattr(pipeline, "native_trellis_quantize",
                        lambda dct, *a, **k: calls.append((dct.shape, k)) or real(dct, *a, **k))
    monkeypatch.setattr(pipeline, "trellis_quantize",
                        lambda *a, **k: pytest.fail("the CPU route called the kernel wrapper"))
    monkeypatch.setattr(pipeline, "jpeg_coeffs_sharded",
                        lambda *a, **k: pytest.fail("the max route computed plain coefficients"))
    outs = encode_jpeg_batch_sharded(imgs, opts, device="cpu", host_workers=3)
    assert calls == [((3 * 24, 64), {"nthreads": 3})]
    assert outs == [jax_encode(im, _jax_options(opts)) for im in imgs]


def test_batch_trellis_off_the_cpu_takes_the_kernel(rng, monkeypatch):
    """Off the CPU the DCT stays where it was made and the batch's trellis
    is one call of the kernel wrapper, never the host library's DP: here on
    PyTorch's ``meta`` device, with the wrapper standing in for the kernel."""
    imgs = _images(rng, False, 24, 24, b=2)
    opts = JpegOptions.max(24, 24, 85)
    n = pipeline.jenc._pattern(opts)[0]
    dct = kernels.dct_zz_plain(torch.from_numpy(imgs), "420")
    zz = native_trellis_quantize(dct.reshape(-1, 64).numpy(), pipeline.jenc._pattern(opts)[1],
                                 *pipeline.jenc.zigzag_tables(QuantizationTables(85)))
    calls = []
    monkeypatch.setattr(pipeline, "dct_zz", lambda x, mode: torch.empty((x.shape[0], n, 64), device=x.device))
    monkeypatch.setattr(pipeline, "native_trellis_quantize",
                        lambda *a, **k: pytest.fail("the DCT went back to the host library's DP"))
    monkeypatch.setattr(pipeline, "trellis_quantize",
                        lambda flat, *a: calls.append((flat.device.type, tuple(flat.shape))) or torch.from_numpy(zz))
    got = pipeline.trellis_coeffs_sharded(imgs, opts, device="meta")
    assert calls == [("meta", (2 * n, 64))]
    np.testing.assert_array_equal(got, zz.reshape(2, n, 64))
