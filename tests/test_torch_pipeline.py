"""The port's batched baseline JPEG encode against the JAX package, on the CPU.

Each case encodes the same seeded batch with the port
(``encode_jpeg_batch_sharded(..., device="cpu")``) and with the JAX package
(its ``jpeg.encode`` per image and its ``encode_jpeg_batch_sharded`` on the
CPU mesh), and holds the bytes equal. The cases mirror
tests/test_native.py:307-365: the smooth gradient, noise that escalates the
compaction cap to 16 or 32, noise that falls back to the dense stream, and
restart markers, gray, 4:4:4 and 4:2:2.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.jpeg.encoder import encode as jax_encode
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import Subsampling as JaxSubsampling
from pixo_tpu.parallel.pipeline import encode_jpeg_batch_sharded as jax_encode_batch

from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, encode_jpeg_batch_sharded, errors
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.parallel import pipeline
from pixo_tpu_torch.utils import build
from pixo_tpu_torch.utils.synthetic import synth_gradient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

jax.config.update("jax_platforms", "cpu")


def _jax_options(o: JpegOptions) -> JaxJpegOptions:
    return JaxJpegOptions(
        width=o.width, height=o.height, quality=o.quality,
        color_type=JaxColorType(int(o.color_type)),
        subsampling=JaxSubsampling(o.subsampling.value),
        restart_interval=o.restart_interval,
    )


def _noisy(rng, sigma, b=2, h=32, w=32):
    base = np.add.outer(np.arange(h) * 4, np.arange(w) * 4)[..., None]
    return (base + rng.normal(0, sigma, (b, h, w, 3))).clip(0, 255).astype(np.uint8)


def _tier(imgs, opts):
    zz = pipeline.jpeg_coeffs_sharded(imgs, opts, device="cpu")
    state = pipeline._fetch_compacted(zz, kernels.compact_padded(zz, 8))
    return state[3].shape[-1] if state[0] == "padded" else "dense"


CASES = {
    "gradient_420_q85": (
        lambda rng: np.stack([synth_gradient(32, 32)] * 2),
        JpegOptions(width=32, height=32, quality=85, subsampling=Subsampling.S420), 8),
    "light_noise_cap16": (
        lambda rng: _noisy(rng, 8),
        JpegOptions(width=32, height=32, quality=75), 16),
    "mid_noise_cap32": (
        lambda rng: _noisy(rng, 6),
        JpegOptions(width=32, height=32, quality=90), 32),
    "uniform_noise_dense_q98": (
        lambda rng: rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
        JpegOptions(width=32, height=32, quality=98), "dense"),
    "restart_4_420": (
        lambda rng: _noisy(rng, 3, h=40, w=48),
        JpegOptions(width=48, height=40, quality=85, subsampling=Subsampling.S420,
                    restart_interval=4), None),
    "gray_48x40": (
        lambda rng: _noisy(rng, 5, h=40, w=48)[..., 0].copy(),
        JpegOptions(width=48, height=40, quality=85, color_type=ColorType.GRAY), None),
    "rgb_444_48x40": (
        lambda rng: _noisy(rng, 5, h=40, w=48),
        JpegOptions(width=48, height=40, quality=85, subsampling=Subsampling.S444), None),
    "rgb_422_48x40_restart_2": (
        lambda rng: _noisy(rng, 5, h=40, w=48),
        JpegOptions(width=48, height=40, quality=70, subsampling=Subsampling.S422,
                    restart_interval=2), None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_batch_bytes_equal_jax_package(rng, case):
    make, opts, tier = CASES[case]
    imgs = make(rng)
    if tier is not None:
        assert _tier(imgs, opts) == tier
    outs = encode_jpeg_batch_sharded(imgs, opts, device="cpu")
    jopts = _jax_options(opts)
    assert outs == jax_encode_batch(imgs, jopts)
    for img, out in zip(imgs, outs):
        assert out == jax_encode(img, jopts)


def test_accepts_a_cpu_tensor_and_few_workers(rng):
    imgs = _noisy(rng, 8, b=3)
    opts = JpegOptions(width=32, height=32, quality=75)
    assert encode_jpeg_batch_sharded(torch.from_numpy(imgs), opts, device="cpu",
                                     host_workers=1) == \
        encode_jpeg_batch_sharded(imgs, opts, device="cpu")


def test_empty_batch():
    opts = JpegOptions(width=8, height=8, quality=85)
    assert encode_jpeg_batch_sharded(np.zeros((0, 8, 8, 3), np.uint8), opts, device="cpu") == []


@pytest.mark.parametrize(
    "flags", [("trellis_quant",), ("progressive", "trellis_quant")]
)
def test_unported_options_raise(flags):
    """The options that raised until the trellis was ported (ROADMAP queue 1
    item 6, closed) raise no more: the batch's files equal the JAX package's,
    baseline with ``trellis_quant`` (the trellis unused) and progressive with
    it (the host library's trellis of ``device="cpu"``)."""
    opts = JpegOptions(width=8, height=8, quality=85).replace(**{f: True for f in flags})
    imgs = np.random.default_rng(3).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    ref = [jax_encode(im, _jax_options(opts).replace(**{f: True for f in flags})) for im in imgs]
    assert encode_jpeg_batch_sharded(imgs, opts, device="cpu") == ref


def test_invalid_options_raise():
    imgs = np.zeros((1, 8, 8, 3), np.uint8)
    with pytest.raises(errors.InvalidQuality):
        encode_jpeg_batch_sharded(imgs, JpegOptions(width=8, height=8, quality=0), device="cpu")
    with pytest.raises(errors.InvalidDataLength):
        encode_jpeg_batch_sharded(imgs, JpegOptions(width=8, height=9), device="cpu")
    with pytest.raises(errors.UnsupportedColorType):
        encode_jpeg_batch_sharded(
            imgs, JpegOptions(width=8, height=8, color_type=ColorType.RGBA), device="cpu")


def test_no_jax_in_the_port():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import pixo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(pixo_tpu_torch.__path__, 'pixo_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pixo_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 35, names\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_refuses_without_a_card():
    """chip_smoke.py runs only on the card: here it must fail and print no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_failed_build_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="building libbroken_test failed"):
        build.build_shared_library(
            "broken_test", ["g++", "-shared", "-fPIC"], [str(src)], timeout=60
        )


def test_parallel_build_links_every_source(tmp_path):
    """With a link command, each source compiles on its own and the objects
    are linked into one library."""
    import ctypes

    for i in (1, 2):
        (tmp_path / f"part{i}.cpp").write_text(f'extern "C" int part{i}() {{ return {i}; }}\n')
    built = build.build_shared_library(
        "parallel_test", ["g++", "-fPIC", "-O1"],
        [str(tmp_path / "part1.cpp"), str(tmp_path / "part2.cpp")], timeout=60,
        link=["g++", "-shared"],
    )
    try:
        lib = ctypes.CDLL(built.path)
        assert (lib.part1(), lib.part2()) == (1, 2)
        assert not [f for f in os.listdir(build.BUILD_DIR) if f.endswith(".o")]
    finally:
        os.remove(built.path)
