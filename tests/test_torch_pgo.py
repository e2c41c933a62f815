"""The host library's profile-guided build, on the CPU.

``native.load()`` builds ``core.cpp`` in three steps (``utils/build.py``):
an instrumented compile, the port's training battery
(``pixo_tpu_torch/native/_pgo_train.py``) in a subprocess on that library,
and a compile that reads the profile. These tests hold that the trainer
imports neither JAX nor the JAX package, that it reaches every entry point
of the host library that a path of the port calls (``ENTRY_POINTS``,
recorded through a proxy around the library), that the profile-guided and
the plain (``PIXO_TPU_NO_PGO=1``) libraries give the same bytes and pixels
on a battery of their own (and, for the JPEG and PNG batches, the JAX
package's bytes), that the build raises where the final compile finds no
profile (the two compiles writing different output names, whose profile
files GCC names apart) or the trainer fails, and that the trainer's bytes
and ``PIXO_TPU_NO_PGO`` each select a library of their own.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.jpeg.encoder import encode as jax_jpeg_encode
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.options import Subsampling as JaxSubsampling
from pixo_tpu import png as jax_png

from pixo_tpu_torch import (ColorType, JpegOptions, PngOptions, QuantizationMode,
                            QuantizationOptions, Subsampling, encode_jpeg_batch_sharded,
                            encode_png_batch_sharded, native)
from pixo_tpu_torch.decode import decode_jpeg_batch, decode_png
from pixo_tpu_torch.native import _pgo_train
from pixo_tpu_torch.utils import build

jax.config.update("jax_platforms", "cpu")

REPO = str(Path(__file__).resolve().parents[1])

# Every entry point of the host library that a path of the port calls: the
# card paths' host stages (the padded and dense JPEG packers, the tables of
# the balanced and optimal routes, the progressive scans, the max preset's
# trellis, the PNG DEFLATE, the decode's entropy stage), then the host
# tiers' own. Bound but called by no path: jpeg_pack_scan_batch,
# jpeg_pack_scan_sparse (the flat compaction route's packer),
# deflate_optimal_parity (the reference mirror under
# PIXO_TPU_DEFLATE_PARITY=1), resize_lanczos3_host (an oracle).
ENTRY_POINTS = (
    "jpeg_pack_scan_padded", "jpeg_pack_scan",
    "jpeg_count_symbols", "huffman_build_lengths",
    "jpeg_count_progressive_scan", "jpeg_encode_progressive_scan",
    "jpeg_dct_zz", "jpeg_trellis_quantize",
    "jpeg_coefficients", "jpeg_encode_scan_fused",
    "deflate_compress", "deflate_compress_parity", "png_filter_apply",
    "deflate_compress_optimal", "deflate_compress_optimal_assisted",
    "jpeg_decode_scan", "jpeg_prog_dc_segment", "jpeg_prog_ac_segment",
    "jpeg_decode_pixels", "jpeg_decode_baseline",
    "inflate_decompress", "png_unfilter", "png_palette_expand",
    "nearest_palette_batch", "palette_lut_build", "dither_fs",
    "pixo_crc32", "pixo_adler32",
)


class _Recorder:
    """The loaded library, recording the name of every function called."""

    def __init__(self, lib):
        self._lib = lib
        self.called = set()

    def __getattr__(self, name):
        fn = getattr(self._lib, name)

        def call(*args):
            self.called.add(name)
            return fn(*args)

        return call


@pytest.fixture(scope="module")
def libraries():
    """{"pgo": the profile-guided library, "plain": the plain one}, loaded."""
    return {"pgo": native._open(native._build(True).path),
            "plain": native._open(native._build(False).path)}


def test_trainer_imports_neither_jax_nor_the_jax_package(libraries):
    """The trainer run as the build runs it, on the plain library, in a
    process of its own: no module of JAX or of the JAX package is loaded."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['_pgo_train', {native._build(False).path!r}]\n"
        "try:\n"
        "    runpy.run_module('pixo_tpu_torch.native._pgo_train', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pixo_tpu')))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_trainer_reaches_every_entry_point(libraries, monkeypatch):
    recorder = _Recorder(libraries["plain"])
    monkeypatch.setattr(native, "_lib", recorder)
    _pgo_train.train()
    assert sorted(set(ENTRY_POINTS) - recorder.called) == []


def _photos(seed: int, b: int, h: int, w: int):
    """b smooth photos with noise, made from ``seed``."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = (np.sin(x / 5.0) * 55 + np.cos(y / 7.0) * 45 + 120)[None, ..., None]
    return (base + rng.normal(0, 10, (b, h, w, 3))).clip(0, 255).astype(np.uint8)


H, W = 40, 56
JPEG_ROUTES = {
    "standard": JpegOptions(width=W, height=H, quality=85, subsampling=Subsampling.S420),
    "balanced": JpegOptions.balanced(W, H, 85),
    "progressive": JpegOptions.balanced(W, H, 85).replace(progressive=True),
}
PNG_PRESETS = {"fast": PngOptions.fast, "balanced": PngOptions.balanced, "max": PngOptions.max}


def _jax_jpeg_options(o: JpegOptions) -> JaxJpegOptions:
    return JaxJpegOptions(width=o.width, height=o.height, quality=o.quality,
                          color_type=JaxColorType(int(o.color_type)),
                          subsampling=JaxSubsampling(o.subsampling.value),
                          optimize_huffman=o.optimize_huffman, progressive=o.progressive)


def _png_options(preset: str) -> PngOptions:
    return PNG_PRESETS[preset](W, H).replace(color_type=ColorType.RGB)


def _jpeg_files(route: str):
    return encode_jpeg_batch_sharded(_photos(1, 3, H, W), JPEG_ROUTES[route], device="cpu",
                                     host_workers=2)


def _png_files(preset: str):
    return encode_png_batch_sharded(_photos(2, 3, H, W), _png_options(preset), device="cpu",
                                    host_workers=2)


def _lossy_files():
    opts = PngOptions.balanced(W, H).replace(
        color_type=ColorType.RGB,
        quantization=QuantizationOptions(mode=QuantizationMode.FORCE, max_colors=32, dithering=True))
    return encode_png_batch_sharded(_photos(3, 2, H, W), opts, device="cpu", host_workers=2)


def _pixels(images):
    return [(im.width, im.height, np.asarray(im.pixels).tobytes()) for im in images]


def _jpeg_decoded():
    """The JPEG files of every route decoded under both pixel tiers (the
    device tier's host stage is the card path's entropy decode)."""
    files = [f for route in JPEG_ROUTES for f in _jpeg_files(route)]
    out = []
    for tier in ("host", "device"):
        with _pgo_train._env(PIXO_TPU_DECODE_PIXELS=tier):
            out += _pixels(decode_jpeg_batch(files, workers=2, device="cpu"))
    return out


BATTERY = {
    **{f"jpeg {route}": (lambda route=route: _jpeg_files(route)) for route in JPEG_ROUTES},
    **{f"png {preset}": (lambda preset=preset: _png_files(preset)) for preset in PNG_PRESETS},
    "jpeg decode": _jpeg_decoded,
    "png decode": lambda: _pixels(decode_png(f) for f in _png_files("balanced") + _lossy_files()),
    "lossy png": _lossy_files,
}


@pytest.mark.parametrize("case", list(BATTERY))
def test_pgo_and_plain_libraries_give_the_same_bytes(libraries, monkeypatch, case):
    out = {}
    for build_kind, lib in libraries.items():
        monkeypatch.setattr(native, "_lib", lib)
        out[build_kind] = BATTERY[case]()
    assert out["pgo"] == out["plain"]
    assert out["pgo"]
    if case.startswith("jpeg ") and case != "jpeg decode":
        opts = _jax_jpeg_options(JPEG_ROUTES[case.split()[1]])
        assert out["pgo"] == [jax_jpeg_encode(im, opts) for im in _photos(1, 3, H, W)]
    if case.startswith("png ") and case != "png decode":
        jopts = JaxPngOptions.from_preset(W, H, list(PNG_PRESETS).index(case.split()[1])).replace(
            color_type=JaxColorType.RGB)
        assert out["pgo"] == [jax_png.encode(im, jopts) for im in _photos(2, 3, H, W)]


TOY_SOURCE = ('extern "C" int toy(int n) {\n'
              '  int s = 0;\n  for (int i = 0; i < n; i++) s += i % 3 ? i : -1;\n  return s;\n}\n')
TOY_TRAINER = "import ctypes, sys\nassert ctypes.CDLL(sys.argv[1]).toy(1000) == 332333\n"


@pytest.fixture
def toy(tmp_path, monkeypatch):
    """A one-function library and its trainer, built in a build directory of
    the test's own: (the compile command, its sources, its training)."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "toy.cpp").write_text(TOY_SOURCE)
    (tmp_path / "train.py").write_text(TOY_TRAINER)
    training = build.Training([sys.executable, str(tmp_path / "train.py")],
                              [str(tmp_path / "train.py")], str(tmp_path))
    return ["g++", "-O2", "-shared", "-fPIC"], [str(tmp_path / "toy.cpp")], training


def test_profile_guided_build_reads_its_profile(toy):
    import ctypes

    command, sources, training = toy
    built = build.build_shared_library("toy", command, sources, timeout=120, training=training)
    assert list(built.steps) == ["instrumented compile", "training", "final compile"]
    assert "profile count data file not found" not in built.log
    assert ctypes.CDLL(built.path).toy(1000) == 332333
    assert sorted(os.listdir(build.BUILD_DIR)) == [".toy.lock", os.path.basename(built.path)]


def test_build_raises_when_the_compiles_output_names_differ(toy, monkeypatch):
    """The trap of GCC's profile names: the final compile written under
    another name than the instrumented one looks for another profile file,
    finds none, and the build raises rather than ship an unguided library."""
    command, sources, training = toy
    run = build._run

    def renamed(name, cmd, timeout, cwd=None):
        if any(a.startswith("-fprofile-use=") for a in cmd):
            i = cmd.index("-o") + 1
            cmd = [*cmd[:i], cmd[i] + ".final", *cmd[i + 1:]]
        return run(name, cmd, timeout, cwd)

    monkeypatch.setattr(build, "_run", renamed)
    with pytest.raises(RuntimeError, match="the final compile found no profile"):
        build.build_shared_library("toy", command, sources, timeout=120, training=training)
    assert not os.path.exists(build.library_path("toy", command, sources, training=training))


def test_build_raises_when_the_trainer_fails(toy, tmp_path):
    command, sources, training = toy
    (tmp_path / "train.py").write_text("import sys\nsys.exit('the battery failed')\n")
    with pytest.raises(RuntimeError, match="the battery failed"):
        build.build_shared_library("toy", command, sources, timeout=120, training=training)


def test_trainer_bytes_and_no_pgo_select_their_own_library(libraries, tmp_path):
    args = ("pixo_core", native.COMMAND, [native.SOURCE], native._cpu_flags())
    pgo = build.library_path(*args, training=native.TRAINING)
    plain = build.library_path(*args)
    assert pgo == native._build(True).path and plain == native._build(False).path
    assert pgo != plain
    edited = tmp_path / "_pgo_train.py"
    edited.write_bytes(Path(native.TRAINING.files[0]).read_bytes() + b"\n")
    assert build.library_path(*args, training=native.TRAINING._replace(files=[str(edited)])) != pgo
    code = ("from pixo_tpu_torch import native\nnative.load()\n"
            "print(native.library_path, native.profile_guided)\n")
    loaded = {}
    for no_pgo in ("", "1"):
        env = {k: v for k, v in os.environ.items() if k != "PIXO_TPU_NO_PGO"}
        if no_pgo:
            env["PIXO_TPU_NO_PGO"] = no_pgo
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        loaded[no_pgo] = proc.stdout.split()
    assert loaded == {"": [pgo, "True"], "1": [plain, "False"]}
