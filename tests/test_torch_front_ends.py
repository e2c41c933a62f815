"""The port's front ends and public surface against the JAX package, on the
CPU.

- ``cli.main([..., "--device", "cpu"])`` against ``pixo_tpu.cli.main`` over
  each flag group, the output files byte for byte (the reference runs under
  ``monkeypatch``, so the environment settings its ``--device cpu`` makes
  do not leak into other tests);
- ``bindings``, ``playground.compress_bytes``, ``jpeg.encode_into``,
  ``jpeg.compute_coefficients``, ``color.to_grayscale_bt601`` and
  ``rgb_to_ycbcr_np`` against their references;
- ``utils.profile_trace`` and ``stage_timer``;
- the API surface: every name in each reference package's ``__all__``
  exists in the port, and so does every public module, but for
  ``utils/jaxcache.py`` (the JAX compile cache, which has no counterpart).
"""

import importlib
import inspect
import io
import json
import os

import numpy as np
import pytest
import torch

import jax

import pixo_tpu
from pixo_tpu import bindings as jax_bindings
from pixo_tpu import cli as jax_cli
from pixo_tpu import color as jax_color
from pixo_tpu.jpeg import compute_coefficients as jax_compute_coefficients
from pixo_tpu.jpeg import encode as jax_jpeg_encode
from pixo_tpu.jpeg import encode_into as jax_encode_into
from pixo_tpu.jpeg.tables import QuantizationTables as JaxQuantizationTables
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import Subsampling as JaxSubsampling
from pixo_tpu.playground import compress_bytes as jax_compress_bytes

import pixo_tpu_torch
from pixo_tpu_torch import bindings, cli, color, jpeg
from pixo_tpu_torch.jpeg.tables import QuantizationTables
from pixo_tpu_torch.options import JpegOptions, Subsampling
from pixo_tpu_torch.playground import compress_bytes
from pixo_tpu_torch.utils import profile_trace, stage_timer
from pixo_tpu_torch.utils.synthetic import synth_gradient
from tests.test_torch_resize import _bilinear_np

jax.config.update("jax_platforms", "cpu")

H, W = 40, 48


def _rgb(h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    return (synth_gradient(h, w).astype(np.int32) + rng.integers(-20, 21, (h, w, 3))).clip(0, 255) \
        .astype(np.uint8)


def _encoded(img, fmt, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_inputs")
    rgb = _rgb()
    rgba = np.concatenate([rgb, np.linspace(0, 255, H * W).astype(np.uint8).reshape(H, W, 1)], axis=2)
    files = {
        "rgb.png": _encoded(rgb, "PNG"),
        "rgba.png": _encoded(rgba, "PNG"),
        "photo.jpg": _encoded(rgb, "JPEG", quality=90),
        "photo420.jpg": _encoded(rgb, "JPEG", quality=80, subsampling=2),
        "rgb.ppm": b"P6\n# a comment\n%d %d\n255\n" % (W, H) + rgb.tobytes(),
        "gray.pgm": b"P5 %d %d 255\n" % (W, H) + rgb[..., 1].tobytes(),
        "junk.bin": b"not an image",
    }
    for name, data in files.items():
        (d / name).write_bytes(data)
    return d


def _run_both(monkeypatch, tmp_path, argv, out_name):
    """Run the port's main and the reference's on the same argv (with
    ``--device cpu``), each writing its own output; their return codes and
    output bytes."""
    # the settings that the reference's --device cpu makes with setdefault,
    # here under monkeypatch so that they are undone after the test
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("PIXO_TPU_COEFFS", "host")
    monkeypatch.setenv("PIXO_TPU_RESIZE", "host")
    monkeypatch.setenv("PIXO_TPU_NO_COMPILE_CACHE", "1")
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        out = tmp_path / f"{name}_{out_name}"
        rc = main([*argv, "-o", str(out), "--quiet", "--device", "cpu"])
        outs[name] = (rc, out.read_bytes() if out.exists() else None)
    return outs["port"], outs["jax"]


CLI_CASES = {
    "png to jpeg": ("rgb.png", [], "out.jpg"),
    "jpeg quality, 4:2:0, optimized tables": (
        "rgb.png", ["-q", "70", "--subsampling", "s420", "--jpeg-optimize-huffman"], "out.jpg"),
    "jpeg 4:2:2, optimal tables, restarts": (
        "rgb.png", ["--subsampling", "s422", "--jpeg-optimal-huffman", "--jpeg-restart-interval", "2"],
        "out.jpg"),
    "jpeg 4:2:2, standard tables": ("rgb.png", ["--subsampling", "s422"], "out.jpg"),
    "jpeg progressive": ("rgb.png", ["--jpeg-progressive"], "out.jpeg"),
    "jpeg trellis, progressive": ("rgb.png", ["--jpeg-progressive", "--jpeg-trellis"], "out.jpg"),
    "jpeg presets": ("rgb.png", ["--preset", "balanced"], "out.jpg"),
    "jpeg max preset": ("rgb.png", ["--preset", "max", "-q", "80"], "out.jpg"),
    "rgba png to jpeg (alpha stripped)": ("rgba.png", [], "out.jpg"),
    "jpeg to png": ("photo.jpg", [], "out.png"),
    "4:2:0 jpeg to png, fancy upsampling": ("photo420.jpg", ["--fancy-upsampling"], "out.png"),
    "4:2:0 jpeg to png, nearest": ("photo420.jpg", [], "out.png"),
    "png flags": ("rgba.png", ["-c", "9", "--filter", "paeth", "--png-optimize-alpha",
                               "--png-reduce-color", "--png-strip-metadata"], "out.png"),
    "png filter minsum": ("rgb.png", ["--filter", "minsum"], "out.png"),
    "png interlace": ("rgb.png", ["--interlace"], "out.png"),
    "png lossy": ("rgb.png", ["--lossy"], "out.png"),
    "png preset fast, lossy": ("rgba.png", ["--preset", "fast", "--lossy"], "out.png"),
    "png max preset": ("rgb.png", ["--preset", "max"], "out.png"),
    "resize lanczos3": ("photo.jpg", ["--resize", "20x15"], "out.png"),
    "resize bilinear to jpeg": ("rgb.png", ["--resize", "64x50", "--resize-filter", "bilinear"],
                                "out.jpg"),
    "resize nearest, rgba": ("rgba.png", ["--resize", "17x9", "--resize-filter", "nearest"],
                             "out.png"),
    "grayscale to jpeg with resize": ("rgb.png", ["--grayscale", "--resize", "24x20"], "out.jpg"),
    "grayscale jpeg to png": ("photo.jpg", ["--grayscale"], "out.png"),
    "ppm to png (format from input)": ("rgb.ppm", [], "out.png"),
    "pgm to jpeg": ("gray.pgm", [], "out.jpg"),
    "format override": ("rgb.png", ["--format", "jpeg"], "out.bin"),
}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_equals_jax(name, inputs, tmp_path, monkeypatch):
    src, flags, out_name = CLI_CASES[name]
    port, ref = _run_both(monkeypatch, tmp_path, [str(inputs / src), *flags], out_name)
    assert port[0] == ref[0] == 0
    assert port[1] is not None and port[1] == ref[1]


@pytest.mark.parametrize("argv", [["junk.bin"], ["missing.png"], ["rgb.png", "--resize", "abc"]])
def test_cli_errors_as_jax(argv, inputs, tmp_path, monkeypatch):
    argv = [str(inputs / argv[0]), *argv[1:]]
    port, ref = _run_both(monkeypatch, tmp_path, argv, "out.png")
    assert port == ref == (1, None)


def test_cli_json_and_dry_run(inputs, capsys):
    assert cli.main([str(inputs / "rgb.png"), "-o", "never.jpg", "--dry-run", "--json",
                     "--device", "cpu"]) == 0
    record = json.loads(capsys.readouterr().out)
    assert record["dry_run"] and record["format"] == "jpeg"
    assert (record["width"], record["height"]) == (W, H)
    assert not os.path.exists("never.jpg")


def test_cli_defaults_to_the_card_and_needs_one(inputs, tmp_path, monkeypatch, capsys):
    args = cli.build_parser().parse_args(["x.png"])
    assert args.device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.jpg"
    assert cli.main([str(inputs / "rgb.png"), "-o", str(out)]) == 2
    assert "no CUDA device" in capsys.readouterr().err and not out.exists()


def test_cli_version(capsys):
    with pytest.raises(SystemExit) as exit_info:
        cli.main(["--version"])
    assert exit_info.value.code == 0
    assert capsys.readouterr().out.strip() == f"pixo-tpu-torch {pixo_tpu_torch.__version__}"
    assert pixo_tpu_torch.__version__ == pixo_tpu.__version__ == "0.5.0"


def test_main_module_runs_the_cli():
    import pixo_tpu_torch.__main__ as entry

    assert entry.main is cli.main


# ------------------------------------------------------------------ bindings

@pytest.mark.parametrize("preset", [0, 1, 2])
@pytest.mark.parametrize("lossless", [True, False])
def test_bindings_encode_png_equals_jax(preset, lossless):
    img = _rgb(24, 32, seed=preset)
    for ct, data in ((2, img), (3, np.dstack([img, img[..., :1]])), (0, img[..., 0].copy())):
        h, w = data.shape[:2]
        got = bindings.encode_png(data.tobytes(), w, h, ct, preset, lossless, device="cpu")
        assert got == jax_bindings.encode_png(data.tobytes(), w, h, ct, preset, lossless)


@pytest.mark.parametrize("preset", [0, 1, 2])
@pytest.mark.parametrize("sub420", [False, True])
def test_bindings_encode_jpeg_equals_jax(preset, sub420):
    img = _rgb(24, 32, seed=10 + preset)
    for ct, data in ((2, img), (0, img[..., 0].copy())):
        got = bindings.encode_jpeg(data, 32, 24, ct, 80, preset, sub420, device="cpu")
        assert got == jax_bindings.encode_jpeg(data, 32, 24, ct, 80, preset, sub420)


@pytest.mark.parametrize("algorithm", ["nearest", "bilinear", "lanczos3"])
def test_bindings_resize_image_equals_jax(algorithm):
    """Exact, but for bilinear: the JAX package has only its jit tier
    there, which XLA:CPU contracts into FMAs, so bilinear is exact against
    the numpy mirror of its arithmetic and within one level of the JAX
    package (the tolerance of tests/test_torch_resize.py)."""
    img = _rgb(24, 32, seed=20)
    for ct, data in ((2, img), (0, img[..., :1].copy()), (3, np.dstack([img, img[..., :1]]))):
        for dw, dh in ((11, 7), (40, 30)):
            got = bindings.resize_image(data.tobytes(), 32, 24, dw, dh, ct, algorithm, device="cpu")
            want = jax_bindings.resize_image(data.tobytes(), 32, 24, dw, dh, ct, algorithm)
            if algorithm != "bilinear":
                assert got == want
                continue
            assert got == _bilinear_np(data, dw, dh).tobytes()
            diff = np.frombuffer(got, np.uint8).astype(int) - np.frombuffer(want, np.uint8)
            assert np.abs(diff).max() <= 1


def test_bindings_bytes_per_pixel():
    assert [bindings.bytes_per_pixel(c) for c in range(4)] == \
        [jax_bindings.bytes_per_pixel(c) for c in range(4)] == [1, 2, 3, 4]


# --------------------------------------------------------------- playground

PLAYGROUND_PARAMS = {
    "jpeg with resize": {"name": "a.jpg", "rw": "20", "rh": "16", "quality": "75"},
    "jpeg 4:2:0, max preset": {"name": "a.jpeg", "sub420": "true", "preset": "2"},
    "png lossy (default)": {"name": "a.png"},
    "png lossless, fast": {"name": "a.png", "lossless": "true", "preset": "0"},
    "png from a jpeg name, resize": {"name": "a.jpg", "format": "png", "lossless": "true",
                                     "rw": "9", "rh": "31"},
}


@pytest.mark.parametrize("name", list(PLAYGROUND_PARAMS))
@pytest.mark.parametrize("src", ["photo.jpg", "rgba.png", "gray.pgm"])
def test_compress_bytes_equals_jax(name, src, inputs):
    data = (inputs / src).read_bytes()
    params = PLAYGROUND_PARAMS[name]
    out, meta = compress_bytes(data, params, device="cpu")
    want, want_meta = jax_compress_bytes(data, params)
    assert out == want
    meta.pop("elapsed_ms")
    want_meta.pop("elapsed_ms")
    assert meta == want_meta


# --------------------------------------------------------- jpeg and color

MODES = {"gray": None, "444": JaxSubsampling.S444, "420": JaxSubsampling.S420,
         "422": JaxSubsampling.S422}


@pytest.mark.parametrize("mode", list(MODES))
def test_compute_coefficients_equals_jax(mode):
    from pixo_tpu_torch.color import ColorType
    from pixo_tpu.color import ColorType as JaxColorType

    img = _rgb(23, 37, seed=30)
    gray = mode == "gray"
    src = img[..., 0].copy() if gray else img
    sub = "444" if gray else mode
    opts = JpegOptions(width=37, height=23, quality=70, subsampling=Subsampling(sub),
                       color_type=ColorType.GRAY if gray else ColorType.RGB)
    jopts = JaxJpegOptions(width=37, height=23, quality=70, subsampling=JaxSubsampling(sub),
                           color_type=JaxColorType.GRAY if gray else JaxColorType.RGB)
    got = jpeg.compute_coefficients(src, opts, QuantizationTables(70), device="cpu")
    want = jax_compute_coefficients(src, jopts, JaxQuantizationTables(70))
    assert got.dtype == np.int16 and np.array_equal(got, want)


@pytest.mark.parametrize("h, w", [(8, 16), (16, 16), (37, 53), (40, 48)])
def test_host_tier_encodes_422_with_the_standard_tables(h, w):
    """The host library's fused coefficient + pack call counts 4:2:2's
    blocks as 4:2:0's (``core.cpp:7486-7493``) and fails; the JAX package
    then takes its two-stage path, and so must the port's host tier, single
    image and batch."""
    rng = np.random.default_rng(h * w)
    imgs = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    for ri in (None, 2):
        opts = JpegOptions(width=w, height=h, quality=70, subsampling=Subsampling.S422,
                           restart_interval=ri)
        jopts = JaxJpegOptions(width=w, height=h, quality=70, subsampling=JaxSubsampling.S422,
                               restart_interval=ri)
        want = [jax_jpeg_encode(im, jopts) for im in imgs]
        assert [jpeg.encode(im, opts, device="cpu") for im in imgs] == want
        assert jpeg.encode_batch(imgs, opts, device="cpu") == want


def test_encode_into_refills_the_buffer():
    img = _rgb(16, 24, seed=40)
    opts = JpegOptions(width=24, height=16, quality=85)
    jopts = JaxJpegOptions(width=24, height=16, quality=85)
    out, want = bytearray(b"stale"), bytearray(b"old")
    jpeg.encode_into(out, img, opts, device="cpu")
    jax_encode_into(want, img, jopts)
    assert out == want and out[:2] == b"\xff\xd8"


def test_color_helpers_equal_jax():
    rgb = np.random.default_rng(50).integers(0, 256, (7, 9, 3), dtype=np.uint8)
    edges = np.array([[[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0], [0, 0, 255]]], np.uint8)
    for x in (rgb, edges):
        assert np.array_equal(color.to_grayscale_bt601(x), jax_color.to_grayscale_bt601(x))
        assert np.array_equal(color.rgb_to_ycbcr_np(x), jax_color.rgb_to_ycbcr_np(x))
        assert np.array_equal(color.rgb_to_ycbcr(torch.from_numpy(x)).numpy(),
                              jax_color.rgb_to_ycbcr_np(x))


# ------------------------------------------------------------------ utils

def test_profile_trace_writes_a_chrome_trace(tmp_path, capsys):
    with profile_trace(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("matmul" in e.key for e in prof.key_averages())
    assert "trace written" in capsys.readouterr().err
    assert inspect.signature(profile_trace).parameters["device"].default == "cuda"


def test_stage_timer_reports_mp_per_s():
    buf = io.StringIO()
    with stage_timer("encode", megapixels=2.0, stream=buf) as t:
        sum(range(1000))
    assert t.elapsed > 0 and buf.getvalue().startswith("encode: ") and "MP/s" in buf.getvalue()


# -------------------------------------------------------------- API surface

PACKAGES = ["", ".compress", ".decode", ".jpeg", ".parallel", ".png", ".utils"]


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "top")
def test_every_reference_export_exists_in_the_port(package):
    ref = importlib.import_module("pixo_tpu" + package)
    port = importlib.import_module("pixo_tpu_torch" + package)
    assert [n for n in ref.__all__ if not hasattr(port, n)] == []


NOT_PORTED = {"utils.jaxcache"}  # the JAX compile cache: no counterpart


def _front_modules(root: str) -> set:
    """The public modules of the package's root, ``parallel/`` and
    ``utils/``: its front ends and serving layer."""
    found = set()
    for sub in ("", "parallel", "utils"):
        for f in os.listdir(os.path.join(root, sub)):
            if f.endswith(".py") and (not f.startswith("_") or f == "__main__.py"):
                found.add(".".join(p for p in (sub, f[:-3]) if p))
    return found


def test_every_reference_module_exists_in_the_port():
    ref = _front_modules(os.path.dirname(pixo_tpu.__file__))
    port = _front_modules(os.path.dirname(pixo_tpu_torch.__file__))
    assert ref - port == NOT_PORTED
    for name in sorted(ref - NOT_PORTED):
        importlib.import_module("pixo_tpu_torch." + name)


def test_bindings_and_front_end_names():
    for name in ["encode_png", "encode_jpeg", "resize_image", "bytes_per_pixel"]:
        assert hasattr(bindings, name), name
    for name in ["build_parser", "main", "load_image", "detect_format_from_bytes"]:
        assert hasattr(cli, name), name
    for fn in (bindings.encode_png, bindings.encode_jpeg, bindings.resize_image, jpeg.encode_into,
               jpeg.compute_coefficients, compress_bytes):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__
