"""The port runs with no ``pixo_tpu/`` beside it.

A subprocess works in a temporary directory that holds only a copy of
``pixo_tpu_torch/`` (without its ``_build/``). An import hook there raises
on ``jax``, ``jaxlib`` and ``pixo_tpu`` and notes every such import that a
file of the copy asked for. With ``PIXO_TPU_NO_PGO=1`` (one plain compile of
the copy's ``native/core.cpp``) it runs, with ``device="cpu"`` on small
seeded images, the JPEG encode at the standard, balanced, progressive and
max presets, the PNG encode at the balanced and max presets, a lossy PNG,
the decode of every file and a thumbnail call. This process then holds each
output to the JAX package's: ``pixo_tpu.jpeg.encode``, ``pixo_tpu.png.encode``,
its decoders and its ``thumbnail_pipeline``.
"""

import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from pixo_tpu import jpeg as jax_jpeg
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu import png as jax_png
from pixo_tpu.decode import decode_jpeg as jax_decode_jpeg
from pixo_tpu.decode import decode_png as jax_decode_png
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.options import QuantizationMode as JaxQuantizationMode
from pixo_tpu.options import QuantizationOptions as JaxQuantizationOptions
from pixo_tpu.parallel import thumbnail_pipeline as jax_thumbnail_pipeline

from pixo_tpu_torch import native

jax.config.update("jax_platforms", "cpu")

PACKAGE = Path(__file__).resolve().parent.parent / "pixo_tpu_torch"
TIMEOUT = 300

# the preamble of every script run in the copy: the import hook
HOOK = r'''
import os, sys, traceback

HERE = os.path.dirname(os.path.abspath(__file__))
PORT = os.path.join(HERE, "pixo_tpu_torch") + os.sep
BLOCKED = {"jax", "jaxlib", "pixo_tpu"}
ASKED = []  # (module, whether a file of the copy asked for it)


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            files = [f.filename for f in traceback.extract_stack()]
            ASKED.append((name, any(f.startswith(PORT) for f in files)))
            raise ImportError(f"{name} may not be imported here")
        return None


sys.meta_path.insert(0, Block())
'''

DRIVER = HOOK + r'''
import pickle

import numpy as np

import pixo_tpu_torch
from pixo_tpu_torch import (ColorType, JpegOptions, PngOptions, QuantizationMode, QuantizationOptions,
                            encode_jpeg_batch_sharded, encode_png_batch_sharded, jpeg, native, png,
                            thumbnail_pipeline)
from pixo_tpu_torch.decode import decode_jpeg, decode_png

assert pixo_tpu_torch.__file__.startswith(PORT), pixo_tpu_torch.__file__
rng = np.random.default_rng(2024)
h, w = 40, 56
base = np.add.outer(np.arange(h) * 4, np.arange(w) * 3)[..., None]
imgs = (base + rng.normal(0, 14, (2, h, w, 3))).clip(0, 255).astype(np.uint8)
jpeg_opts = {
    "standard": JpegOptions.fast(w, h, 85),
    "balanced": JpegOptions.balanced(w, h, 85),
    "progressive": JpegOptions.balanced(w, h, 85).replace(progressive=True),
    "max": JpegOptions.max(w, h, 85),
}
lossy = QuantizationOptions(mode=QuantizationMode.FORCE, max_colors=64, dithering=True)
png_opts = {
    "balanced": PngOptions.balanced(w, h).replace(color_type=ColorType.RGB),
    "max": PngOptions.max(w, h).replace(color_type=ColorType.RGB),
    "lossy": PngOptions.balanced(w, h).replace(color_type=ColorType.RGB, quantization=lossy),
}
out = {"jpeg": {}, "png": {}, "decoded": {}}
for name, opts in jpeg_opts.items():
    out["jpeg"][name] = [jpeg.encode(imgs[0], opts, device="cpu"),
                         *encode_jpeg_batch_sharded(imgs, opts, device="cpu")]
for name, opts in png_opts.items():
    out["png"][name] = [png.encode(imgs[0], opts, device="cpu"),
                        *encode_png_batch_sharded(imgs, opts, device="cpu")]
for kind, decode in (("jpeg", lambda d: decode_jpeg(d, device="cpu")), ("png", decode_png)):
    for name, files in out[kind].items():
        out["decoded"][kind, name] = [decode(f).pixels for f in files]
thumbs_in = [out["jpeg"]["standard"][1], out["jpeg"]["progressive"][1], out["png"]["balanced"][1],
             out["png"]["lossy"][1]]
out["thumbs"] = (thumbs_in, thumbnail_pipeline(thumbs_in, thumb_size=24, quality=80, device="cpu"))
out["imgs"] = imgs
out["source"], out["library"] = native.SOURCE, native.library_path
out["asked"] = ASKED
with open(os.path.join(HERE, "out.pkl"), "wb") as f:
    pickle.dump(out, f)
'''

SOURCE_ONLY = HOOK + r'''
from pixo_tpu_torch import native
print(native.SOURCE)
'''


@pytest.fixture(scope="module")
def copy_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("standalone")
    shutil.copytree(PACKAGE, root / "pixo_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return root


def _run(root: Path, name: str, script: str) -> subprocess.CompletedProcess:
    (root / name).write_text(script)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PIXO_TPU_NO_PGO"] = "1"
    proc = subprocess.run([sys.executable, str(root / name)], cwd=root, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def test_port_runs_without_the_jax_package(copy_dir):
    """Built from the copy, with the JAX package unimportable, every output
    equals the JAX package's."""
    assert not (copy_dir / "pixo_tpu").exists()
    _run(copy_dir, "drive.py", DRIVER)
    with open(copy_dir / "out.pkl", "rb") as f:
        out = pickle.load(f)
    port = str(copy_dir / "pixo_tpu_torch") + os.sep
    assert out["source"] == port + os.path.join("native", "core.cpp")
    assert out["library"].startswith(port + "_build" + os.sep)
    assert not [name for name, from_port in out["asked"] if from_port]
    imgs = out["imgs"]
    h, w = imgs.shape[1:3]
    jpeg_opts = {
        "standard": JaxJpegOptions.fast(w, h, 85),
        "balanced": JaxJpegOptions.balanced(w, h, 85),
        "progressive": JaxJpegOptions.balanced(w, h, 85).replace(progressive=True),
        "max": JaxJpegOptions.max(w, h, 85),
    }
    lossy = JaxQuantizationOptions(mode=JaxQuantizationMode.FORCE, max_colors=64, dithering=True)
    rgb = JaxColorType.RGB
    png_opts = {
        "balanced": JaxPngOptions.balanced(w, h).replace(color_type=rgb),
        "max": JaxPngOptions.max(w, h).replace(color_type=rgb),
        "lossy": JaxPngOptions.balanced(w, h).replace(color_type=rgb, quantization=lossy),
    }
    for kind, encode, table in (("jpeg", jax_jpeg.encode, jpeg_opts), ("png", jax_png.encode, png_opts)):
        assert sorted(out[kind]) == sorted(table)
        for name, opts in table.items():
            want = [encode(imgs[0], opts), *(encode(img, opts) for img in imgs)]
            assert out[kind][name] == want, (kind, name)
    for (kind, name), pixels in out["decoded"].items():
        decode = jax_decode_jpeg if kind == "jpeg" else jax_decode_png
        for got, data in zip(pixels, out[kind][name]):
            np.testing.assert_array_equal(got, decode(data).pixels, err_msg=f"{kind} {name}")
    files, thumbs = out["thumbs"]
    assert thumbs == jax_thumbnail_pipeline(files, thumb_size=24, quality=80)


def test_host_library_source_is_the_ports_own(copy_dir):
    """``native.SOURCE`` lies inside ``pixo_tpu_torch/``, here and in a copy
    that stands alone."""
    assert os.path.commonpath([native.SOURCE, str(PACKAGE)]) == str(PACKAGE)
    assert os.path.isfile(native.SOURCE)
    proc = _run(copy_dir, "source.py", SOURCE_ONLY)
    source = proc.stdout.strip().splitlines()[-1]
    copied = str(copy_dir / "pixo_tpu_torch")
    assert os.path.commonpath([source, copied]) == copied and os.path.isfile(source)
