"""The benchmark's plain reference held to the port's host tier on small
images on the CPU, and the import graph of a run held apart from JAX, the
JAX package and (for the reference) the program.

Run: ``python -m pytest portbench/tests -q``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import generate
from portbench.reference import jpeg_decode, jpeg_encode, resize, tiers

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SHAPES = [(16, 16), (37, 53), (64, 96), (40, 24), (9, 130)]


def _image(h, w, seed, noise=20.0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 4 + 1, w // 4 + 1, 3)).repeat(4, 0).repeat(4, 1)[:h, :w]
    return np.clip(base + rng.normal(0, noise, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode", ["420", "444"])
@pytest.mark.parametrize("quality", [85, 90, 50])
@pytest.mark.parametrize("shape", SHAPES)
def test_encode_equals_the_ports_host_tier(shape, quality, mode):
    from pixo_tpu_torch import JpegOptions, Subsampling, jpeg

    h, w = shape
    img = _image(h, w, h * w + quality)
    opts = JpegOptions(width=w, height=h, quality=quality,
                       subsampling=Subsampling.S420 if mode == "420" else Subsampling.S444)
    assert jpeg_encode.encode(torch.from_numpy(img)[None], quality, mode)[0] == \
        jpeg.encode(img, opts, device="cpu")


def test_packer_equals_the_ports_plain_packer_on_long_runs_and_large_values():
    from pixo_tpu_torch.jpeg.packer import pack_scan
    from pixo_tpu_torch.jpeg.tables import HuffmanTables

    rng = np.random.default_rng(5)
    zz = np.zeros((60, 64), np.int16)
    zz[:, 0] = rng.integers(-1020, 1020, 60)  # differences within the baseline range
    for row in zz:  # sparse rows with runs past 16 and 32 zeros, values of every category
        k = rng.choice(np.arange(1, 64), rng.integers(0, 6), replace=False)
        row[k] = rng.integers(-1023, 1024, len(k))
    zz[5, 63] = 7  # a block that ends in a nonzero: no EOB
    zz[6, 1:] = 0
    pattern = jpeg_encode.PATTERNS["420"]
    assert jpeg_encode.pack_scan(zz, pattern) == pack_scan(zz, pattern, HuffmanTables.default())


def test_decoder_reads_the_benchmarks_files_back_to_their_coefficients():
    traffic = {"pool": 2, "images": {**_photo(), "width": 80, "height": 48},
               "container": {"format": "jpeg", "quality": 90, "subsampling": "420"}}
    for src in generate.make_sources(traffic, 11, "cpu", workers=1):
        dec = jpeg_decode.decode_coefficients(src.data)
        assert (dec.width, dec.height) == (80, 48)
        assert np.array_equal(dec.zz, src.zz)


@pytest.mark.parametrize("mode", ["420", "444"])
def test_decoded_pixels_equal_the_ports_decode(mode):
    from pixo_tpu_torch.decode import decode_jpeg

    img = _image(48, 80, 3)
    data = jpeg_encode.encode(torch.from_numpy(img)[None], 90, mode)[0]
    mine = jpeg_decode.pixels(jpeg_decode.decode_coefficients(data)).numpy()
    port = np.asarray(decode_jpeg(data, device="cpu").pixels)
    assert np.array_equal(mine, port.reshape(mine.shape))


@pytest.mark.parametrize("src,dst", [((48, 80), (32, 32)), ((90, 160), (16, 16)), ((20, 30), (40, 50)),
                                     ((128, 128), (128, 128))])
def test_lanczos3_equals_the_ports_resize(src, dst):
    from pixo_tpu_torch.ops.resize_kernels import resize_lanczos3_np

    img = _image(*src, seed=9)
    mine = resize.lanczos3(torch.from_numpy(img)[None], dst[1], dst[0])[0].numpy()
    assert np.array_equal(mine, resize_lanczos3_np(img, dst_w=dst[1], dst_h=dst[0]))


def test_thumbnails_equal_the_ports_thumbnail_call():
    from pixo_tpu_torch.parallel import thumbnail_pipeline

    traffic = {"pool": 3, "images": {**_photo(), "width": 80, "height": 48},
               "container": {"format": "jpeg", "quality": 90, "subsampling": "420"}}
    from portbench.drivers.thumbnail import Cell

    config = {"thumb_size": 24, "quality": 85, "host_workers": 2, "chunk_size": 2}
    cell = Cell(config, {**traffic, "files_per_call": 5}, 4, "cpu")
    files, _ = cell.reference("cpu")
    port = thumbnail_pipeline([s.data for s in cell.sources], thumb_size=24, quality=85,
                              host_workers=2, chunk_size=2, device="cpu")
    assert files == port


@pytest.mark.parametrize("most,route", [(0, 8), (8, 8), (9, 16), (16, 16), (17, 32), (32, 32),
                                        (33, tiers.DENSE), (63, tiers.DENSE)])
def test_tier_logic_follows_the_ports_fetch(most, route):
    from pixo_tpu_torch.ops.kernels import compact_padded
    from pixo_tpu_torch.parallel.pipeline import _fetch_compacted

    zz = torch.zeros((2, 6, 64), dtype=torch.int16)
    zz[1, 3, 1: 1 + most] = 3
    state = _fetch_compacted(zz, compact_padded(zz, 8))
    got = tiers.DENSE if state[0] == "dense" else state[3].shape[-1]
    assert tiers.tier(int(tiers.nonzero_acs(zz.numpy()).max())) == route == got


def _photo():
    with open(os.path.join(ROOT, "portbench", "traffic", "photo-stream.json")) as f:
        return {**json.load(f)["images"], "objects": 6}


def _loaded_by(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = os.listdir(os.path.join(ROOT, "portbench", "metrics"))
    code = ("import pixo_tpu_torch, pixo_tpu_torch.parallel\n"
            "from portbench import run, control, generate, readers, roofline, trace\n"
            "from portbench.drivers import jpeg_stream, thumbnail\n"
            + "".join(f"run.load_metric({n[:-3]!r})\n" for n in names if n.endswith(".py")))
    loaded = _loaded_by(code)
    assert "pixo_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "pixo_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_by("from portbench.reference import jpeg_encode, jpeg_decode, resize, tiers")
    assert not loaded & {"jax", "jaxlib", "flax", "pixo_tpu", "pixo_tpu_torch"}
