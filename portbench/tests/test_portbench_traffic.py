"""The traffic generator: deterministic from the seed, different across
seeds, and on its mixes' routes: the photo mix on the padded compaction
tiers, the grain mix on the dense route, at the mixes' own image size and a
reduced batch on the CPU, by the reference's coefficients."""

from __future__ import annotations

import json
import os
import zlib

import numpy as np
import pytest

from portbench import generate
from portbench.reference import jpeg_decode, jpeg_encode, tiers

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _mix(name: str) -> dict:
    with open(os.path.join(ROOT, "portbench", "traffic", f"{name}.json")) as f:
        return json.load(f)


def _small(name: str, **images) -> dict:
    mix = _mix(name)
    return {**mix, "pool": 2, "images": {**mix["images"], **images}}


@pytest.mark.parametrize("name", ["photo-stream", "grain-stream", "jpeg768"])
def test_the_same_seed_gives_the_same_inputs_and_another_seed_others(name):
    mix = _small(name, width=96, height=64)
    a, b, c = (generate.make_sources(mix, s, "cpu", workers=2) for s in (2**31 + 5, 2**31 + 5, 9))
    assert all(np.array_equal(x.pixels, y.pixels) and x.data == y.data for x, y in zip(a, b))
    assert not np.array_equal(a[0].pixels, c[0].pixels)
    assert generate.order(mix, 7, 3).tolist() == generate.order(mix, 7, 3).tolist()
    assert sorted(generate.order(mix, 4, 3).tolist()) == [0, 0, 1, 1]


def _most_nonzero(name: str, seed: int) -> np.ndarray:
    mix = _mix(name)
    px = generate.make_pixels(mix["images"], 3, seed, "cpu")
    return tiers.nonzero_acs(jpeg_encode.coefficients(px, 85, "420").numpy()).max(axis=1)


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_photos_stay_on_the_padded_tiers(seed):
    most = _most_nonzero("photo-stream", seed)
    assert tiers.tier(int(most.max())) in tiers.CAP_TIERS
    assert most.max() <= 29  # room below the top tier: a batch holds 64 such images


@pytest.mark.parametrize("seed", [1, 2**31 + 11])
def test_grain_takes_the_dense_route_in_every_image(seed):
    most = _most_nonzero("grain-stream", seed)
    assert all(tiers.tier(int(m)) == tiers.DENSE for m in most)


@pytest.mark.parametrize("name", ["photo-stream", "jpeg768"])
def test_photos_are_calibrated_to_the_kodim01_row(name):
    """pixo's kodim01 row (768x512 at q85) is 52.8 KB; the photo mix's
    files at the configuration's q85 4:2:0 are within 5% of it on the
    average, at the mix's own size."""
    mix = _mix(name)
    px = generate.make_pixels(mix["images"], 4, 2**31 + 11, "cpu")
    sizes = [len(f) for f in jpeg_encode.encode(px, 85, "420")]
    assert abs(np.mean(sizes) / 52_800 - 1) < 0.05


def test_jpeg_sources_are_the_benchmarks_baseline_files():
    mix = _small("jpeg768", width=80, height=48)
    for src in generate.make_sources(mix, 3, "cpu", workers=1):
        dec = jpeg_decode.decode_coefficients(src.data)
        assert dec.sampling == [(2, 2), (1, 1), (1, 1)]
        assert np.array_equal(dec.zz, src.zz)
        assert src.data == jpeg_encode.frame(jpeg_encode.pack_scan(src.zz, jpeg_encode.PATTERNS["420"]),
                                             80, 48, 85, "420")


def _unfilter(raw: bytes, h: int, w: int) -> np.ndarray:
    rb = 3 * w
    rows = np.frombuffer(raw, np.uint8).reshape(h, rb + 1)
    out = np.zeros((h, rb), np.int64)
    for y in range(h):
        f, line = rows[y, 0], rows[y, 1:].astype(np.int64)
        up = out[y - 1] if y else np.zeros(rb, np.int64)
        for x in range(rb):
            a = out[y, x - 3] if x >= 3 else 0
            c = up[x - 3] if x >= 3 else 0
            b = up[x]
            p = a + b - c
            pred = [0, a, b, (a + b) // 2,
                    a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (b if abs(p - b) <= abs(p - c) else c)][f]
            out[y, x] = (line[x] + pred) & 0xFF
    return out.astype(np.uint8).reshape(h, w, 3)


def _png_mix(**images) -> dict:
    """jpeg768's content in the generator's PNG container (no mix of the
    benchmark uses it yet)."""
    return {**_small("jpeg768", **images), "container": {"format": "png", "zlib_level": 6}}


def test_png_sources_are_the_benchmarks_files_of_the_source_pixels():
    mix = _png_mix(width=40, height=24, objects=5)
    for src in generate.make_sources(mix, 4, "cpu", workers=1):
        assert src.data[:8] == b"\x89PNG\r\n\x1a\n"
        ihdr = src.data[16:29]
        assert ihdr == b"\x00\x00\x00\x28\x00\x00\x00\x18\x08\x02\x00\x00\x00"
        idat = src.data.index(b"IDAT")
        n = int.from_bytes(src.data[idat - 4: idat], "big")
        assert np.array_equal(_unfilter(zlib.decompress(src.data[idat + 4: idat + 4 + n]), 24, 40),
                              src.pixels)


def test_png_sources_decode_in_the_port_to_the_source_pixels():
    from pixo_tpu_torch.decode import decode_png

    mix = _png_mix(width=64, height=36, objects=5)
    for src in generate.make_sources(mix, 8, "cpu", workers=1):
        assert np.array_equal(np.asarray(decode_png(src.data).pixels).reshape(src.pixels.shape), src.pixels)
