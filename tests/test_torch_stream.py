"""The port's JPEG streams and device meshes against the JAX package, on the
CPU.

``encode_jpeg_stream`` and ``encode_jpeg_stream_overlapped`` (with
``device="cpu"``: the plain kernels, the compaction, the host pack) take
the same seeded batches as the JAX package's ``jpeg.encode`` one image at a
time, on every route of the batch path: the standard tables, the balanced
preset (optimized tables), optimal tables, progressive, the max preset
(the trellis) and a noise batch in mid-stream that escalates the
compaction cap or falls back to the dense stream. Every file must be
byte-equal. The overlapped form's ``stats`` keep the ordering contract of
the JAX package's own test (``tests/test_parallel.py``); a CPU mesh of 8
and of 1 gives the files of ``device="cpu"``, and a mesh together with an
explicit ``device`` raises.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

import jax

from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.jpeg.encoder import encode as jax_encode
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import Subsampling as JaxSubsampling

from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, encode_jpeg_batch_sharded
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch.parallel import (
    batch_sharding,
    encode_jpeg_stream,
    encode_jpeg_stream_overlapped,
    jpeg_coeffs_sharded,
    make_mesh,
    pipeline,
)
from pixo_tpu_torch.parallel.mesh import replicated

jax.config.update("jax_platforms", "cpu")

H, W = 24, 40


def _jax_options(o: JpegOptions) -> JaxJpegOptions:
    kw = {f.name: getattr(o, f.name) for f in dataclasses.fields(o)}
    kw["color_type"] = JaxColorType(int(o.color_type))
    kw["subsampling"] = JaxSubsampling(o.subsampling.value)
    return JaxJpegOptions(**kw)


def _smooth(rng, b, sigma=3.0, gray=False):
    base = np.add.outer(np.arange(H) * 5, np.arange(W) * 3)[..., None]
    imgs = (base + rng.normal(0, sigma, (b, H, W, 3))).clip(0, 255).astype(np.uint8)
    return np.ascontiguousarray(imgs[..., 0]) if gray else imgs


def _noise(rng, b):
    return rng.integers(0, 256, (b, H, W, 3), dtype=np.uint8)


def _reference(batches, opts):
    jopts = _jax_options(opts)
    return [[jax_encode(im, jopts) for im in batch] for batch in batches]


ROUTES = {
    "standard 4:2:0": JpegOptions(width=W, height=H, quality=85, subsampling=Subsampling.S420),
    "balanced preset": JpegOptions.from_preset(W, H, 85, 1).replace(subsampling=Subsampling.S420),
    "optimal tables, restarts": JpegOptions(width=W, height=H, quality=80, optimal_huffman=True,
                                            restart_interval=2),
    "progressive with SA": JpegOptions(width=W, height=H, quality=85, progressive=True),
    "progressive without SA": JpegOptions(width=W, height=H, quality=85, progressive=True,
                                          progressive_sa=False, optimize_huffman=True),
    "max preset": JpegOptions.max(W, H, 85),
    "gray, restarts": JpegOptions(width=W, height=H, quality=85, color_type=ColorType.GRAY,
                                  restart_interval=3),
}


def _batches(name, rng):
    gray = ROUTES[name].color_type == ColorType.GRAY
    noise = _noise(rng, 2)
    return [_smooth(rng, 3, gray=gray), noise[..., 0].copy() if gray else noise,
            _smooth(rng, 1, gray=gray)]


@pytest.mark.parametrize("name", list(ROUTES))
def test_stream_equals_jax_on_every_route(name):
    opts = ROUTES[name]
    batches = _batches(name, np.random.default_rng(1))
    assert list(encode_jpeg_stream(batches, opts, device="cpu")) == _reference(batches, opts)


@pytest.mark.parametrize("name", list(ROUTES))
def test_overlapped_stream_equals_jax_on_every_route(name):
    opts = ROUTES[name]
    batches = _batches(name, np.random.default_rng(2))
    got = list(encode_jpeg_stream_overlapped(batches, opts, device="cpu", host_workers=3, depth=1))
    assert got == _reference(batches, opts)


def _tier(imgs, opts):
    zz = pipeline.jpeg_coeffs_sharded(imgs, opts, device="cpu")
    state = pipeline._fetch_compacted(zz, kernels.compact_padded(zz, 8))
    return state[3].shape[-1] if state[0] == "padded" else "dense"


@pytest.mark.parametrize("quality, sigma, tier", [(75, 8.0, 16), (90, 6.0, 32), (98, None, "dense")])
@pytest.mark.parametrize("overlapped", [False, True])
def test_cap_escalation_in_mid_stream(overlapped, quality, sigma, tier):
    """A noise batch between two smooth ones escalates the compaction cap
    (or falls back to the dense stream) in its own fetch only."""
    rng = np.random.default_rng(3)
    opts = JpegOptions(width=W, height=H, quality=quality)
    noisy = _noise(rng, 2) if sigma is None else _smooth(rng, 2, sigma)
    calm = np.full((2, H, W, 3), 120, np.uint8)
    calm[1, H // 2:] = 60
    batches = [calm, noisy, calm[::-1].copy()]
    assert [_tier(b, opts) for b in batches] == [8, tier, 8]
    stream = encode_jpeg_stream_overlapped if overlapped else encode_jpeg_stream
    assert list(stream(batches, opts, device="cpu")) == _reference(batches, opts)


def test_overlapped_stats_ordering_contract():
    """One dispatch stamp and one (start, end) interval a stage a batch,
    ordered as the JAX package's test holds them (tests/test_parallel.py)."""
    rng = np.random.default_rng(4)
    opts = ROUTES["standard 4:2:0"]
    a, b = _smooth(rng, 4), _smooth(rng, 2)
    stats = {}
    got = [f for out in encode_jpeg_stream_overlapped([a, b, a, b], opts, device="cpu", stats=stats)
           for f in out]
    single = [f for batch in _reference([a, b], opts) for f in batch]
    assert got == single * 2
    assert len(stats["dispatch_t"]) == len(stats["copy_iv"]) == len(stats["pack_iv"]) == 4
    for (c0, c1), (p0, p1), d in zip(stats["copy_iv"], stats["pack_iv"], stats["dispatch_t"]):
        assert d <= c0 <= c1 <= p1 and c0 <= p0 <= p1


def test_streams_yield_empty_batches_in_place():
    rng = np.random.default_rng(5)
    opts = ROUTES["standard 4:2:0"]
    a = _smooth(rng, 2)
    empty = a[:0]
    want = [_reference([a], opts)[0], [], _reference([a], opts)[0]]
    assert list(encode_jpeg_stream([a, empty, a], opts, device="cpu")) == want
    assert list(encode_jpeg_stream_overlapped([a, empty, a], opts, device="cpu")) == want


def test_streams_take_tensors_and_a_stream_of_one():
    rng = np.random.default_rng(6)
    opts = ROUTES["balanced preset"]
    a = _smooth(rng, 3)
    want = _reference([a], opts)
    assert list(encode_jpeg_stream([torch.from_numpy(a)], opts, device="cpu")) == want
    assert list(encode_jpeg_stream_overlapped(iter([a]), opts, device="cpu")) == want


# ------------------------------------------------------------------- meshes

@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("name", ["standard 4:2:0", "balanced preset", "progressive with SA",
                                  "max preset"])
def test_cpu_mesh_gives_the_files_of_one_device(name, n):
    """A batch of 5 over a mesh of n (shards of 1 or 0 images at n = 8)."""
    opts = ROUTES[name]
    imgs = np.concatenate([_smooth(np.random.default_rng(7), 4), _noise(np.random.default_rng(8), 1)])
    want = encode_jpeg_batch_sharded(imgs, opts, device="cpu")
    assert want == _reference([imgs], opts)[0]
    mesh = make_mesh(n, device="cpu")
    assert encode_jpeg_batch_sharded(imgs, opts, mesh=mesh) == want
    assert list(encode_jpeg_stream([imgs, imgs[:2]], opts, mesh=mesh)) == [want, want[:2]]
    assert list(encode_jpeg_stream_overlapped([imgs], opts, mesh=mesh)) == [want]


def test_mesh_coefficients_equal_one_device():
    imgs = _smooth(np.random.default_rng(9), 5)
    opts = ROUTES["standard 4:2:0"]
    one = jpeg_coeffs_sharded(imgs, opts, device="cpu")
    assert torch.equal(jpeg_coeffs_sharded(imgs, opts, mesh=make_mesh(8, device="cpu")), one)


def test_mesh_and_device_together_raise():
    imgs = _smooth(np.random.default_rng(10), 2)
    opts = ROUTES["standard 4:2:0"]
    mesh = make_mesh(2, device="cpu")
    for dev in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="mesh= or device="):
            encode_jpeg_batch_sharded(imgs, opts, mesh=mesh, device=dev)
        with pytest.raises(ValueError, match="mesh= or device="):
            jpeg_coeffs_sharded(imgs, opts, mesh=mesh, device=dev)
        with pytest.raises(ValueError, match="mesh= or device="):
            list(encode_jpeg_stream([imgs], opts, mesh=mesh, device=dev))
        with pytest.raises(ValueError, match="mesh= or device="):
            list(encode_jpeg_stream_overlapped([imgs], opts, mesh=mesh, device=dev))


def test_mesh_shape_and_shardings():
    mesh = make_mesh(8, device="cpu")
    assert mesh.size == 8 and mesh.axis_names == ("batch",)
    assert all(d == torch.device("cpu") for d in mesh.devices)
    assert make_mesh(device="cpu").size == 1
    assert [(lo, hi) for _, lo, hi in batch_sharding(mesh).ranges(20)] == \
        [(0, 2), (2, 5), (5, 7), (7, 10), (10, 12), (12, 15), (15, 17), (17, 20)]
    assert [(lo, hi) for _, lo, hi in batch_sharding(mesh).ranges(3)] == [(0, 1), (1, 2), (2, 3)]
    assert [(lo, hi) for _, lo, hi in replicated(mesh).ranges(5)] == [(0, 5)] * 8
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    with pytest.raises(ValueError):
        make_mesh(2, device="meta")


def test_shards_cover_the_batch_once_in_order():
    for n in (1, 2, 3, 7, 8):
        mesh = make_mesh(n, device="cpu")
        for b in range(0, 30):
            ranges = batch_sharding(mesh).ranges(b)
            covered = [i for _, lo, hi in ranges for i in range(lo, hi)]
            assert covered == list(range(b))
            sizes = [hi - lo for _, lo, hi in ranges]
            assert all(s >= 1 for s in sizes) and (not sizes or max(sizes) - min(sizes) <= 1)


@pytest.mark.parametrize("fn", [encode_jpeg_stream, encode_jpeg_stream_overlapped,
                                encode_jpeg_batch_sharded, jpeg_coeffs_sharded])
def test_new_entry_points_default_to_the_card(fn):
    params = inspect.signature(fn).parameters
    assert params["device"].default == "cuda" and params["mesh"].default is None
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
