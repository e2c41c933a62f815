"""The port's resize against the JAX package's, on the CPU.

Tolerances, each with its reason:
- ``lanczos_taps``: exact, array for array (the same numpy f32 scalar
  operations in the same order; these tables are the state the port carries
  across).
- Lanczos3 on CPU tensors (the plain version of the CUDA kernel): exact
  against ``pixo_tpu``'s ``resize_lanczos3_np`` and its native host tier,
  which are the authoritative serial f32 order.
- Lanczos3 against ``pixo_tpu``'s jit tier on XLA:CPU: at most 1 level apart
  on at most 0.1% of the samples, because XLA:CPU contracts the tap's
  multiply and add into an FMA (``pixo_tpu/ops/resize_kernels.py:198-203``).
- nearest: exact against the jit tier (a gather).
- bilinear: exact against a numpy mirror of the reference's arithmetic, and
  within 1 level of the jit tier (FMA contraction again).
"""

import numpy as np
import pytest
import torch

import jax

from pixo_tpu import ColorType as JaxColorType
from pixo_tpu import ResizeFilter as JaxResizeFilter
from pixo_tpu import ResizeOptions as JaxResizeOptions
from pixo_tpu import resize as jax_resize_module
from pixo_tpu.native import native_resize_lanczos3 as jax_native_resize
from pixo_tpu.ops import resize_kernels as jrk

from pixo_tpu_torch import ColorType, ResizeFilter, ResizeOptions, errors
from pixo_tpu_torch.native import native_resize_lanczos3
from pixo_tpu_torch.ops import kernels
from pixo_tpu_torch import resize as resize_module
from pixo_tpu_torch.ops import resize_kernels as rk
from pixo_tpu_torch.resize import MAX_RESIZE_DIMENSION, resize, resize_into
from pixo_tpu_torch.utils.synthetic import synth_gradient

jax.config.update("jax_platforms", "cpu")

# (src_h, src_w, dst_h, dst_w): up- and downscales, odd sizes, a tiny target
GEOMETRIES = [(48, 48, 96, 96), (37, 51, 100, 77), (100, 7, 13, 29), (16, 16, 3, 5),
              (128, 128, 32, 32)]
TAP_CASES = [(48, 96), (51, 77), (100, 13), (7, 29), (16, 3), (16, 5), (128, 32), (256, 128),
             (3220, 128), (1812, 128), (128, 128), (1, 4), (9, 1), (1, 1)]


@pytest.mark.parametrize("src,dst", TAP_CASES)
def test_lanczos_taps_equal(src, dst):
    starts, weights = rk.lanczos_taps(src, dst)
    jstarts, jweights = jrk.lanczos_taps(src, dst)
    assert starts.dtype == jstarts.dtype == np.int32 and weights.dtype == np.float32
    np.testing.assert_array_equal(starts, jstarts)
    assert weights.shape == jweights.shape
    np.testing.assert_array_equal(weights.view(np.uint32), jweights.view(np.uint32))


def test_nearest_indices_equal():
    for src, dst in TAP_CASES:
        np.testing.assert_array_equal(rk._nearest_indices(src, dst), jrk._nearest_indices(src, dst))


def _image(geom, c):
    sh, sw = geom[:2]
    return np.random.default_rng(sh * 7 + c).integers(0, 256, (sh, sw, c), dtype=np.uint8)


@pytest.mark.parametrize("geom", GEOMETRIES)
@pytest.mark.parametrize("c", [1, 3, 4])
def test_lanczos3_plain_equals_serial_mirror_and_host_tier(geom, c):
    sh, sw, dh, dw = geom
    img = _image(geom, c)
    want = jrk.resize_lanczos3_np(img, dst_w=dw, dst_h=dh)
    got = rk.resize_lanczos3(torch.from_numpy(img), dst_w=dw, dst_h=dh)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (dh, dw, c)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(rk.resize_lanczos3_np(img, dst_w=dw, dst_h=dh), want)
    sx, wx = rk.lanczos_taps(sw, dw)
    sy, wy = rk.lanczos_taps(sh, dh)
    np.testing.assert_array_equal(native_resize_lanczos3(img, sx, wx, sy, wy), want)
    np.testing.assert_array_equal(jax_native_resize(img, sx, wx, sy, wy), want)
    # the kernel's wrapper and its plain version, given the taps themselves
    for fn in (kernels.resize_lanczos3, kernels.resize_lanczos3_plain):
        np.testing.assert_array_equal(fn(torch.from_numpy(img)[None], sx, wx, sy, wy)[0].numpy(), want)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_lanczos3_batch_equals_per_image(geom):
    sh, sw, dh, dw = geom
    rng = np.random.default_rng(sh + dw)
    imgs = rng.integers(0, 256, (3, sh, sw, 3), dtype=np.uint8)
    got = rk.resize_lanczos3_batch(torch.from_numpy(imgs), dst_w=dw, dst_h=dh).numpy()
    for i in range(3):
        np.testing.assert_array_equal(got[i], jrk.resize_lanczos3_np(imgs[i], dst_w=dw, dst_h=dh))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_lanczos3_close_to_jit_tier(geom):
    sh, sw, dh, dw = geom
    img = _image(geom, 3)
    got = rk.resize_lanczos3(torch.from_numpy(img), dst_w=dw, dst_h=dh).numpy().astype(int)
    jit = np.asarray(jrk.resize_lanczos3(img, dst_w=dw, dst_h=dh)).astype(int)
    diff = np.abs(got - jit)
    assert diff.max() <= 1
    assert (diff != 0).sum() <= max(1, int(0.001 * diff.size))


def test_lanczos3_edge_shapes():
    """A target of one pixel, sources one pixel wide and one high, the same
    size (a pass at scale 1, not a copy), and a window of 153 taps."""
    rng = np.random.default_rng(4)
    for sh, sw, dh, dw, c in ((9, 14, 1, 1, 3), (1, 30, 5, 8, 4), (30, 1, 8, 5, 1),
                              (16, 16, 16, 16, 3), (3, 3220, 2, 128, 3)):
        img = rng.integers(0, 256, (sh, sw, c), dtype=np.uint8)
        got = rk.resize_lanczos3(torch.from_numpy(img), dst_w=dw, dst_h=dh).numpy()
        np.testing.assert_array_equal(got, jrk.resize_lanczos3_np(img, dst_w=dw, dst_h=dh))
    assert rk.lanczos_taps(3220, 128)[1].shape[1] == 153


def test_kernel_wrapper_checks_its_arguments():
    img = torch.zeros((1, 4, 4, 3), dtype=torch.uint8)
    sx, wx = rk.lanczos_taps(4, 2)
    with pytest.raises(TypeError):
        kernels.resize_lanczos3(img.float(), sx, wx, sx, wx)
    with pytest.raises(ValueError):
        kernels.resize_lanczos3(img[0], sx, wx, sx, wx)
    with pytest.raises(ValueError):
        kernels.resize_lanczos3(img.permute(0, 2, 1, 3)[:, :, ::2], sx, wx, sx, wx)
    with pytest.raises(TypeError):
        kernels.resize_lanczos3(img, sx.astype(np.int64), wx, sx, wx)
    with pytest.raises(ValueError):
        kernels.resize_lanczos3(img, sx, wx[:1], sx, wx)
    assert kernels.resize_lanczos3.launches == 0  # no kernel runs for CPU tensors


@pytest.mark.parametrize("geom", GEOMETRIES + [(20, 30, 20, 30)])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_nearest_equals_jit_tier(geom, c):
    sh, sw, dh, dw = geom
    img = _image(geom, c)
    got = rk.resize_nearest(torch.from_numpy(img), dst_w=dw, dst_h=dh).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrk.resize_nearest(img, dst_w=dw, dst_h=dh)))


def _bilinear_np(img, dst_w, dst_h):
    """numpy mirror of pixo_tpu/ops/resize_kernels.py:51-71 (numpy never
    contracts a multiply and an add)."""
    f32 = np.float32
    h, w = img.shape[:2]
    y_ratio = (h - 1) / (dst_h - 1) if dst_h > 1 else 0.0
    x_ratio = (w - 1) / (dst_w - 1) if dst_w > 1 else 0.0
    yf = np.arange(dst_h, dtype=f32) * f32(y_ratio)
    xf = np.arange(dst_w, dtype=f32) * f32(x_ratio)
    y0, x0 = np.floor(yf).astype(np.int32), np.floor(xf).astype(np.int32)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    fy = (yf - y0.astype(f32))[:, None, None]
    fx = (xf - x0.astype(f32))[None, :, None]
    f = img.astype(f32)
    top = f[y0][:, x0] * (f32(1.0) - fx) + f[y0][:, x1] * fx
    bottom = f[y1][:, x0] * (f32(1.0) - fx) + f[y1][:, x1] * fx
    value = top * (f32(1.0) - fy) + bottom * fy
    t = np.trunc(value)
    half_up = np.where(value >= 0, t + 1, t - 1)
    rounded = np.where(np.abs(value - t) == 0.5, half_up, np.round(value))
    return np.clip(rounded, 0.0, 255.0).astype(np.uint8)


@pytest.mark.parametrize("geom", GEOMETRIES + [(9, 9, 1, 1)])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_bilinear_equals_mirror_and_is_close_to_jit_tier(geom, c):
    sh, sw, dh, dw = geom
    img = _image(geom, c)
    got = rk.resize_bilinear(torch.from_numpy(img), dst_w=dw, dst_h=dh).numpy()
    np.testing.assert_array_equal(got, _bilinear_np(img, dw, dh))
    jit = np.asarray(jrk.resize_bilinear(img, dst_w=dw, dst_h=dh)).astype(int)
    assert np.abs(got.astype(int) - jit).max() <= 1


def _opts(cls, filters, cts, sw, sh, dw, dh, f="LANCZOS3", ct="RGBA"):
    return cls(src_width=sw, src_height=sh, dst_width=dw, dst_height=dh,
               color_type=cts[ct], filter=filters[f])


def opts(*a, **kw):
    return _opts(ResizeOptions, ResizeFilter, ColorType, *a, **kw)


def jax_opts(*a, **kw):
    return _opts(JaxResizeOptions, JaxResizeFilter, JaxColorType, *a, **kw)


@pytest.mark.parametrize("f", ["NEAREST", "BILINEAR", "LANCZOS3"])
def test_public_resize_equals_jax_package(f, monkeypatch):
    """Down- and upscale through ``resize()``; the reference's Lanczos3 under
    its host tier, which is the authoritative order (the port has no tiers)."""
    monkeypatch.setenv("PIXO_TPU_RESIZE", "host")
    for img, args, ct in ((synth_gradient(64, 48, 4), (48, 64, 24, 32), "RGBA"),
                          (synth_gradient(16, 12, 3), (12, 16, 24, 32), "RGB")):
        got = resize(img, opts(*args, f=f, ct=ct), device="cpu")
        want = jax_resize_module.resize(img, jax_opts(*args, f=f, ct=ct))
        assert got.shape == (args[3], args[2], img.shape[2])
        if f == "BILINEAR":  # the jit tier contracts; the mirror test is exact
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want)


def test_lanczos_tiers_agree(monkeypatch):
    """``resize()`` equals the reference's serial numpy order and the host
    library's Lanczos3, and reads no tier from the environment."""
    img = np.random.default_rng(0).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    o = opts(56, 40, 21, 15, ct="RGB")
    want = jrk.resize_lanczos3_np(img, dst_w=21, dst_h=15)
    np.testing.assert_array_equal(resize(img, o, device="cpu"), want)
    host = native_resize_lanczos3(img, *rk.lanczos_taps(56, 21), *rk.lanczos_taps(40, 15))
    np.testing.assert_array_equal(host, want)
    calls = []
    monkeypatch.setenv("PIXO_TPU_RESIZE", "host")
    monkeypatch.setattr(resize_module, "resize_lanczos3",
                        lambda *a, **kw: calls.append(1) or rk.resize_lanczos3(*a, **kw))
    np.testing.assert_array_equal(resize(img, o, device="cpu"), want)
    assert calls == [1]


def test_identity_is_a_copy():
    img = synth_gradient(20, 30, 4)
    out = resize(img, opts(30, 20, 30, 20), device="cpu")
    np.testing.assert_array_equal(out, img)
    assert out is not img


def test_gray_2d_and_flat_bytes_inputs():
    img = synth_gradient(40, 40, 3)[..., 0].copy()
    out = resize(img, opts(40, 40, 20, 20, f="BILINEAR", ct="GRAY"), device="cpu")
    assert out.shape == (20, 20)
    want = jax_resize_module.resize(img, jax_opts(40, 40, 20, 20, f="BILINEAR", ct="GRAY"))
    assert np.abs(out.astype(int) - np.asarray(want).astype(int)).max() <= 1
    rgba = synth_gradient(10, 10, 4)
    out = resize(rgba.tobytes(), opts(10, 10, 5, 5), device="cpu")
    assert out.shape == (5, 5, 4)
    np.testing.assert_array_equal(out, resize(rgba, opts(10, 10, 5, 5), device="cpu"))
    buf = bytearray(b"old")
    resize_into(buf, rgba, opts(10, 10, 5, 5), device="cpu")
    assert bytes(buf) == out.tobytes()


def test_validation_errors_in_the_reference_order():
    cases = [(b"", (0, 5, 5, 5)), (b"", (5, 5, 0, 5)), (b"\x00" * 10, (5, 5, 2, 2)),
             (b"", (5, 5, MAX_RESIZE_DIMENSION + 1, 5)), (b"", (0, 5, MAX_RESIZE_DIMENSION + 1, 5)),
             (np.zeros((4, 4, 3), np.uint8), (5, 5, 2, 2))]
    for data, args in cases:
        with pytest.raises(Exception) as want:
            jax_resize_module.resize(data, jax_opts(*args))
        with pytest.raises(errors.PixoError) as got:
            resize(data, opts(*args), device="cpu")
        assert type(got.value).__name__ == type(want.value).__name__
        assert str(got.value) == str(want.value)
