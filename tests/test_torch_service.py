"""The port's compression service on the CPU, against the JAX package.

``CompressService(workers=1, device="cpu")`` runs the port's ``png.encode``,
``jpeg.encode``, ``resize.resize`` and the playground job in one spawned
worker; each result must be byte-equal to the JAX package's own call. The
operational contract is the JAX package's (``tests/test_aux.py``): request
ids, the deadline, cancellation and crash-respawn, with the same picklable
tasks (``tests/support/service_tasks.py``). A probe shows that a worker of
a ``device="cpu"`` service never initialized CUDA.
"""

import functools
import io

import numpy as np
import pytest
import torch

import jax

from pixo_tpu import jpeg as jax_jpeg
from pixo_tpu import png as jax_png
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.options import ResizeFilter as JaxResizeFilter
from pixo_tpu.options import ResizeOptions as JaxResizeOptions
from pixo_tpu.options import Subsampling as JaxSubsampling
from pixo_tpu.playground import compress_bytes as jax_compress_bytes
from pixo_tpu.resize import resize as jax_resize

from pixo_tpu_torch import ColorType, JpegOptions, PngOptions, Subsampling
from pixo_tpu_torch.options import ResizeFilter, ResizeOptions
from pixo_tpu_torch.parallel import (
    CompressService,
    RequestCancelled,
    RequestTimeout,
    WorkerCrashed,
)
from pixo_tpu_torch.parallel import service as service_module
from pixo_tpu_torch.playground import compress_bytes
from pixo_tpu_torch.utils.synthetic import synth_gradient
from tests.support.service_tasks import crash_task, sleep_task

jax.config.update("jax_platforms", "cpu")

# a worker's cold start (a spawned interpreter importing torch) can take
# tens of seconds on a loaded host, as the JAX package's tests allow
BOOT_S = 120.0


def _image(h=24, w=32):
    rng = np.random.default_rng(5)
    return (synth_gradient(h, w).astype(np.int32) + rng.integers(-6, 7, (h, w, 3))).clip(0, 255) \
        .astype(np.uint8)


def _png_pair(w, h):
    return (PngOptions.balanced(w, h).replace(color_type=ColorType.RGB),
            JaxPngOptions.balanced(w, h).replace(color_type=JaxColorType.RGB))


def _jpeg_pair(w, h):
    return (JpegOptions(width=w, height=h, quality=85, subsampling=Subsampling.S420),
            JaxJpegOptions(width=w, height=h, quality=85, subsampling=JaxSubsampling.S420))


def _resize_pair(w, h, dw, dh):
    kw = dict(src_width=w, src_height=h, dst_width=dw, dst_height=dh)
    return (ResizeOptions(color_type=ColorType.RGB, filter=ResizeFilter.LANCZOS3, **kw),
            JaxResizeOptions(color_type=JaxColorType.RGB, filter=JaxResizeFilter.LANCZOS3, **kw))


def test_round_trips_equal_jax_with_ordered_ids():
    img = _image()
    popts, jax_popts = _png_pair(32, 24)
    jopts, jax_jopts = _jpeg_pair(32, 24)
    ropts, jax_ropts = _resize_pair(32, 24, 12, 10)
    with CompressService(workers=1, timeout_s=BOOT_S, device="cpu") as svc:
        reqs = [svc.submit_png(img, popts), svc.submit_jpeg(img, jopts), svc.submit_resize(img, ropts),
                svc.submit_png(img, popts)]
        ids = [r.id for r in reqs]
        assert ids == sorted(ids) and len(set(ids)) == 4
        png_a, jpg, small, png_b = [r.result() for r in reqs]
        assert svc.pending_count() == 0
    assert png_a == png_b == jax_png.encode(img, jax_popts)
    assert jpg == jax_jpeg.encode(img, jax_jopts)
    assert isinstance(small, np.ndarray) and small.shape == (10, 12, 3)
    assert np.array_equal(small, jax_resize(img, jax_ropts))


def _jpeg_file(img) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    return buf.getvalue()


@pytest.mark.parametrize("params", [
    {"name": "photo.jpg", "rw": "16", "rh": "12", "quality": "80", "sub420": "true"},
    {"name": "photo.png", "format": "png", "lossless": "true", "preset": "0"},
])
def test_playground_job_in_a_worker_equals_jax(params):
    data = _jpeg_file(_image(40, 48))
    with CompressService(workers=1, timeout_s=BOOT_S, device="cpu") as svc:
        out, meta = svc.submit_raw(functools.partial(compress_bytes, device="cpu"), data,
                                   params).result()
    want, want_meta = jax_compress_bytes(data, params)
    assert out == want
    meta.pop("elapsed_ms")
    want_meta.pop("elapsed_ms")
    assert meta == want_meta


def test_a_cpu_worker_never_initializes_cuda():
    img = _image()
    jopts, _ = _jpeg_pair(32, 24)
    ropts, _ = _resize_pair(32, 24, 16, 12)
    with CompressService(workers=1, timeout_s=BOOT_S, device="cpu") as svc:
        svc.submit_jpeg(img, jopts).result()
        svc.submit_resize(img, ropts).result()
        svc.submit_raw(functools.partial(compress_bytes, device="cpu"), _jpeg_file(img),
                       {"name": "x.jpg", "rw": "8", "rh": "8"}).result()
        # the same worker, after serving both: no CUDA context
        assert svc.submit_raw(torch.cuda.is_initialized).result() is False


def test_timeout_rejects_request():
    with CompressService(workers=1, device="cpu") as svc:
        req = svc.submit_raw(sleep_task, 3.0, timeout=0.3)
        with pytest.raises(RequestTimeout):
            req.result()


def test_cancel_pending():
    with CompressService(workers=1, timeout_s=BOOT_S, device="cpu") as svc:
        # the pool hands a worker one task and queues one more ahead, so
        # the third blocker keeps the request in the service's own queue
        blockers = [svc.submit_raw(sleep_task, 0.5) for _ in range(3)]
        queued = svc.submit_raw(sleep_task, 0.1)
        assert svc.cancel(queued)  # not started yet -> cancellable
        with pytest.raises((RequestCancelled, RequestTimeout)):
            queued.result(timeout=2.0)
        assert [b.result(timeout=BOOT_S) for b in blockers] == ["slept"] * 3


def test_worker_crash_rejects_and_respawns():
    img = _image()
    jopts, jax_jopts = _jpeg_pair(32, 24)
    with CompressService(workers=1, timeout_s=BOOT_S, device="cpu") as svc:
        doomed = svc.submit_raw(crash_task)
        pending = svc.submit_raw(sleep_task, 0.05)
        with pytest.raises(WorkerCrashed):
            doomed.result(timeout=90.0)
        # the requests pending at the crash are rejected ...
        with pytest.raises((WorkerCrashed, RequestCancelled)):
            pending.result(timeout=90.0)
        # ... and the respawned pool serves new ones, the encoders too
        assert svc.submit_raw(sleep_task, 0.01).result(timeout=90.0) == "slept"
        assert svc.submit_jpeg(img, jopts).result(timeout=90.0) == jax_jpeg.encode(img, jax_jopts)


def test_defaults_and_the_default_deadline():
    import inspect

    params = inspect.signature(CompressService).parameters
    assert params["device"].default == "cuda" and params["timeout_s"].default == 120.0
    assert params["workers"].default == 2
    assert inspect.signature(compress_bytes).parameters["device"].default == "cuda"
    # the pool is spawned, not forked: a child of a process that touched
    # CUDA could not use CUDA
    svc = CompressService.__new__(CompressService)
    svc._workers = 1
    pool = svc._spawn()
    try:
        assert pool._mp_context.get_start_method() == "spawn"
        assert pool._initializer is service_module._worker_init
    finally:
        pool.shutdown()
