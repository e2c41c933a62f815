"""The port's web playground (its HTTP front and job) and demo against the
JAX package's, on the CPU.

The front is served on 127.0.0.1 with ``make_handler("cpu")``: inline
(``PIXO_TPU_PLAYGROUND_INLINE``) as the JAX package's ``TestPlayground``
drives its own, and once through the default ``CompressService`` of two
spawned CPU workers. The page answers ``GET /``, jobs ``POST /compress``,
a bad body 422 with the exception's type and message, anything else 404;
every job's file is byte-equal to ``pixo_tpu.playground.compress_bytes`` on
the same input and form, run as the JAX package's front runs it on the CPU
(its ``make_handler`` pins the host coefficient and resize tiers there:
``PIXO_TPU_COEFFS=host``, ``PIXO_TPU_RESIZE=host``, set here under
``monkeypatch``), and its ``X-Pixo-Result`` meta equal but for the time.
The demo's files are byte-equal to the JAX package's encodes.
"""

import http.client
import inspect
import io
import json
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
from PIL import Image

import jax

from pixo_tpu import jpeg as jax_jpeg
from pixo_tpu import png as jax_png
from pixo_tpu.options import JpegOptions as JaxJpegOptions
from pixo_tpu.options import PngOptions as JaxPngOptions
from pixo_tpu.options import QuantizationMode as JaxQuantizationMode
from pixo_tpu.color import ColorType as JaxColorType
from pixo_tpu.playground import compress_bytes as jax_compress_bytes

from pixo_tpu_torch import demo, playground
from pixo_tpu_torch.parallel import service
from pixo_tpu_torch.utils.synthetic import synth_gradient

jax.config.update("jax_platforms", "cpu")


def _png(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def _jpeg(img) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=90)
    return buf.getvalue()


SRC = {"gradient.png": _png(synth_gradient(48, 64, 3)), "photo.jpg": _jpeg(synth_gradient(40, 56, 3))}

# TestPlayground's three jobs, then a lossy PNG, a PNG from a JPEG and a max-preset JPEG
JOBS = [
    ("format=png&preset=1&lossless=true&name=t.png", "PNG"),
    ("format=jpeg&preset=1&quality=85&sub420=true&name=t.png", "JPEG"),
    ("format=auto&preset=0&quality=70&rw=32&rh=24&name=t.jpg", "JPEG"),
    ("format=auto&preset=1&name=t.png", "PNG"),
    ("format=png&preset=0&lossless=true&rw=20&rh=30&name=photo.jpg", "PNG"),
    ("format=jpeg&preset=2&quality=80&sub420=false&name=t.jpg", "JPEG"),
]


@pytest.fixture(autouse=True)
def _jax_front_tiers(monkeypatch):
    """The tiers the JAX package's front pins on the CPU backend."""
    monkeypatch.setenv("PIXO_TPU_COEFFS", "host")
    monkeypatch.setenv("PIXO_TPU_RESIZE", "host")


def _serve(handler):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture()
def server(monkeypatch):
    monkeypatch.setenv("PIXO_TPU_PLAYGROUND_INLINE", "1")
    handler = playground.make_handler("cpu")
    assert handler.service is None
    srv = _serve(handler)
    yield srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _request(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, headers, data


def _check_job(port, qs, fmt, src):
    from urllib.parse import parse_qsl

    status, headers, out = _request(port, "POST", f"/compress?{qs}", SRC[src])
    assert status == 200, out
    meta = json.loads(headers["X-Pixo-Result"])
    back = Image.open(io.BytesIO(out))
    assert back.format == fmt and back.size == (meta["width"], meta["height"])
    assert headers["Content-Type"] == meta["mime"]
    want, want_meta = jax_compress_bytes(SRC[src], dict(parse_qsl(qs)))
    assert out == want
    meta.pop("elapsed_ms")
    want_meta.pop("elapsed_ms")
    assert meta == want_meta


def test_page_and_404(server):
    status, headers, page = _request(server, "GET", "/")
    assert status == 200 and "pixo-tpu" in page.decode()
    assert headers["Content-Type"].startswith("text/html")
    assert _request(server, "GET", "/index.html")[0] == 200
    assert _request(server, "GET", "/compress")[0] == 404
    assert _request(server, "POST", "/elsewhere", b"x")[0] == 404


@pytest.mark.parametrize("src", list(SRC))
@pytest.mark.parametrize("qs,fmt", JOBS, ids=[q for q, _ in JOBS])
def test_jobs_equal_jax(server, qs, fmt, src):
    _check_job(server, qs, fmt, src)


@pytest.mark.parametrize("body", [b"not an image", b"", SRC["photo.jpg"][:40]], ids=["junk", "empty", "truncated"])
def test_bad_input_is_422(server, body):
    status, _, msg = _request(server, "POST", "/compress?format=png&name=x.png", body)
    assert status == 422
    with pytest.raises(Exception) as info:
        jax_compress_bytes(body, {"format": "png", "name": "x.png"})
    assert msg.decode() == f"{type(info.value).__name__}: {info.value}"


def test_jobs_through_the_service():
    """Without ``PIXO_TPU_PLAYGROUND_INLINE`` the front starts a service of
    two workers on its device and sends every job there."""
    handler = playground.make_handler("cpu")
    assert isinstance(handler.service, service.CompressService)
    srv = _serve(handler)
    try:
        for qs, fmt in JOBS[:3]:
            _check_job(srv.server_address[1], qs, fmt, "gradient.png")
        assert _request(srv.server_address[1], "POST", "/compress?format=png", b"junk")[0] == 422
    finally:
        srv.shutdown()
        srv.server_close()
        handler.close()


def test_a_service_that_does_not_start_raises(monkeypatch):
    """No silent switch to inline work: the front raises, and closes the
    service it started."""
    closed = []

    class Broken:
        def __init__(self, workers, device):
            assert (workers, device) == (2, "cuda")

        def submit_raw(self, fn, *args):
            raise service.WorkerCrashed("no worker started")

        def close(self):
            closed.append(True)

    monkeypatch.delenv("PIXO_TPU_PLAYGROUND_INLINE", raising=False)
    monkeypatch.setattr(service, "CompressService", Broken)
    with pytest.raises(service.WorkerCrashed):
        playground.make_handler()
    assert closed == [True]


def test_main_serves_and_stops(monkeypatch, capsys):
    served = []

    class Server:
        def __init__(self, address, handler):
            served.append((address, handler))
            self.server_address = (address[0], 8123)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            served.append("closed")

    monkeypatch.setenv("PIXO_TPU_PLAYGROUND_INLINE", "1")
    monkeypatch.setattr("http.server.ThreadingHTTPServer", Server)
    assert playground.main(["--port", "0", "--device", "cpu"]) == 0
    assert served[0][0] == ("127.0.0.1", 0) and served[-1] == "closed"
    assert "http://127.0.0.1:8123/" in capsys.readouterr().out


def test_the_card_is_the_default():
    assert inspect.signature(playground.make_handler).parameters["device"].default == "cuda"
    assert inspect.signature(playground.compress_bytes).parameters["device"].default == "cuda"
    for fn in (demo.compress_every_way, demo.thumbnail_round_trip):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------------ the demo


def _photo(h=30, w=44):
    g = synth_gradient(h, w, 3).astype(np.int32)
    return np.clip(g + np.random.default_rng(5).integers(-18, 19, g.shape), 0, 255).astype(np.uint8)


def test_demo_files_equal_jax():
    img = _photo()
    h, w = img.shape[:2]
    rgb = dict(color_type=JaxColorType.RGB)
    lossy = JaxPngOptions.balanced(w, h).replace(**rgb)
    lossy.quantization.mode = JaxQuantizationMode.FORCE
    lossy.quantization.max_colors = 128
    lossy.quantization.dithering = True
    want = [jax_jpeg.encode(img, JaxJpegOptions.fast(w, h, 85)),
            jax_jpeg.encode(img, JaxJpegOptions.balanced(w, h, 85)),
            jax_jpeg.encode(img, JaxJpegOptions.max(w, h, 85)),
            jax_png.encode(img, JaxPngOptions.fast(w, h).replace(**rgb)),
            jax_png.encode(img, JaxPngOptions.balanced(w, h).replace(**rgb)),
            jax_png.encode(img, JaxPngOptions.max(w, h).replace(**rgb)),
            jax_png.encode(img, lossy)]
    got = demo.compress_every_way(img, device="cpu")
    assert [bytes(x) for x in want] == [out for _, out in got]
    thumb = Image.open(io.BytesIO(demo.thumbnail_round_trip(img, device="cpu")))
    assert thumb.format == "JPEG" and thumb.size == (128, 128)


def test_demo_main_on_a_file(tmp_path, capsys):
    path = tmp_path / "in.png"
    path.write_bytes(_png(_photo(20, 28)))
    assert demo.main([str(path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "(28x20," in out and "PNG lossy 128c dithered" in out and "thumbnail pipeline" in out
