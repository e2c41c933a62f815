"""The web playground (the reference ``web/`` analog): its HTTP front and its job.

Counterpart of the JAX package's ``playground.py`` (the job) and
``examples/playground.py`` (the front). ``compress_bytes`` is one importable
module-level job, so that the worker-pool service (``parallel/service.py``)
can pickle it into spawned worker processes. Its semantics mirror the
reference web client's ``compressImage`` / ``resizeImage``
(``web/src/lib/compress-client.ts:62-117``): decode, optional Lanczos resize,
then PNG or JPEG encode per the form options, with the JPEG decode's pixels,
the resize and the JPEG encode on ``device``.

The front serves a single-page drag-and-drop compressor on localhost
(``make_handler``, ``main``): ``GET /`` the page, ``POST /compress?<form>``
one job whose result comes back with its ``X-Pixo-Result`` meta, 422 with
the exception's type and message where a job raises, 404 elsewhere. Jobs
run on a ``CompressService`` of two workers on ``device`` (the card by
default), or inline in the request's thread where
``PIXO_TPU_PLAYGROUND_INLINE`` is set. Run it with

    python -m pixo_tpu_torch.playground --port 8077 --device cuda
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time


def compress_bytes(data: bytes, params: dict, *, device="cuda") -> tuple[bytes, dict]:
    """One job: decode -> [resize] -> encode with the requested options."""
    import numpy as np

    from . import jpeg, png
    from .cli import load_image
    from .color import ColorType
    from .options import (
        JpegOptions,
        PngOptions,
        QuantizationMode,
        QuantizationOptions,
        ResizeFilter,
        ResizeOptions,
        Subsampling,
    )
    from .resize import resize as do_resize

    by_channels = {1: ColorType.GRAY, 2: ColorType.GRAY_ALPHA, 3: ColorType.RGB, 4: ColorType.RGBA}
    t0 = time.perf_counter()
    px, w, h, _src_ct = load_image(data, device=device)
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    px = px.reshape(h, w, -1)
    c = px.shape[2]

    rw = int(params.get("rw") or 0)
    rh = int(params.get("rh") or 0)
    if rw and rh:
        ropts = ResizeOptions(src_width=w, src_height=h, dst_width=rw, dst_height=rh,
                              color_type=by_channels[c], filter=ResizeFilter.LANCZOS3)
        px = np.asarray(do_resize(px, ropts, device=device)).reshape(rh, rw, c)
        h, w = rh, rw

    fmt = params.get("format", "auto")
    name = params.get("name", "image")
    if fmt == "auto":
        fmt = "jpeg" if name.lower().endswith((".jpg", ".jpeg")) else "png"
    preset = int(params.get("preset", 1))
    quality = int(params.get("quality", 85))

    if fmt == "jpeg":
        if c == 4:  # strip alpha like the playground's stripAlpha
            px = px[..., :3]
            c = 3
        opts = JpegOptions.from_preset(w, h, quality, preset)
        if c == 1:
            opts.color_type = ColorType.GRAY
            px = px[..., 0]
        opts.subsampling = Subsampling.S420 if params.get("sub420") == "true" else Subsampling.S444
        out = jpeg.encode(np.ascontiguousarray(px), opts, device=device)
        ext, mime = "jpg", "image/jpeg"
    else:
        opts = PngOptions.from_preset(w, h, preset)
        opts.color_type = by_channels[c]
        if params.get("lossless") != "true":
            opts.quantization = QuantizationOptions(mode=QuantizationMode.AUTO, max_colors=256,
                                                    dithering=True)
        out = png.encode(np.ascontiguousarray(px), opts, device=device)
        ext, mime = "png", "image/png"

    stem = name.rsplit(".", 1)[0] or "image"
    meta = {
        "width": w,
        "height": h,
        "out_size": len(out),
        "out_name": f"{stem}.pixo.{ext}",
        "mime": mime,
        "elapsed_ms": (time.perf_counter() - t0) * 1000.0,
    }
    return bytes(out), meta


PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pixo-tpu playground (PyTorch)</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 880px;
        background: #101418; color: #e8e8e8; }
 h1 { font-size: 1.3rem; } h1 span { color: #7ac4ff; }
 #drop { border: 2px dashed #4a5562; border-radius: 12px; padding: 3rem;
         text-align: center; color: #9ab; cursor: pointer; }
 #drop.active { border-color: #7ac4ff; background: #16202a; }
 fieldset { border: 1px solid #2a3542; border-radius: 8px; margin: 1rem 0;
            display: flex; gap: 1.2rem; flex-wrap: wrap; align-items: center; }
 label { font-size: 0.85rem; }
 table { border-collapse: collapse; width: 100%; margin-top: 1rem; }
 td, th { padding: 0.4rem 0.6rem; border-bottom: 1px solid #2a3542;
          font-size: 0.85rem; text-align: left; }
 .savings-pos { color: #7dd87d; } .savings-neg { color: #ff9a7a; }
 img.thumb { max-height: 48px; border-radius: 4px; }
 a { color: #7ac4ff; }
</style></head><body>
<h1><span>pixo-tpu</span> playground: drop PNG/JPEG files to compress</h1>
<div id="drop" tabindex="0" role="button" aria-label="choose images">drop
 images here, click to choose, or paste from the clipboard<input id="file"
 type="file" accept="image/png,image/jpeg" multiple style="display:none"></div>
<fieldset>
 <label>format <select id="format"><option>auto</option><option>png</option>
   <option>jpeg</option></select></label>
 <label>preset <select id="preset"><option value="0">fast</option>
   <option value="1" selected>balanced</option><option value="2">max</option>
   </select></label>
 <label>quality <input id="quality" type="range" min="1" max="100" value="85">
   <span id="qv">85</span></label>
 <label><input id="sub420" type="checkbox" checked> 4:2:0</label>
 <label><input id="lossless" type="checkbox"> PNG lossless</label>
 <label>resize <input id="rw" type="number" placeholder="w" style="width:4.5em">
   x <input id="rh" type="number" placeholder="h" style="width:4.5em"></label>
</fieldset>
<table id="jobs"><thead><tr><th></th><th>name</th><th>dims</th><th>in</th>
 <th>out</th><th>savings</th><th>ms</th><th></th></tr></thead>
 <tbody></tbody></table>
<script>
const $ = id => document.getElementById(id);
$("quality").oninput = () => $("qv").textContent = $("quality").value;
const drop = $("drop");
drop.onclick = () => $("file").click();
$("file").onchange = e => [...e.target.files].forEach(submit);
for (const ev of ["dragover", "dragenter"])
  drop.addEventListener(ev, e => { e.preventDefault(); drop.classList.add("active"); });
for (const ev of ["dragleave", "drop"])
  drop.addEventListener(ev, e => { e.preventDefault(); drop.classList.remove("active"); });
drop.addEventListener("drop", e => [...e.dataTransfer.files].forEach(submit));
// keyboard: the drop zone is focusable; Enter or Space opens the chooser
drop.addEventListener("keydown", e => {
  if (e.key === "Enter" || e.key === " ") { e.preventDefault(); $("file").click(); }
});
// clipboard: paste an image anywhere on the page to submit it
document.addEventListener("paste", e => {
  const files = [...(e.clipboardData?.files || [])]
    .filter(f => f.type.startsWith("image/"));
  if (files.length) { e.preventDefault(); files.forEach(submit); }
});

function fmt(n) { return n >= 1048576 ? (n/1048576).toFixed(2)+" MB"
                       : (n/1024).toFixed(1)+" KB"; }

async function submit(file) {
  const tb = document.querySelector("#jobs tbody");
  const tr = document.createElement("tr");
  tr.innerHTML = `<td></td><td></td><td>...</td>` +
    `<td>${fmt(file.size)}</td><td>...</td><td>...</td><td>...</td><td></td>`;
  tr.cells[1].textContent = file.name;  // never innerHTML: names are untrusted
  tb.appendChild(tr);
  const qs = new URLSearchParams({
    format: $("format").value, preset: $("preset").value,
    quality: $("quality").value, sub420: $("sub420").checked,
    lossless: $("lossless").checked,
    rw: $("rw").value || "", rh: $("rh").value || "",
    name: file.name,
  });
  try {
    const resp = await fetch("/compress?" + qs, { method: "POST",
      body: await file.arrayBuffer() });
    if (!resp.ok) throw new Error(await resp.text());
    const meta = JSON.parse(resp.headers.get("X-Pixo-Result"));
    const blob = await resp.blob();
    const url = URL.createObjectURL(blob);
    const save = 100 * (1 - meta.out_size / file.size);
    tr.cells[0].innerHTML = `<img class="thumb" src="${url}">`;
    tr.cells[2].textContent = meta.width + "x" + meta.height;
    tr.cells[4].textContent = fmt(meta.out_size);
    tr.cells[5].innerHTML = `<span class="${save >= 0 ? "savings-pos" :
      "savings-neg"}">${save.toFixed(1)}%</span>`;
    tr.cells[6].textContent = meta.elapsed_ms.toFixed(0);
    const a = document.createElement("a");
    a.href = url; a.textContent = "save";
    a.download = meta.out_name;  // attribute assignment: no HTML parsing
    tr.cells[7].replaceChildren(a);
  } catch (err) { tr.cells[4].textContent = "error: " + err.message; }
}
</script></body></html>
"""


def _ready() -> bool:
    """A worker's first task: it returns once the worker has started."""
    return True


def make_handler(device="cuda"):
    """The request handler class of the HTTP front, its jobs on ``device``.

    A job runs through a ``CompressService`` of two workers on ``device``,
    started here and held to answer a first task, or, where
    ``PIXO_TPU_PLAYGROUND_INLINE`` is set, inline in the request's thread.
    A service that does not start raises here: the front never falls back
    to inline work or to another device. The class's ``service`` is the
    service (None inline); ``close()`` shuts it down."""
    from http.server import BaseHTTPRequestHandler
    from urllib.parse import parse_qsl, urlparse

    from . import playground  # this module by its package name, also under ``python -m``
    from .parallel.service import CompressService

    job = functools.partial(playground.compress_bytes, device=str(device))
    service = None
    if not os.environ.get("PIXO_TPU_PLAYGROUND_INLINE"):
        service = CompressService(workers=2, device=device)
        try:
            service.submit_raw(_ready).result()
        except BaseException:
            service.close()
            raise

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if urlparse(self.path).path not in ("/", "/index.html"):
                self.send_error(404)
                return
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/compress":
                self.send_error(404)
                return
            params = dict(parse_qsl(url.query))
            data = self.rfile.read(int(self.headers.get("Content-Length", "0")))
            try:
                if service is not None:
                    out, meta = service.submit_raw(job, data, params).result()
                else:
                    out, meta = job(data, params)
            except Exception as e:  # noqa: BLE001 - surfaced to the page
                msg = f"{type(e).__name__}: {e}".encode()
                self.send_response(422)
                self.send_header("Content-Length", str(len(msg)))
                self.end_headers()
                self.wfile.write(msg)
                return
            self.send_response(200)
            self.send_header("Content-Type", meta["mime"])
            self.send_header("Content-Length", str(len(out)))
            self.send_header("X-Pixo-Result", json.dumps(meta))
            self.end_headers()
            self.wfile.write(out)

        @staticmethod
        def close() -> None:
            if service is not None:
                service.close()

    Handler.service = service
    return Handler


def main(argv=None) -> int:
    """``python -m pixo_tpu_torch.playground [--port 8077] [--device cuda]``:
    serve the playground on 127.0.0.1 until interrupted."""
    from http.server import ThreadingHTTPServer

    ap = argparse.ArgumentParser(prog="python -m pixo_tpu_torch.playground",
                                 description="the pixo web playground on localhost")
    ap.add_argument("--port", type=int, default=8077)
    ap.add_argument("--device", default="cuda", help="where jobs compute: cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    handler = make_handler(args.device)
    srv = ThreadingHTTPServer(("127.0.0.1", args.port), handler)
    print(f"pixo-tpu playground on {args.device}: http://127.0.0.1:{srv.server_address[1]}/", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
        handler.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
