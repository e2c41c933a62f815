"""Playground job function (the reference ``compress-client.ts`` analog).

Counterpart of the JAX package's ``playground.py``: one importable
module-level job, so that the worker-pool service
(``parallel/service.py``) can pickle it into spawned worker processes
(``submit_raw(compress_bytes, data, params, ...)``).

Semantics mirror the reference web client's ``compressImage`` /
``resizeImage`` (``web/src/lib/compress-client.ts:62-117``): decode,
optional Lanczos resize, then PNG or JPEG encode per the form options, with
the JPEG decode's pixels, the resize and the JPEG encode on ``device``.
"""

from __future__ import annotations

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
