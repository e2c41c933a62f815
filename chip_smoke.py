#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's batched JPEG and PNG encodes and
its batched JPEG decode.

Run from the root of a checkout, on a machine with one NVIDIA GPU (built for
the H100, sm_90a):

    python3 chip_smoke.py

It imports only ``pixo_tpu_torch`` (no JAX) and runs four phases, each
printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of both native libraries from the checkout's
   sources (the CUDA kernels and the C++ host tier), with their build times;
2. every kernel of both paths against its plain PyTorch version on the
   card, for bit equality: the coefficient kernel in all four modes on the
   16x512x512 gradient batch and on a 4x517x389 noise batch (odd sizes pad),
   also held against the host library's coefficients image by image; the
   standalone AAN DCT on 100k random blocks; the compaction kernel at caps
   8, 16 and 32; the PNG filter bank and the fused filter kernel for bpp 1,
   2, 3, 4, 6 and 8 (odd row lengths, one-row images, rows no longer than
   a pixel, 262,140-byte rows, the corpus batch), the fused kernel in every
   ported strategy with the sticky rule off and on, also held against the
   host library's filter image by image; the decode-tail kernel on the
   coefficients of decode batches (d1) and (d3) and on 100k blocks at the
   int16 extremes with tables of 255 and 65535 (int32 wraps), and the
   standalone integer IDCT on the same blocks;
3. the JPEG main path, ``encode_jpeg_batch_sharded(..., device="cuda")`` on
   the 16x512x512 gradient batch at q85 4:2:0, with each image's bytes held
   against the host library's fused encode in the same marker frame, and
   the launch count of each kernel; then noise batches that escalate the
   compaction cap to 16 and to 32, one that falls back to the dense stream,
   and a 4:4:4 batch with restart markers. Then the PNG main path,
   ``encode_png_batch_sharded(..., device="cuda")``, on (a) 16 512x512 RGB
   photos (the four corpus fixtures and three shifts of each) under the
   balanced preset, with the fused filter kernel's launch count, (b) the
   16x512x512 gradient batch under the fast preset and (c) a 512x512 RGBA
   batch that takes every route (pass, strip, gray-alpha) and both
   per-image fallbacks (gray, palette); every file is held against the
   per-image ``png.encode`` (which filters on the host) and (a) and (b)
   also decode back to their input. Then the decode main path,
   ``decode_jpeg_batch(files, device="cuda")``, on (d1) the 16 gradient
   JPEGs of the encode phase, (d2) the corpus batch encoded by the port,
   (d3) the golden oracle set's 9 baseline files (up to 3220x1812) and the
   four progressive photo fixtures in one mixed batch, and (d4) gray,
   4:4:4, 4:2:2 and restart batches of odd sizes, fancy upsampling off (and
   on for (d2) and (d3)); every image is held against the host library's
   two-stage decode and each baseline one against its fused decode, and the
   decode-tail kernel launches once per batch. The oracle set's 7
   progressive files, which the reference decoder rejects, must be rejected;
4. median timings over warm runs: each kernel against its plain version,
   the copy of the pixels to the card, the device stage with kernels and
   with plain PyTorch, the copy of the results to the host, the host pack
   or DEFLATE and the whole encode, for JPEG and for PNG batches (a) and
   (b); and for decode batches (d1) and (d3) the host stage with 8 workers
   and with 1, and its parts (parse, buffer, the Python work of each call,
   the library calls on 1 and 8 threads, the progressive files), the copy
   of the coefficients, the kernel, the upsampling and colour, the device
   stage with the kernel and in plain PyTorch, the copy of the pixels back,
   the whole decode, and the host library's decode of the same batch on 8
   threads and on 1; for (d3) also each file's host stage alone.

Any mismatch or error exits non-zero. Without a CUDA device it exits 1
before printing any result. The line before the last is the kernels' JSON
record; the last line is the run's JSON result.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import time

BATCH, SIZE, QUALITY = 16, 512, 85
WARM_RUNS = 20
CORPUS = ("browser", "playground", "rocket", "web")
CORPUS_SHIFTS = ((0, 0), (0, 64), (128, 0), (200, 300))


class Failed(Exception):
    """A check disagreed; the message says which."""


def _verdict(line: str, ok: bool) -> None:
    print(f"{line} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise Failed(line)


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def read_png(path: str):
    """The pixels of the PNG file at ``path`` (see ``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def decode_png(data: bytes):
    """An 8-bit, non-interlaced PNG of colour type 0, 2, 4 or 6 -> [H, W, C]
    uint8, read with the stdlib's zlib and a numpy unfilter, so the card's
    machine needs no image library. Each anti-diagonal y + x = d of pixels
    depends only on earlier ones (left, up, upper-left), so the unfilter
    runs one vectorized step per diagonal."""
    import struct
    import zlib

    import numpy as np

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + length
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace or ctype not in (0, 2, 4, 6):
        raise ValueError("only 8-bit non-interlaced gray/RGB(A) PNGs are read")
    c = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, w * c + 1)
    types = raw[:, 0].astype(np.int32)
    filt = raw[:, 1:].reshape(h, w, c).astype(np.int32)
    recon = np.zeros((h + 1, w + 1, c), np.int32)  # a zero row above, a zero column left
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        xs = d - ys
        a, b, ul = recon[ys + 1, xs], recon[ys, xs + 1], recon[ys, xs]
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        t = types[ys][:, None]
        pred = np.select([t == 0, t == 1, t == 2, t == 3], [np.zeros_like(a), a, b, (a + b) >> 1],
                         paeth)
        recon[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return recon[1:, 1:].astype(np.uint8)


def gradient_batch(batch: int, size: int):
    """The bench's input: shifted copies of one synthetic gradient."""
    import numpy as np

    from pixo_tpu_torch.utils.synthetic import synth_gradient

    base = synth_gradient(size, size)
    shifts = np.random.default_rng(0).integers(0, 17, batch)
    return np.stack([np.roll(base, int(s), axis=1) for s in shifts])


def corpus_batch():
    """PNG batch (a): each corpus fixture and three np.roll shifts of it."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    imgs = []
    for name in CORPUS:
        img = read_png(os.path.join(here, "tests", "fixtures", f"corpus_{name}_512.png"))
        imgs += [np.roll(img, shift, axis=(0, 1)) for shift in CORPUS_SHIFTS]
    return np.stack(imgs)


def routing_batch(size: int):
    """PNG batch (c), as tests/test_parallel.py:72-116 builds it: one RGBA
    image per route of the balanced batch (pass, strip, gray-alpha), one per
    per-image fallback (gray, palette) and three of noise."""
    import numpy as np

    rng = np.random.default_rng(7)
    h = w = size
    noisy = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    noisy[::7, ::3, 3] = 0
    opaque = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    opaque[..., 3] = 255
    g = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    gray_alpha = np.concatenate([g, g, g, rng.integers(0, 255, (h, w, 1), dtype=np.uint8)], -1)
    gray = np.concatenate([g, g, g, np.full((h, w, 1), 255, np.uint8)], -1)
    palette = np.zeros((h, w, 4), np.uint8)
    palette[..., 0] = (np.arange(w) % 7 * 30).astype(np.uint8)
    palette[..., 3] = 255
    rest = [rng.integers(0, 256, (h, w, 4), dtype=np.uint8) for _ in range(3)]
    return np.stack([noisy, opaque, gray_alpha, gray, palette, *rest])


def png_cases(corpus, grad) -> dict:
    """The PNG main path's batches (a) and (b): (label, options, images)."""
    from pixo_tpu_torch import ColorType, PngOptions

    rgb = dict(color_type=ColorType.RGB)
    return {
        "a": ("corpus RGB balanced", PngOptions.balanced(SIZE, SIZE).replace(**rgb), corpus),
        "b": ("gradient RGB fast", PngOptions.fast(SIZE, SIZE).replace(**rgb), grad),
    }


def host_decode(data: bytes, fancy: bool = False, fused: bool = False):
    """The host library's decode of one JPEG, the oracle the device decode
    is held against: the file's entropy stage (the native baseline scan
    decoder, or the native progressive segments) into coefficient planes,
    then the native pixel tail ``jpeg_decode_pixels``; with ``fused``, the
    fused baseline decode ``jpeg_decode_baseline`` instead. Returns the
    pixels, or None where the host library declines the geometry."""
    import numpy as np

    from pixo_tpu_torch import native
    from pixo_tpu_torch.decode import jpeg_decoder as jd

    scan = jd._parse(data)
    comps = scan.components
    ch, cv = [c.h for c in comps], [c.v for c in comps]
    geometry = (scan.mcu_cols, scan.mcu_rows, scan.max_h, scan.max_v, scan.width, scan.height)
    if fused:
        segments, _ = jd._split_entropy(data[scan.pos:])
        return native.native_jpeg_decode_baseline(
            segments, scan.restart_interval, scan.mcu_cols * scan.mcu_rows, scan.mcu_cols,
            scan.mcu_rows, ch, cv, scan.max_h, scan.max_v, scan.width, scan.height,
            [scan.dc_specs[c.dc_table] for c in comps], [scan.ac_specs[c.ac_table] for c in comps],
            [scan.qtables[c.quant_id] for c in comps], fancy=fancy,
        )
    planes = [np.zeros((bw * bh, 64), np.int16) for bw, bh in scan.plane_blocks()]
    qtables = jd._decode_entropy(scan, planes)
    return native.native_jpeg_decode_pixels(planes, qtables, ch, cv, *geometry, fancy=fancy)


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from pixo_tpu_torch.ops import kernels

    for fn in (kernels.coeffs, kernels.compact_padded, kernels.dct8x8_aan,
               kernels.filter_bank, kernels.filter_rows, kernels.idct_planes,
               kernels.idct8x8_int):
        fn.launches = 0


def event_ms(fn, calls=10, reps=5):
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls, per call: the device time whenever the device, and not the host's
    launching, is the bound."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return _median(times)


def wall_ms(fn):
    """Median host-clock time of WARM_RUNS calls, each synchronized."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(WARM_RUNS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times)


def check_kernels(dev, grad, noise, n_dct: int) -> dict:
    """Phase 2: each kernel against its plain version on ``dev``, and the
    coefficient kernel against the host library. Returns the largest
    absolute error of each kernel of the path."""
    import numpy as np
    import torch

    from pixo_tpu_torch import native
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.dct import dct8x8_aan as dct_plain
    from pixo_tpu_torch.ops.sparse_pack import sparsify_blocks_padded_batch

    quant = QuantizationTables(QUALITY)
    lum, chrom = quant.luminance_table, quant.chrominance_table
    errs = {"coeffs": 0, "compact": 0}
    zz_cases = []
    for name, batch in (("gradient", grad), ("noise", noise)):
        label = f"{name} {'x'.join(map(str, batch.shape[:3]))}"
        for mode in ("gray", "444", "420", "422"):
            host = np.ascontiguousarray(batch[..., 0] if mode == "gray" else batch)
            x = torch.from_numpy(host).to(dev)
            got = kernels.coeffs(x, lum, chrom, mode)
            ref = kernels.coeffs_plain(x, lum, chrom, mode)
            err = int((got.int() - ref.int()).abs().max())
            errs["coeffs"] = max(errs["coeffs"], err)
            got_h = got.cpu().numpy()
            host_bad = sum(
                not np.array_equal(got_h[i], native.native_jpeg_coefficients(host[i], mode, lum, chrom))
                for i in range(len(host))
            )
            _verdict(f"check coeffs mode={mode} {label} q{QUALITY}: max_abs_err vs plain {err}, "
                     f"images differing from the host library {host_bad}/{len(host)}",
                     err == 0 and host_bad == 0)
            if mode in ("420", "444"):
                zz_cases.append((f"{label} {mode}", got))

    blocks = torch.from_numpy(
        np.random.default_rng(2).uniform(-128, 127, (n_dct, 8, 8)).astype(np.float32)
    ).to(dev)
    d_got, d_ref = kernels.dct8x8_aan(blocks), dct_plain(blocks)
    equal = torch.equal(d_got.view(torch.int32), d_ref.view(torch.int32))
    _verdict(f"check dct8x8_aan {n_dct} blocks: bitwise equal {equal}, "
             f"max_abs_err {float((d_got - d_ref).abs().max())}", equal)

    for label, zz in zz_cases:
        for cap in (8, 16, 32):
            got = kernels.compact_padded(zz, cap)
            ref = sparsify_blocks_padded_batch(zz, cap)
            err = max(int((g.int() - r.int()).abs().max()) for g, r in zip(got, ref))
            errs["compact"] = max(errs["compact"], err)
            overflow = int((got[1].int() > cap).sum())
            _verdict(f"check compact cap={cap} {label}: max_abs_err vs plain {err}, "
                     f"overflow blocks {overflow}", err == 0)
    return errs


def _host_reference(imgs, opts):
    """Each image's JPEG from the host library's fused coefficient+pack
    call, in the pipeline's own marker frame."""
    from pixo_tpu_torch import native
    from pixo_tpu_torch.color import ColorType
    from pixo_tpu_torch.jpeg.tables import HuffmanTables, QuantizationTables
    from pixo_tpu_torch.ops.blockify import scan_layout
    from pixo_tpu_torch.parallel.pipeline import _assemble_jpeg

    quant = QuantizationTables(opts.quality)
    gray = opts.color_type == ColorType.GRAY
    mode = "gray" if gray else opts.subsampling.value
    _, _, pattern = scan_layout(opts.width, opts.height, "gray" if gray else "rgb",
                                opts.subsampling.value)
    return [
        _assemble_jpeg(
            native.native_jpeg_encode_scan(
                im, mode, quant.luminance_table, quant.chrominance_table, pattern,
                HuffmanTables.default(), opts.restart_interval,
            ),
            opts, quant,
        )
        for im in imgs
    ]


def _check_bytes(dev, label, imgs, opts, expect_tier) -> None:
    from pixo_tpu_torch import encode_jpeg_batch_sharded
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.parallel.pipeline import _fetch_compacted, jpeg_coeffs_sharded

    zz = jpeg_coeffs_sharded(imgs, opts, device=dev)
    state = _fetch_compacted(zz, kernels.compact_padded(zz, 8))
    tier = state[3].shape[-1] if state[0] == "padded" else "dense"
    outs = encode_jpeg_batch_sharded(imgs, opts, device=dev)
    same = sum(a == b for a, b in zip(outs, _host_reference(imgs, opts)))
    framed = all(o[:2] == b"\xff\xd8" and o[-2:] == b"\xff\xd9" for o in outs)
    _verdict(f"main path {label}: {same}/{len(imgs)} images byte-equal to the host encode, "
             f"compaction tier {tier}, mean {sum(map(len, outs)) / len(outs):.0f} B/image",
             same == len(imgs) and framed and tier == expect_tier)


def check_main_path(dev, grad) -> dict:
    """Phase 3: the main path on the gradient batch, with the launch count
    of each kernel, then the escalation, dense and restart batches.
    Returns the launch counts of the main path's run."""
    import numpy as np

    from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.utils.synthetic import synth_gradient

    b, size = grad.shape[0], grad.shape[1]
    opts = JpegOptions(width=size, height=size, quality=QUALITY, subsampling=Subsampling.S420)
    reset_counts()
    outs = encode_jpeg_batch_sharded(grad, opts, device=dev)
    launches = {"coeffs": kernels.coeffs.launches, "compact": kernels.compact_padded.launches}
    same = sum(a == c for a, c in zip(outs, _host_reference(grad, opts)))
    _verdict(f"main path gradient {b}x{size}x{size} q{QUALITY} 4:2:0: {same}/{b} images "
             f"byte-equal to the host encode; launches {launches}", same == b)

    base = synth_gradient(size, size).astype(np.float64)
    rng = np.random.default_rng(3)
    light = (base + rng.normal(0, 4, (4, size, size, 3))).clip(0, 255).astype(np.uint8)
    mid = (base + rng.normal(0, 5, (4, size, size, 3))).clip(0, 255).astype(np.uint8)
    dense = rng.integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    _check_bytes(dev, "noise sigma 4 q85 4:2:0", light, opts, 16)
    _check_bytes(dev, "noise sigma 5 q90 4:2:0", mid, opts.replace(quality=90), 32)
    _check_bytes(dev, "uniform noise q98 4:2:0", dense, opts.replace(quality=98), "dense")
    _check_bytes(dev, "gradient q85 4:4:4 restart 4", grad[:4],
                 opts.replace(subsampling=Subsampling.S444, restart_interval=4), 8)
    return launches


def time_everything(dev, grad, n_dct: int, card: str) -> dict:
    """Phase 4: median times on the card. Kernel times are CUDA-event times
    per call (``event_ms``); stage times are host-clock times of one call
    ending in a synchronize (``wall_ms``)."""
    import numpy as np
    import torch

    from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.blockify import scan_layout
    from pixo_tpu_torch.ops.dct import dct8x8_aan as dct_plain
    from pixo_tpu_torch.ops.sparse_pack import sparsify_blocks_padded_batch
    from pixo_tpu_torch.parallel.pipeline import _fetch_compacted, _pack_hosted, jpeg_coeffs_sharded

    b, size = grad.shape[0], grad.shape[1]
    shape = f"{b}x{size}x{size}"
    mp = b * size * size / 1e6
    opts = JpegOptions(width=size, height=size, quality=QUALITY, subsampling=Subsampling.S420)
    quant = QuantizationTables(QUALITY)
    lum, chrom = quant.luminance_table, quant.chrominance_table
    grad_dev = torch.from_numpy(grad).to(dev)
    zz = kernels.coeffs(grad_dev, lum, chrom, "420")
    blocks = torch.from_numpy(
        np.random.default_rng(2).uniform(-128, 127, (n_dct, 8, 8)).astype(np.float32)
    ).to(dev)

    k_ms = {
        "coeffs": (event_ms(lambda: kernels.coeffs(grad_dev, lum, chrom, "420")),
                   event_ms(lambda: kernels.coeffs_plain(grad_dev, lum, chrom, "420"))),
        "compact": (event_ms(lambda: kernels.compact_padded(zz, 8)),
                    event_ms(lambda: sparsify_blocks_padded_batch(zz, 8))),
        "dct8x8_aan": (event_ms(lambda: kernels.dct8x8_aan(blocks)),
                       event_ms(lambda: dct_plain(blocks))),
    }
    for name, (ms, plain_ms) in k_ms.items():
        at = f"{n_dct} blocks" if name == "dct8x8_aan" else f"{shape} q{QUALITY} 4:2:0"
        print(f"kernel {name} {at}: {ms:.4f} ms per call, plain PyTorch {plain_ms:.4f} ms "
              f"[{card}]")

    _, _, pattern = scan_layout(size, size, "rgb", "420")
    compacted = kernels.compact_padded(zz, 8)
    state = _fetch_compacted(zz, compacted)
    stages = {
        "h2d": wall_ms(lambda: torch.from_numpy(grad).to(dev)),
        "device_kernels": wall_ms(
            lambda: kernels.compact_padded(jpeg_coeffs_sharded(grad_dev, opts, device=dev), 8)),
        "device_plain": wall_ms(lambda: sparsify_blocks_padded_batch(
            kernels.coeffs_plain(grad_dev, lum, chrom, "420"), 8)),
        "d2h": wall_ms(lambda: _fetch_compacted(zz, compacted)),
        "host_pack": wall_ms(lambda: _pack_hosted(state, opts, pattern, 8)),
        "end_to_end": wall_ms(lambda: encode_jpeg_batch_sharded(grad, opts, device=dev)),
    }
    for name, ms in stages.items():
        print(f"stage {name} {shape} q{QUALITY} 4:2:0: median {ms:.4f} ms, "
              f"{mp / (ms / 1e3):.1f} MP/s over {WARM_RUNS} warm runs [{card}]")
    return k_ms


def check_png_kernels(dev, corpus) -> dict:
    """Phase 2, PNG: both filter kernels against their plain versions on
    ``dev``, and the fused kernel against the host library's filter image by
    image. Returns the largest absolute error of each kernel."""
    import numpy as np
    import torch

    from pixo_tpu_torch import FilterStrategy
    from pixo_tpu_torch.native import native_png_filter
    from pixo_tpu_torch.ops import kernels, png_filters

    rng = np.random.default_rng(4)
    strategies = [s for s in FilterStrategy if s != FilterStrategy.BIGRAMS]
    errs = {"filter_bank": 0, "filter_rows": 0}
    y, x = np.mgrid[0:16, 0:300]
    ramp = np.broadcast_to(((y + x) % 256).astype(np.uint8), (2, 16, 300))  # tied scores
    for bpp in (1, 2, 3, 4, 6, 8):
        cases = [
            ("noise 4x33x1001", rng.integers(0, 256, (4, 33, 1001), dtype=np.uint8)),
            ("low noise 2x40x1001", rng.integers(0, 12, (2, 40, 1001), dtype=np.uint8)),
            ("ramp 2x16x300", np.ascontiguousarray(ramp)),
            ("one row 2x1x77", rng.integers(0, 256, (2, 1, 77), dtype=np.uint8)),
            (f"RB=bpp 2x5x{bpp}", rng.integers(0, 256, (2, 5, bpp), dtype=np.uint8)),
            (f"RB<=bpp 2x3x{max(bpp // 2, 1)}",
             rng.integers(0, 256, (2, 3, max(bpp // 2, 1)), dtype=np.uint8)),
            ("long rows 1x3x262140", rng.integers(0, 256, (1, 3, 262140), dtype=np.uint8)),
        ]
        if bpp == 3:
            cases.append((f"corpus {corpus.shape[0]}x{SIZE}x{SIZE * 3}",
                          corpus.reshape(corpus.shape[0], SIZE, SIZE * 3)))
        for label, host in cases:
            rows = torch.from_numpy(host).to(dev)
            got, ref = kernels.filter_bank(rows, bpp), kernels.filter_bank_plain(rows, bpp)
            err_bank = max(int((g.int() - r.int()).abs().max()) for g, r in zip(got, ref))
            err_rows, host_bad, n = 0, 0, 0
            for strategy in strategies:
                for sticky in (False, True):
                    kw = dict(bpp=bpp, strategy=strategy, small_image=False, sticky_fast=sticky)
                    out = kernels.filter_rows(rows, **kw)
                    plain = png_filters.filter_rows_plain(rows, **kw)
                    err_rows = max(err_rows, int((out.int() - plain.int()).abs().max()))
                    mode = png_filters.native_mode(strategy)
                    out_h = out.cpu().numpy()
                    host_bad += sum(
                        not np.array_equal(out_h[i], native_png_filter(host[i], bpp, mode,
                                                                       sticky and mode == 6))
                        for i in range(len(host))
                    )
                    n += len(host)
            errs["filter_bank"] = max(errs["filter_bank"], err_bank)
            errs["filter_rows"] = max(errs["filter_rows"], err_rows)
            _verdict(f"check filter bpp={bpp} {label}: filter_bank max_abs_err vs plain {err_bank}; "
                     f"filter_rows, {len(strategies)} strategies x sticky off/on: max_abs_err vs "
                     f"plain {err_rows}, images differing from the host filter {host_bad}/{n}",
                     err_bank == 0 and err_rows == 0 and host_bad == 0)
    return errs


def _check_png_bytes(dev, label, imgs, opts, roundtrip: bool) -> None:
    """Every file of the batch encode against the per-image ``png.encode``,
    which filters on the host; with ``roundtrip``, also decoded back."""
    import numpy as np

    from pixo_tpu_torch import encode_png_batch_sharded, png

    outs = encode_png_batch_sharded(imgs, opts, device=dev)
    same = sum(o == png.encode(img, opts) for o, img in zip(outs, imgs))
    back = sum(np.array_equal(decode_png(o), img) for o, img in zip(outs, imgs)) if roundtrip else None
    _verdict(f"main path png {label} {'x'.join(map(str, imgs.shape))}: {same}/{len(imgs)} files "
             f"byte-equal to the per-image png.encode, "
             f"{'not decoded' if back is None else f'{back}/{len(imgs)} decode to their input'}, "
             f"mean {sum(map(len, outs)) / len(outs):.0f} B/file",
             same == len(imgs) and back in (None, len(imgs)))


def check_png_main_path(dev, corpus, grad) -> dict:
    """Phase 3, PNG: batch (a) with the launch count of the fused filter
    kernel, then (b) and the routing batch (c). Returns the launch counts of
    run (a)."""
    import torch

    from pixo_tpu_torch import ColorType, PngOptions
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.parallel.pipeline import _png_route_batch

    cases = png_cases(corpus, grad)
    label, opts, imgs = cases["a"]
    reset_counts()
    _check_png_bytes(dev, f"(a) {label}", imgs, opts, roundtrip=True)
    launches = {"filter_rows": kernels.filter_rows.launches}
    _verdict(f"main path png (a): launches {launches}", launches["filter_rows"] >= 1)

    label, opts, imgs = cases["b"]
    _check_png_bytes(dev, f"(b) {label}", imgs, opts, roundtrip=True)

    routing = routing_batch(SIZE)
    opts = PngOptions.balanced(SIZE, SIZE)
    groups, fallback = _png_route_batch(torch.from_numpy(routing).to(dev).reshape(len(routing), -1, 4),
                                        opts)
    want = {("pass", ColorType.RGBA), ("strip", ColorType.RGB), ("ga", ColorType.GRAY_ALPHA)}
    routes = sorted(f"{m}->{c.name}" for m, c in groups)
    _verdict(f"png routing (c): groups {routes}, per-image fallbacks {sorted(fallback.tolist())}",
             set(groups) == want and sorted(fallback.tolist()) == [3, 4])
    _check_png_bytes(dev, "(c) routing RGBA balanced", routing, opts, roundtrip=False)
    return launches


def time_png(dev, corpus, grad, card: str) -> dict:
    """Phase 4, PNG: the filter kernels against their plain versions, then
    the stages of batches (a) and (b). Returns the kernels' (ms, plain ms)
    at batch (a)'s shape and strategy."""
    import torch

    from pixo_tpu_torch import encode_png_batch_sharded
    from pixo_tpu_torch.ops import kernels, png_filters
    from pixo_tpu_torch.parallel.pipeline import (
        _png_route_batch,
        png_filter_kwargs,
        png_frame,
        png_group_rows,
    )

    k_ms = {}
    for key, (label, opts, imgs) in png_cases(corpus, grad).items():
        b = imgs.shape[0]
        at = f"({key}) {label} {b}x{SIZE}x{SIZE}"
        mp = b * SIZE * SIZE / 1e6
        px = torch.from_numpy(imgs).to(dev).reshape(b, -1, 3)
        (((mode, ct), gidx),) = _png_route_batch(px, opts)[0].items()  # one group: pass RGB
        raw = png_group_rows(px, gidx, mode, ct, opts)
        kw = png_filter_kwargs(ct, opts)
        times = {"filter_rows": (event_ms(lambda: kernels.filter_rows(raw, **kw)),
                                 event_ms(lambda: png_filters.filter_rows_plain(raw, **kw)))}
        if key == "a":
            times["filter_bank"] = (event_ms(lambda: kernels.filter_bank(raw, 3)),
                                    event_ms(lambda: kernels.filter_bank_plain(raw, 3)))
            k_ms = times
        for name, (ms, plain_ms) in times.items():
            print(f"kernel {name} {at} {opts.filter_strategy.name}: {ms:.4f} ms per call, "
                  f"plain PyTorch {plain_ms:.4f} ms [{card}]")

        def device(filter_fn):
            groups, _ = _png_route_batch(px, opts)
            return [filter_fn(png_group_rows(px, g, m, c, opts), **png_filter_kwargs(c, opts))
                    for (m, c), g in groups.items()]

        filtered_dev = kernels.filter_rows(raw, **kw)
        filtered = filtered_dev.cpu().numpy()

        def deflate():
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(lambda f: png_frame(f, ct, opts), filtered))

        stages = {
            "png_h2d": wall_ms(lambda: torch.from_numpy(imgs).to(dev)),
            "png_device": wall_ms(lambda: device(kernels.filter_rows)),
            "png_device_plain": wall_ms(lambda: device(png_filters.filter_rows_plain)),
            "png_d2h": wall_ms(lambda: filtered_dev.cpu()),
            "png_deflate": wall_ms(deflate),
            "png_end_to_end": wall_ms(lambda: encode_png_batch_sharded(imgs, opts, device=dev)),
        }
        for name, ms in stages.items():
            print(f"stage {name} {at}: median {ms:.4f} ms, {mp / (ms / 1e3):.1f} MP/s over "
                  f"{WARM_RUNS} warm runs [{card}]")
    return k_ms


I16_EXTREMES = (-32768, -32767, -1024, -1, 0, 1, 1023, 32766, 32767)


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def decode_cases(dev, grad, corpus) -> dict:
    """The decode main path's batches: key -> (label, files, fancy modes).
    (d1) the JPEG encode phase's 16 gradient files; (d2) the corpus batch
    encoded by the port; (d3) the golden oracle set's baseline files and the
    four progressive photo fixtures in one mixed batch; (d4) gray, 4:4:4,
    4:2:2 and restart batches of odd sizes from the port's encoder."""
    import glob

    import numpy as np

    from pixo_tpu_torch import ColorType, JpegOptions, Subsampling, encode_jpeg_batch_sharded
    from pixo_tpu_torch.decode import jpeg_decoder as jd

    def encode(imgs, sub=Subsampling.S420, restart=None):
        gray = imgs.ndim == 3
        opts = JpegOptions(width=imgs.shape[2], height=imgs.shape[1], quality=QUALITY,
                           subsampling=sub, restart_interval=restart,
                           color_type=ColorType.GRAY if gray else ColorType.RGB)
        return encode_jpeg_batch_sharded(np.ascontiguousarray(imgs), opts, device=dev)

    rng = np.random.default_rng(5)

    def noisy(h, w, gray=False):
        imgs = grad[:4, :h, :w, 0] if gray else grad[:4, :h, :w]
        return (imgs + rng.normal(0, 6, imgs.shape)).clip(0, 255).astype(np.uint8)

    here = os.path.dirname(os.path.abspath(__file__))
    oracle = [_read(p) for p in sorted(glob.glob(os.path.join(here, "tests", "golden", "oracle",
                                                              "jpeg-*.bin")))]
    photos = [_read(p) for p in sorted(glob.glob(os.path.join(here, "tests", "fixtures",
                                                              "progressive_*.jpg")))]
    baseline = [d for d in oracle if not jd._parse(d).progressive]
    return {
        "d1": (f"gradient {BATCH}x{SIZE}x{SIZE} q{QUALITY} 4:2:0", encode(grad), (False,)),
        "d2": (f"corpus {len(corpus)}x{SIZE}x{SIZE} q{QUALITY} 4:2:0", encode(corpus), (False, True)),
        "d3": (f"oracle baseline {len(baseline)} + progressive photos {len(photos)}",
               baseline + photos, (False, True)),
        "d4 gray": ("gray 4x257x333", encode(noisy(257, 333, gray=True)), (False,)),
        "d4 444": ("4:4:4 4x383x509", encode(noisy(383, 509), Subsampling.S444), (False,)),
        "d4 422": ("4:2:2 4x131x250", encode(noisy(131, 250), Subsampling.S422), (False,)),
        "d4 restart": ("4:2:0 restart 3 4x200x300", encode(noisy(200, 300), restart=3), (False,)),
        "oracle progressive": ("oracle progressive",
                               [d for d in oracle if jd._parse(d).progressive], ()),
    }


def check_decode_kernels(dev, cases, n_blocks: int) -> dict:
    """Phase 2, decode: idct_planes against its plain version on ``dev`` on
    the coefficients of batches (d1) and (d3) and on ``n_blocks`` random
    blocks at the int16 extremes with tables of 255 and 65535 (int32 wraps
    on them), the plain version also against the CPU's; idct8x8_int on the
    same blocks. Returns the largest absolute error of each kernel."""
    import numpy as np
    import torch

    from pixo_tpu_torch.decode import jpeg_decoder as jd
    from pixo_tpu_torch.jpeg.tables import ZIGZAG_INV
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.jpeg_decode import idct8x8_int as idct_plain

    errs = {"idct_planes": 0, "idct8x8_int": 0}

    def held(label, zz, qtables, planes, cpu_too=False):
        got = kernels.idct_planes(zz, qtables, planes)
        ref = kernels.idct_planes_plain(zz, qtables, planes)
        err = int((got.int() - ref.int()).abs().max())
        errs["idct_planes"] = max(errs["idct_planes"], err)
        cpu_ok = torch.equal(ref.cpu(), kernels.idct_planes(zz.cpu(), qtables, planes)) if cpu_too else True
        _verdict(f"check idct_planes {label}: {zz.shape[0]} blocks, {len(planes)} planes, "
                 f"max_abs_err vs plain {err}"
                 + (f", plain on the card equal to plain on the CPU {cpu_ok}" if cpu_too else ""),
                 err == 0 and cpu_ok)

    for key in ("d1", "d3"):
        label, files, _ = cases[key]
        batch = jd._host_stage(files, 8)
        held(f"({key}) {label}", torch.from_numpy(batch.coeffs).to(dev), batch.qtables,
             batch.layout.planes)

    rng = np.random.default_rng(6)
    zz = rng.choice(np.array(I16_EXTREMES, np.int16), (n_blocks, 64))
    half, bw = n_blocks // 2, 500
    planes = np.array([[0, bw, half // bw, 0, 8 * bw],
                       [half, bw, half // bw, 64 * half, 8 * bw]], np.int64)
    qtables = np.stack([np.full(64, 255), np.full(64, 65535)])
    held(f"int16 extremes, tables 255 and 65535", torch.from_numpy(zz).to(dev), qtables, planes,
         cpu_too=True)

    q = np.repeat(qtables, half, axis=0)
    natural = (zz[: 2 * half].astype(np.int32) * q.astype(np.int32))[:, ZIGZAG_INV]
    blocks = torch.from_numpy(np.ascontiguousarray(natural.reshape(-1, 8, 8))).to(dev)
    got, ref = kernels.idct8x8_int(blocks), idct_plain(blocks)
    err = int((got.int() - ref.int()).abs().max())
    errs["idct8x8_int"] = err
    _verdict(f"check idct8x8_int {blocks.shape[0]} dequantized int16-extreme blocks: "
             f"max_abs_err vs plain {err}", err == 0)
    return errs


def _held_to_host(images, files, fancy: bool):
    """(images equal to the host two-stage decode, images equal to the fused
    host decode, baseline files), image by image."""
    import numpy as np

    from pixo_tpu_torch.decode import jpeg_decoder as jd

    two = fused = nbase = 0
    for img, data in zip(images, files):
        two += bool(np.array_equal(img.pixels, host_decode(data, fancy)))
        if not jd._parse(data).progressive:
            nbase += 1
            fused += bool(np.array_equal(img.pixels, host_decode(data, fancy, fused=True)))
    return two, fused, nbase


def check_decode_main_path(dev, cases) -> dict:
    """Phase 3, decode: ``decode_jpeg_batch(files, device="cuda")`` on every
    batch, fancy off (and on for (d2) and (d3)), each image held against the
    host library's decodes, with idct_planes launched once per call; the
    counts are read around (d1). Returns the launch counts of run (d1)."""
    from pixo_tpu_torch import errors
    from pixo_tpu_torch.decode import decode_jpeg, decode_jpeg_batch
    from pixo_tpu_torch.ops import kernels

    launches = None
    for key, (label, files, fancies) in cases.items():
        for fancy in fancies:
            reset_counts()
            images = decode_jpeg_batch(files, fancy_upsampling=fancy, device=dev)
            calls = kernels.idct_planes.launches
            if launches is None:
                launches = {"idct_planes": calls}
            two, fused, nbase = _held_to_host(images, files, fancy)
            mp = sum(i.width * i.height for i in images) / 1e6
            _verdict(f"main path decode ({key}) {label} {'fancy' if fancy else 'nearest'}: "
                     f"{two}/{len(files)} images equal to the host two-stage decode, "
                     f"{fused}/{nbase} baseline images equal to the fused host decode, "
                     f"{mp:.2f} MP, idct_planes launches {calls}",
                     two == len(files) and fused == nbase and calls == 1)
    label, files, _ = cases["oracle progressive"]
    messages = []
    for data in files:
        try:
            decode_jpeg(data, device=dev)
        except errors.InvalidDecode as e:
            messages.append(str(e))
    _verdict(f"decode {label} (the pixo encoder's output, which the reference decoder rejects "
             f"with InvalidDecode): {len(messages)}/{len(files)} rejected, {sorted(set(messages))}",
             len(messages) == len(files))
    return launches


def host_stage_split(files) -> dict:
    """Medians of the parts of ``_host_stage``, each timed alone: the marker
    parse, the zeroed coefficient buffer, the Python work that makes each
    baseline scan's library call ready, the calls themselves on one thread
    and on the decode's 8-thread pool, and the progressive files' decode
    (their parse and zeroed planes included: a refinement scan reads the
    coefficients that the scans before it left)."""
    import numpy as np

    from pixo_tpu_torch.decode import jpeg_decoder as jd

    scans = [jd._parse(d) for d in files]
    layout = jd._Layout(scans)
    coeffs = np.zeros((layout.total_blocks, 64), np.int16)
    planes = [[coeffs[f: f + n] for f, n in views] for views in layout.views]
    base = [k for k, s in enumerate(scans) if not s.progressive]
    calls = [jd._baseline_call(scans[k], planes[k])[1] for k in base]
    pool = jd._pool(8)
    return {
        "parse": wall_ms(lambda: [jd._parse(d) for d in files]),
        "buffer": wall_ms(lambda: np.zeros((layout.total_blocks, 64), np.int16)),
        "prepare": wall_ms(lambda: [jd._baseline_call(scans[k], planes[k]) for k in base]),
        "library_calls_1_thread": wall_ms(lambda: [c() for c in calls]),
        "library_calls_8_threads": wall_ms(lambda: [f.result() for f in [pool.submit(c) for c in calls]]),
        "progressive": wall_ms(lambda: [
            jd._decode_progressive(jd._parse(files[k]), [np.zeros_like(p) for p in planes[k]])
            for k, s in enumerate(scans) if s.progressive]),
    }


def time_decode(dev, cases, card: str) -> dict:
    """Phase 4, decode: for (d1) and (d3), the stages of the decode and the
    host library's decode of the same batch on 8 threads. Returns
    idct_planes' (ms, plain ms) at (d1)."""
    import numpy as np
    import torch

    from pixo_tpu_torch.decode import decode_jpeg_batch
    from pixo_tpu_torch.decode import jpeg_decoder as jd
    from pixo_tpu_torch.ops import kernels

    k_ms = {}
    for key in ("d1", "d3"):
        label, files, _ = cases[key]
        at = f"({key}) {label}"
        batch = jd._host_stage(files, 8)
        mp = sum(s.width * s.height for s in batch.scans) / 1e6
        zz = torch.from_numpy(batch.coeffs).to(dev)
        args = (zz, batch.qtables, batch.layout.planes)
        planes = kernels.idct_planes(*args)
        pixels = jd._upsample_colour(planes, batch, False)
        ms = (event_ms(lambda: kernels.idct_planes(*args)),
              event_ms(lambda: kernels.idct_planes_plain(*args)))
        if key == "d1":
            k_ms["idct_planes"] = ms
        desc, out = kernels._plane_descriptors(*args)
        alone = event_ms(lambda: kernels._launch_idct_planes(zz, desc, out))
        print(f"kernel idct_planes {at}: {ms[0]:.4f} ms per call, plain PyTorch {ms[1]:.4f} ms; "
              f"the launch alone, its plane table already on the card, {alone:.4f} ms; "
              f"{batch.coeffs.shape[0]} blocks, {batch.coeffs.nbytes / 1e6:.1f} MB of coefficients "
              f"[{card}]")

        def host_tier(data):  # the reference's CPU tier: fused for baseline files
            return host_decode(data, fused=not jd._parse(data).progressive)

        def host_decode_all():
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(host_tier, files))

        split = host_stage_split(files)
        print(f"decode host stage split {at}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
              + f" (medians over {WARM_RUNS} warm runs) [{card}]")
        stages = {
            "decode_host_entropy": wall_ms(lambda: jd._host_stage(files, 8)),
            "decode_host_entropy_1_worker": wall_ms(lambda: jd._host_stage(files, 1)),
            "decode_h2d": wall_ms(lambda: torch.from_numpy(batch.coeffs).to(dev)),
            "decode_idct_planes": wall_ms(lambda: kernels.idct_planes(*args)),
            "decode_upsample_colour": wall_ms(lambda: jd._upsample_colour(planes, batch, False)),
            "decode_device": wall_ms(
                lambda: jd._upsample_colour(kernels.idct_planes(*args), batch, False)),
            "decode_device_plain": wall_ms(
                lambda: jd._upsample_colour(kernels.idct_planes_plain(*args), batch, False)),
            "decode_d2h": wall_ms(lambda: pixels.cpu()),
            "decode_end_to_end": wall_ms(lambda: decode_jpeg_batch(files, device=dev)),
            "decode_host_library_8_threads": wall_ms(host_decode_all),
            "decode_host_library_1_thread": wall_ms(lambda: [host_tier(d) for d in files]),
        }
        for name, t in stages.items():
            print(f"stage {name} {at}: median {t:.4f} ms, {mp / (t / 1e3):.1f} MP/s over "
                  f"{WARM_RUNS} warm runs [{card}]")
        if key == "d3":
            per_file = [f"{s.width}x{s.height} {'progressive' if s.progressive else 'baseline'} "
                        f"{wall_ms(lambda: jd._host_stage([d], 1)):.4f} ms"
                        for d, s in zip(files, batch.scans)]
            print(f"decode host stage per file {at}, one file a call: {'; '.join(per_file)} [{card}]")
        gpu, host = stages["decode_end_to_end"], stages["decode_host_library_8_threads"]
        print(f"decode {at}: the card's decode {gpu:.4f} ms, the host library's on 8 threads "
              f"{host:.4f} ms: {'the card' if gpu < host else 'the host library'} is faster "
              f"by {max(gpu, host) / min(gpu, host):.2f}x [{card}]")
    return k_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.stdout.reconfigure(line_buffering=True)  # a crash keeps every line printed before it

    import numpy as np

    from pixo_tpu_torch import native
    from pixo_tpu_torch.ops import kernels

    dev = torch.device("cuda")

    # ---- phase 1: card, versions, builds
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:  # both builds at once
        for built in [ex.submit(kernels.load), ex.submit(native.load)]:
            built.result()
    print(f"build: cuda kernels {kernels.build_seconds:.1f} s, host library "
          f"{native.build_seconds:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    grad = gradient_batch(BATCH, SIZE)
    noise = np.random.default_rng(1).integers(0, 256, (4, 517, 389, 3), dtype=np.uint8)
    corpus = corpus_batch()
    try:
        errs = check_kernels(dev, grad, noise, 100_000)
        errs.update(check_png_kernels(dev, corpus))
        cases = decode_cases(dev, grad, corpus)
        errs.update(check_decode_kernels(dev, cases, 100_000))
        launches = check_main_path(dev, grad)
        launches.update(check_png_main_path(dev, corpus, grad))
        launches.update(check_decode_main_path(dev, cases))
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    missing = [k for k, n in launches.items() if n < 1]
    if missing:
        print(f"chip_smoke: FAILED: the main path launched no {missing} kernel", file=sys.stderr)
        return 1
    k_ms = time_everything(dev, grad, 100_000, card)
    k_ms.update(time_png(dev, corpus, grad, card))
    k_ms.update(time_decode(dev, cases, card))

    # filter_bank and idct8x8_int (the TPU kernels' own contracts) are on no
    # main path: their checks and times have lines of their own above
    sources = {"coeffs": ("pixo_tpu_torch/csrc/coeffs.cu", "pixo_tpu/ops/pallas_kernels.py:169"),
               "compact": ("pixo_tpu_torch/csrc/compact.cu", "pixo_tpu/ops/sparse_pack.py:117"),
               "filter_rows": ("pixo_tpu_torch/csrc/filter_bank.cu",
                               "pixo_tpu/ops/pallas_kernels.py:57"),
               "idct_planes": ("pixo_tpu_torch/csrc/idct.cu", "pixo_tpu/ops/pallas_kernels.py:187")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": k_ms[name][0], "plain_ms": k_ms[name][1]}
        for name, (src, replaces) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
