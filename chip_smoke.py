#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's batched baseline JPEG encode.

Run from the root of a checkout, on a machine with one NVIDIA GPU (built for
the H100, sm_90a):

    python3 chip_smoke.py

It imports only ``pixo_tpu_torch`` (no JAX) and runs four phases, each
printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of both native libraries from the checkout's
   sources (the CUDA kernels and the C++ host tier), with their build times;
2. every kernel of the path against its plain PyTorch version on the card,
   for bit equality: the coefficient kernel in all four modes on the
   16x512x512 gradient batch and on a 4x517x389 noise batch (odd sizes pad),
   also held against the host library's coefficients image by image; the
   standalone AAN DCT on 100k random blocks; the compaction kernel at caps
   8, 16 and 32;
3. the main path, ``encode_jpeg_batch_sharded(..., device="cuda")`` on the
   16x512x512 gradient batch at q85 4:2:0, with each image's bytes held
   against the host library's fused encode in the same marker frame, and
   the launch count of each kernel; then noise batches that escalate the
   compaction cap to 16 and to 32, one that falls back to the dense stream,
   and a 4:4:4 batch with restart markers;
4. median timings over warm runs: each kernel against its plain version,
   the copy of the pixels to the card, the device stage with kernels and
   with plain PyTorch, the copy of the streams to the host, the host pack
   and the whole encode.

Any mismatch or error exits non-zero. Without a CUDA device it exits 1
before printing any result. The line before the last is the kernels' JSON
record; the last line is the run's JSON result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

BATCH, SIZE, QUALITY = 16, 512, 85
WARM_RUNS = 20


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


def gradient_batch(batch: int, size: int):
    """The bench's input: shifted copies of one synthetic gradient."""
    import numpy as np

    from pixo_tpu_torch.utils.synthetic import synth_gradient

    base = synth_gradient(size, size)
    shifts = np.random.default_rng(0).integers(0, 17, batch)
    return np.stack([np.roll(base, int(s), axis=1) for s in shifts])


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
    kernels.coeffs.launches = 0
    kernels.compact_padded.launches = 0
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

    def event_ms(fn, calls=10, reps=5):
        """Median over ``reps`` of the CUDA-event time of ``calls``
        back-to-back calls, per call: the device time whenever the device,
        and not the host's launching, is the bound."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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
    kernels.load()
    native.load()
    print(f"build: cuda kernels {kernels.build_seconds:.1f} s, host library "
          f"{native.build_seconds:.1f} s")
    for line in kernels.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    grad = gradient_batch(BATCH, SIZE)
    noise = np.random.default_rng(1).integers(0, 256, (4, 517, 389, 3), dtype=np.uint8)
    try:
        errs = check_kernels(dev, grad, noise, 100_000)
        launches = check_main_path(dev, grad)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    missing = [k for k, n in launches.items() if n < 1]
    if missing:
        print(f"chip_smoke: FAILED: the main path launched no {missing} kernel", file=sys.stderr)
        return 1
    k_ms = time_everything(dev, grad, 100_000, card)

    sources = {"coeffs": ("pixo_tpu_torch/csrc/coeffs.cu", "pixo_tpu/ops/pallas_kernels.py:169"),
               "compact": ("pixo_tpu_torch/csrc/compact.cu", "pixo_tpu/ops/sparse_pack.py:117")}
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
