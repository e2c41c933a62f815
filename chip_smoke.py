#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's batched JPEG and PNG encodes
(lossless, the max preset among them, and lossy), its batched JPEG decode
under both pixel tiers, its PNG decode and device unfilter, its thumbnail
pipeline, its JPEG streams, its compression service, its command line, its
playground and its two-process batch.

Run from the root of a checkout, on a machine with one NVIDIA GPU (built for
the H100, sm_90a):

    python3 chip_smoke.py

It imports only ``pixo_tpu_torch`` (no JAX) and runs four phases, each
printing its own lines:

1. the card (``nvidia-smi`` name and power limit), the torch and CUDA
   versions, and the build of both native libraries from the checkout's
   sources (the CUDA kernels and the C++ host tier), with their build times:
   which build of the host tier was loaded (profile-guided, or plain under
   ``PIXO_TPU_NO_PGO=1``) and the seconds of each of its build steps;
2. every kernel of both paths against its plain PyTorch version on the
   card, for bit equality: the coefficient kernel in all four modes on the
   16x512x512 gradient batch, on a 4x517x389 noise batch (odd sizes pad)
   and at the tiled kernel's edges (``coeff_edge_cases``: batch 1, 8x8 and
   17x23 images, rows whose W*C is no multiple of 16, widths that end inside
   a tile, RGBA, one 3220x1812 image), also held against the host library's
   coefficients image by image; the standalone AAN DCT on 1, 3, 4, 5, 127,
   129 and 100,000 random blocks and on 129 blocks 16 bytes into their
   buffer (``aan_cases``); the compaction kernel at caps 8, 16 and 32 on those coefficients
   and on blocks with 0, cap, cap + 1 and 63 nonzeros
   (``compact_edge_batch``); the PNG filter bank and the fused filter
   kernel for every bpp 1 to 8, on rows at an odd byte offset (odd row
   lengths, one-row images, rows no longer than a pixel, the edge shapes of
   ``filter_edge_cases``: rows of 1 to 17 bytes, heights around a strip and
   the sticky limit, tied rows, rows at the strip kernel's shared-memory
   budget; 262,140-byte rows, which take the long-row kernel; the corpus
   batch; and Bigrams' own shapes, ``bigram_edge_cases``: rows of 1 and 2
   bytes, all-zero rows, tied candidates, the longest strip row and the
   shortest long row under mode 7's plan, and ``bigram_merge_cases``: marks
   of all 32 lanes on one key and on one bitmap word, pairs across every
   step boundary of the strip kernel's walk), the fused kernel in every
   strategy (Bigrams, mode 7, too) with the sticky rule off and on, also
   held against the host library's filter image by image;
   the decode-tail kernel on the coefficients of decode batches (d1) and
   (d3), on the edge layout of ``plane_edge_case`` (three planes in one
   thread block's range, a plane of one block, gaps, wide pitches) and on
   100k blocks at the int16 extremes with tables of 255 and 65535 (int32
   wraps), through both of its entry points, and the standalone integer
   IDCT on the same blocks; the Lanczos3 resize kernel on ``resize_cases``
   (the thumbnail chunk 64x256x256x3 to 128x128, up- and downscales at odd
   sizes with 1, 3 and 4 channels, a target of one pixel, sources one pixel
   wide and high, output rows of two tiles, windows past shared memory (the
   direct route), one 3220x1812 image, batches of 1 and 64, each also from
   byte offsets 1, 3 and 15, each with the route ``resize_plan`` gives it),
   also held against the host library's resize image by image; and the kernels that the thumbnail path shares with the other
   paths (``idct_planes``, ``coeffs`` in mode 444, ``compact`` at cap 8 and at
   the escalated cap) on the tensors of every chunk of (t1) and (t2)
   (``check_thumbnail_kernels``); and the lossy PNG's three kernels
   (``kmeans_refine``, ``palette_lut``, ``dither_fs``) on
   ``quantize_edge_cases`` (K = 1, K = 256 with duplicate entries, k_valid
   below K, all-zero weights, ties, H = 1, W = 1, heights at the dither's
   band edges, bands that wrap round its warps, a warp count capped by the
   bands, alpha other than 255) at byte offsets 0, 1 and 3, and on the
   tensors of the lossy cells (q1) and (q2), each also held against the host
   library image by image (``refine_palette_kmeans``, ``native_palette_lut``,
   ``native_dither_fs``); the dither also with its rings in global memory,
   and 20 times on one input whose rings fill (``check_dither_repeats``);
   and the symbol-count kernel (``count_symbols``, ``check_count_kernel``) on
   the coefficients of the gradient and corpus batches and of 3 noise
   images of 517x389 (the wrapper's shares cross images) at q85 4:2:0 and
   on ``count_cases`` (``count_edge_blocks`` under every MCU pattern, at
   batch 1 with restart intervals none, 1, 2 and 7, and at batch 64; one
   image of one block), each at byte offsets 0 and 2 and, but for the two
   largest batches, also under shares of 1, 7 and 61 blocks
   (``COUNT_FORCED_SHARES``: shares that start inside MCUs, restart
   segments and images), also held against the host library's count image
   by image; and the max preset's two kernels (``check_trellis_kernels``):
   ``dct_zz``, a kernel of its own beside the coefficient kernel, in all four
   modes on the gradient, noise and edge batches of the coefficient kernel
   and on batches of fewer tiles than the card's slots, twice the slots and
   one tile past them (``dct_zz_tile_cases``), bit for bit against its plain
   version and image by image against the host library's unquantized DCT,
   with the occupancy of both kernels and the CTAs an SM of ``dct_zz``'s
   plan; ``trellis_quantize``
   on ``trellis_edge_blocks`` (exact halves, the extension's and the
   all-zero exit's boundaries, ZRL runs, DC edges, tied lattices, extremes,
   under every MCU pattern), 70,000 random blocks and the real DCT of the
   max cells (m1) and (m2), against its plain version and the host
   library's DP; and the ``PIXO_TPU_LZ77=device`` route's kernels
   (``check_lz77_kernels``): ``hash4``, ``chain_candidates`` at k = 1 and
   16 and ``batched_match_lengths`` at max_len 3 and 258 (on pairs with
   cand > pos near the end, pos past the end and negative indices,
   ``match_pairs``) on (e)'s 8 filtered streams of 786,944 bytes and on
   ``lz77_cases`` (1 MiB of zeros, 1 MiB of noise, 16 MiB of values 0-3,
   three tiles of the chain sort and 20 bytes, a 37-byte period, n = 0 to
   5), each equal to its plain version, and ``adler32_device`` against its
   plain version and ``zlib.adler32`` at ``ADLER_SIZES`` (0 to 16 MiB,
   around its 2048-byte chunks) from ``ADLER_STARTS``; and the unfilter
   kernel (``check_unfilter_kernel``) on ``unfilter_edge_cases`` (every bpp
   1 to 8 and filter id, H = 1, RB < bpp, RB = 1, ids outside 0-4, heights
   around a warp's group of 32 rows, a CTA's 16 warps, a cluster's split
   and groups wrapping round the warps, and 1023 to 2100 rows) at byte
   offsets 0, 1 and 3, bit for bit against its plain version and the host
   library's ``png_unfilter``, under ``unfilter_plan``'s split and under
   forced ones (``UNFILTER_FORCED``: one SM an image, each cluster split,
   the global rings), and on the rows ``filter_rows`` filters from PNG (a)'s
   images under four strategies, which it must give back;
3. the JPEG main path, ``encode_jpeg_batch_sharded(..., device="cuda")`` on
   the 16x512x512 gradient batch at q85 4:2:0, with each image's bytes held
   against the host library's fused encode in the same marker frame, and
   the launch count of each kernel; then noise batches that escalate the
   compaction cap to 16 and to 32, one that falls back to the dense stream,
   and a 4:4:4 batch with restart markers. Then the optimized-Huffman and
   progressive routes of the same entry point (``check_jpeg_routes``, the
   batches of ``jpeg_route_cases``): the balanced preset at q85 4:2:0 on
   the gradient and corpus batches, the optimal tables, noise that
   escalates the cap to 16 and 32 and that falls back to the dense stream,
   a gray batch with restarts, progressive with and without successive
   approximation on the corpus batch and on 64x64 crops that take the SA
   fallback; every file is held against the host tier (``jpeg.encode(img,
   opts, device="cpu")``, ``host_tier``), with the launch counts of each
   call (``count_symbols`` once on the optimized routes). Then the max
   preset (``check_trellis_path``, ``trellis_cells``): (m1) the gradient
   batch and (m2) 12 corpus photos at q85 4:2:0 (one ``dct_zz`` and one
   ``trellis_quantize`` launch, no ``coeffs``), then gray with restarts,
   4:4:4 optimal without SA, 64x64 crops (the SA fallback; one image and a
   batch) and a baseline encode with
   ``trellis_quant`` (``trellis_route_cases``), every file byte-equal to
   the host tier (``jpeg.encode_batch(..., device="cpu")``). Then the PNG main path,
   ``encode_png_batch_sharded(..., device="cuda")``, on (a) 16 512x512 RGB
   photos (the four corpus fixtures and three shifts of each) under the
   balanced preset, with the fused filter kernel's launch count, (b) the
   16x512x512 gradient batch under the fast preset and (c) a 512x512 RGBA
   batch that takes every route (pass, strip, gray-alpha) and both
   per-image fallbacks (gray, palette); every file is held against the
   per-image ``png.encode`` (which filters on the host) and (a) and (b)
   also decode back to their input. Then (e), the max preset (Bigrams in
   ``filter_rows``' mode 7, the optimal DEFLATE on the host) on (a)'s first
   12 images, held and decoded alike, with every ``filter_rows`` launch of
   its call in mode 7 (``check_png_max_path``); then under
   ``PIXO_TPU_LZ77=device`` (``check_lz77_route``) each of (e)'s streams'
   ``deflate_optimal_zlib`` on the card, equal to its bytes with the
   variable unset, and the (e) call end to end, every file equal to its
   host reference, with one ``chain_candidates`` launch an image; and, for correctness only
   (``check_png_options``), interlaced batches (gray, RGB, RGBA, reductions
   to 1-, 2- and 4-bit gray and a 4-bit palette, one quantized), 16-bit
   batches (RGB and RGBA, uint16 of either byte order),
   ``encode_png_row_sharded`` at the max and balanced presets and
   ``png.encode_batch`` with its default device, each file against the
   per-image ``png.encode``. Then the decode main path,
   ``decode_jpeg_batch(files, device="cuda")``, on (d1) the 16 gradient
   JPEGs of the encode phase, (d2) the corpus batch encoded by the port,
   (d3) the golden oracle set's 9 baseline files (up to 3220x1812) and the
   four progressive photo fixtures in one mixed batch, and (d4) gray,
   4:4:4, 4:2:2 and restart batches of odd sizes, fancy upsampling off (and
   on for (d2) and (d3)); every image is held against the host library's
   two-stage decode and each baseline one against its fused decode, and the
   decode-tail kernel launches once per batch. The oracle set's 7
   progressive files, which the reference decoder rejects, must be rejected.
   Then the thumbnail path, ``thumbnail_pipeline(..., device="cuda")``, on
   (t1) 1000 JPEGs of 256x256 to 128x128 at q85 in chunks of 64 (BASELINE.json
   config 5 at the size of benches/pipeline.py) and (t2) one mixed call in
   chunks of 5 (corpus PNGs, the files of (d3), a gray JPEG, RGBA and
   gray+alpha PNGs, P6 and P5 files, a thumbnail-sized input): every output is
   held byte for byte against the host composition (``host_thumbnails``: the
   host library's JPEG decode, this script's own PNG reader, the host
   library's resize and fused encode), with
   the launch counts a call (``resize_lanczos3`` at least one a shape group,
   ``coeffs`` and ``compact`` one a chunk, ``idct_planes`` one a chunk that
   holds a JPEG), and a corrupt file in a call must raise InvalidDecode.
   Then the lossy PNG path, ``encode_png_batch_sharded`` with quantization
   (BASELINE.json config 3), on (q1) the corpus batch (FORCE, 256 colours,
   dithered, balanced) and (q2) the gradient batch (FORCE, 64 colours,
   dithered, fast), each with the three kernels' launch counts of its call,
   and (q3) for correctness: both without dithering, RGBA batches with
   graded alpha (the dither's direct redmean, tRNS), and an AUTO batch with
   a declined, an exact-mapped and two quantized images; every file is held
   against the per-image ``png.encode`` (host quantization). Then the
   JPEG streams (``check_stream_path``): ``encode_jpeg_stream`` and
   ``encode_jpeg_stream_overlapped`` on 8 batches of the main path's
   gradients (``stream_batches``), every file held to the host encode,
   with one ``coeffs`` and one ``compact`` launch a batch; 4 batches at the
   balanced preset (one ``count_symbols`` a batch, every file held to the
   host tier); a noise batch in mid-stream whose cap escalates on the copy
   thread; and a mesh of every visible card. Then the CLI (``check_cli``):
   ``cli.main`` on a JPEG -> PNG transcode and a PNG -> JPEG one with
   ``--resize`` and ``--grayscale``, the card's bytes equal to ``--device
   cpu``'s, with the card run's launches. Then the service
   (``check_service``): ``CompressService(workers=2)`` on the card and with
   ``device="cpu"``, 32 mixed requests each (``service_requests``: JPEG,
   balanced PNG, Lanczos3 and the playground's job), every result of the
   card's equal to the CPU's, a worker's launches probed, with the
   requests/s of both; then on the card a request past its deadline, a
   cancelled one and a crash whose respawned workers serve again. Then the
   decode's pixel tiers (``check_decode_tiers``: (d1) and (d3) with
   ``device="cuda"``, with ``PIXO_TPU_DECODE_PIXELS=host`` on the card and
   with ``device="cpu"``, every image held to the host library, no tail
   launch under the host tier), the PNG decode of PNG (a)'s files
   (``check_png_decode_path``: the unfilter kernel's launches, 0), the
   playground's HTTP front (``check_playground``: through a service of two
   workers on the card and inline, a PNG job and two JPEG jobs byte-equal to
   ``compress_bytes(..., device="cpu")``, 422 on a body that is no image),
   and two processes over gloo on cuda:0 (``check_dcn``, the payload of
   ``tests/test_torch_dcn.py``);
4. median timings over warm runs: each kernel four ways (``time_kernel``:
   the profiler's device time, the launch alone, the wrapper call and the
   plain version; the AAN contract also its yardstick, one ``torch.matmul``
   by the 64x64 DCT matrix, ``aan_library``) beside its bound
   (``kernel_bound``), the copy of the
   pixels to the card, the device stage with kernels and
   with plain PyTorch, the copy of the results to the host, the host pack
   or DEFLATE and the whole encode, for JPEG and for PNG batches (a) and
   (b); for PNG (e) ``filter_rows`` in mode 7 four ways beside its bound
   (its bytes, or five shared-memory atomics a byte pair at the banks'
   rate) and the stages (device stage, the optimal DEFLATE on 8 threads,
   the whole call, the per-image host ``png.encode`` on 8 threads; median,
   least and most of 3 warm runs, ``time_png_max``), the DEFLATE and the
   whole call also under ``PIXO_TPU_LZ77=device``, and that route image by
   image (``lz77_split``: upload, ``chain_candidates``, the tables back,
   the assisted host parse, beside the host route's parse); the route's
   ``chain_candidates`` four ways at one (e) stream and at 16 MiB, with
   each of its kernels' device time (``profiler_ms``), and
   ``adler32`` at 16 MiB (``time_lz77``); for the balanced
   route on the gradient batch the count kernel four
   ways (and again on its first image alone, ``jpeg.encode``'s batch of
   one) and the stages (copy up, device stage, copies back, the tables of
   every image, the pack with them, the whole call, the host tier on 8
   threads), and for the progressive route with SA on the corpus batch the
   device stage with its copy back, the host stage, the whole call and the
   host tier on 8 threads (``time_jpeg_routes``); for the max cells (m1)
   and (m2) ``dct_zz`` and ``trellis_quantize`` four ways beside their
   bounds, the stages (copy up, DCT, trellis, copy back, the progressive
   scans on 8 threads, the whole call, the host library's DP alone and the
   host tier, on 8 threads) (``time_trellis``); and for decode batches (d1)
   and (d3) the host stage with 8 workers
   and with 1, and its parts (parse, buffer, the Python work of each call,
   the library calls on 1 and 8 threads, the progressive files), the copy
   of the coefficients, the kernel, the upsampling and colour, the device
   stage with the kernel and in plain PyTorch, the copy of the pixels back,
   the whole decode, and the host library's decode of the same batch on 8
   threads and on 1; for (d3) also each file's host stage alone; and for the
   thumbnail call (t1) the resize kernel and the shared kernels (``coeffs``,
   ``compact``, ``idct_planes``) at its chunk shapes, the stages of
   one chunk (host decode stage, decode device tail, resize, coefficients and
   compaction, copy of the compacted streams, host pack) and the whole call,
   in ms, images/s and input MP/s with least and most of five warm runs,
   beside the same files through the two-call path (``decode_jpeg_batch`` to
   host pixels, the host library's resize, ``encode_jpeg_batch_sharded``);
   and for (q1) and (q2) the three quantization kernels at the cell's
   shapes (the dither's time a step of its critical path, W + 2(H - 1)
   steps, in ns and in SM clocks at the clock read under load) and
   the lossy stages (host histograms and median cut, the device stage, the
   copies back, the indexed encode and DEFLATE, the whole call; median,
   least and most of 3 warm runs) beside the per-image host ``png.encode``
   on 8 threads; and for the streams (``time_stream``) the batch entry's
   time a batch beside each stream's wall clock and each batch's time, the
   overlapped form's stage busy sums (``stats``) against its wall clock,
   and the card's busy time in a traced run; the unfilter kernel four ways
   at PNG (a)'s device group beside its byte bound and its critical path
   (``time_unfilter``); the decode's host tier through ``decode_jpeg_batch``
   on 8 threads and on 1; and beside ``compact`` and ``idct8x8_int`` their
   yardsticks (``compact_library``: one ``torch.topk`` of the JAX package's
   packed key; ``idct_library``: one ``torch.matmul`` by the 64x64 IDCT
   matrix); a JSON line of these, of the service's requests/s and of the
   CLI's and the playground's launches precedes the kernels' record.

Any mismatch or error exits non-zero. Without a CUDA device it exits 1
before printing any result. The line before the last is the kernels' JSON
record; the last line is the run's JSON result.

Two checkouts compare on one card with

    python3 chip_smoke.py --compare PARENT . . PARENT

which runs ``measure_tree`` on each directory in turn, each in a process of
its own (the coefficient (also at the (t1) chunk), compaction, count (also
at one image), filter (also mode 7 at (e)'s device group and on noise rows
of its shape), decode-tail and resize kernels, the AAN contract at
100,000 blocks and ``dct_zz`` at (m1) and (m2) three ways, the quantization
kernels at (q1), the LZ77 route's ``chain_candidates`` (with its rows'
kernel and scans) at an (e) stream and at 16 MiB and ``adler32`` at 16 MiB,
``unfilter`` at PNG (a)'s device group (``measure_unfilter``, through each
tree's own C entry), the device stages and the
end-to-end stages, the (e) call's under ``PIXO_TPU_LZ77=device`` too; what a tree lacks
is skipped and printed as absent), and prints the numbers side by side. ``python3 chip_smoke.py --coeffs-parts`` times the coefficient
kernel as it is and with each of its parts taken out (``coeffs_parts``);
``python3 chip_smoke.py --coeffs-parts dct_zz [CHECKOUT ...]`` times the
``dct_zz`` kernel of each checkout named (this one by default) at (m1) and
(m2) as it is, with each part its design has taken out and each of its
levers undone, and on grids of 1 to 5 CTAs an SM (``dct_zz_parts``);
``python3 chip_smoke.py --filter-parts`` times the fused filter kernel under
each strategy, and mode 7 as it is, with each of its parts taken out
(``BIGRAM_PARTS``), as each of the designs it was measured against
(``BIGRAM_VARIANTS``) and on strips of 1 to 8 rows (``filter_parts``); ``python3 chip_smoke.py --resize-parts``
checks the resize kernel alone on every case and offset and times each of
its passes as it is, with each of its parts taken out and under each tile
(``resize_parts``); ``python3 chip_smoke.py --dither-parts`` times the
dither kernel at (q1) and (q2) as it is and with each of its parts taken out
(``dither_parts``); ``python3 chip_smoke.py --kmeans-parts`` times the
k-means kernel at (q1) and (q2) as it is and without its argmin, its
atomics, its last CTA's update or its second launch (``kmeans_parts``);
``python3 chip_smoke.py --count-parts [CHECKOUT ...]`` times the count
kernel of each checkout named (this one by default) at (b1) as it is and
with each part its design has taken out (``COUNT_PARTS``: the global
flush, the AC walk, the DC adds, the predictor loads, the loads alone, the
memset alone), at one image, and on grids of 1 to 4 CTAs an SM
(``count_parts``); ``python3 chip_smoke.py --lz77-parts [CHECKOUT ...]``
times ``chain_candidates`` of each checkout named (this one by default) at
an (e) stream and at 16 MiB, each launch as it is and its rows' kernel
with each part its design has taken out (``LZ77_DESIGNS``:
``lz77_parts``); ``python3 chip_smoke.py --pack-workers`` times the host
pack stage on 1, 2, 4 and 8 threads (``pack_workers``); ``python3
chip_smoke.py --host-build`` times phase 4's host stages under the host
library's profile-guided build and under its plain one
(``PIXO_TPU_NO_PGO=1``), in alternating processes (``host_build``); ``python3
chip_smoke.py --unfilter-parts`` times the unfilter kernel at PNG (a)'s
device group as it is, without each of its parts (``UNFILTER_PARTS``: the
shuffle, the ring's hand-off, the row's copies, the pixel reads, the
predictor, the stores) and on one SM an image beside each cluster split of
its warps (``unfilter_parts``); ``--compare`` times it there too; ``python3
chip_smoke.py --sass NAME``
counts the instructions of the built kernels whose name holds NAME, loop by
loop (``sass_loops``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import subprocess
import sys
import time

BATCH, SIZE, QUALITY = 16, 512, 85
WARM_RUNS = 20
CORPUS = ("browser", "playground", "rocket", "web")
CORPUS_SHIFTS = ((0, 0), (0, 64), (128, 0), (200, 300))
# the thumbnail path's cell (t1): BASELINE.json config 5 at the size of
# benches/pipeline.py (1000 JPEGs of 256x256 to 128x128 at q85, chunks of 64)
THUMB, THUMB_QUALITY = 128, 85
T1_COUNT, T1_SIZE, T1_CHUNK = 1000, 256, 64
THUMB_RUNS = 5


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
        return native.native_jpeg_decode_baseline_call(
            segments, scan.restart_interval, scan.mcu_cols * scan.mcu_rows, scan.mcu_cols,
            scan.mcu_rows, ch, cv, scan.max_h, scan.max_v, scan.width, scan.height,
            [scan.dc_specs[c.dc_table] for c in comps], [scan.ac_specs[c.ac_table] for c in comps],
            [scan.qtables[c.quant_id] for c in comps], fancy=fancy,
        )()
    planes = [np.zeros((bw * bh, 64), np.int16) for bw, bh in scan.plane_blocks()]
    qtables = jd._decode_entropy(scan, planes)
    return native.native_jpeg_decode_pixels_call(planes, qtables, ch, cv, *geometry, fancy=fancy)()


def reset_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from pixo_tpu_torch.compress import checksums
    from pixo_tpu_torch.ops import kernels, lz77_assist, png_unfilter

    for fn in (png_unfilter.unfilter_device_batch, kernels.coeffs, kernels.compact_padded, kernels.count_symbols, kernels.dct8x8_aan,
               kernels.dct_zz, kernels.trellis_quantize, kernels.filter_bank, kernels.filter_rows,
               kernels.idct_planes, kernels.idct8x8_int, kernels.resize_lanczos3,
               kernels.kmeans_refine, kernels.palette_lut, kernels.dither_fs, lz77_assist.hash4,
               lz77_assist.batched_match_lengths, lz77_assist.chain_candidates, checksums.adler32_device):
        fn.launches = 0


def print_clocks(when: str) -> None:
    """The SM clock now and at most (MHz), as ``nvidia-smi`` reads them: the
    integer bound assumes 1.98 GHz."""
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader"], capture_output=True, text=True,
                            timeout=60).stdout.strip()
    print(f"clocks {when}: SM now, SM at most: {clocks}")


def busy_sm_mhz(launch, calls: int = 1000):
    """The SM clock (MHz) that ``nvidia-smi`` reads while ``calls``
    launches of ``launch`` queued beforehand keep the card busy."""
    import torch

    for _ in range(calls):
        launch()
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.split()
    torch.cuda.synchronize()
    return int(mhz[0]) if mhz and mhz[0].isdigit() else None


def step_line(ms, steps: int, mhz) -> str:
    """A dither time as ns and SM clocks a step of its critical path."""
    if ms is None:
        return "not measured"
    ns = ms / steps * 1e6
    return f"{ns:.1f} ns" + ("" if mhz is None else f", {ns * mhz / 1e3:.0f} clocks at {mhz} MHz") + " a step"


def event_ms(fn, calls=10, reps=5, warm=3):
    """Median over ``reps`` of the CUDA-event time of ``calls`` back-to-back
    calls after ``warm`` calls, per call: the device time whenever the
    device, and not the host's launching, is the bound."""
    import torch

    for _ in range(warm):
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


def wall_stats(fn, runs: int = THUMB_RUNS):
    """(median, least, most) host-clock ms of ``runs`` calls after one warm
    call, each synchronized."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return _median(times), min(times), max(times)


PROFILED = {}  # profiler_ms's last count of traced launches, by kernel name


def profiler_ms(fn, kernel, calls: int = 20):
    """Device time a call of ``fn`` spends in the kernels whose name holds
    ``kernel`` (or one of the names of a tuple: a template instance's
    demangled and mangled forms; one kernel for most wrappers; the two passes of the resize,
    the k-means' kernel twice), from ``torch.profiler``'s
    ``key_averages()`` over ``calls`` warm calls of ``fn``: the kernels' own
    time, whatever the wrapper costs on the host. The trace may hold fewer
    launches than ran (17-19 of 20 on the card's machine), so each kernel's
    time is its mean over the launches traced, times its launches a call
    (the traced count over ``calls``, rounded). Where the trace holds every
    launch that is the kernel's total over ``calls``, as before; where it
    dropped some, the total over ``calls`` would count each dropped launch
    as 0. None where the profiler shows no device time for them (in two
    traces)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a second trace where the first holds none of the kernels
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        keys = (kernel,) if isinstance(kernel, str) else kernel
        found = [(max(e.device_time_total, e.self_device_time_total), e.count)
                 for e in prof.key_averages() if any(k in e.key for k in keys) and e.count]
        if found:
            break
    PROFILED[kernel] = sum(n for _, n in found)  # the kernels' launches the trace holds
    per_call = sum(t / n * max(round(n / calls), 1) for t, n in found if t > 0)
    return per_call / 1e3 if per_call > 0 else None


# The card's peaks (NVIDIA's data sheet, H100 SXM at 700 W): HBM bytes and
# float32 operations outside the tensor cores, per second.
H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12
# int32 operations per second: 132 SMs x 128 lanes an SM x the 1.98 GHz
# boost clock. The Hopper SM has 64 INT32 lanes, but its integer multiply-adds
# issue to the 128 FP32 lanes' pipe beside them, and its four schedulers
# issue one warp instruction a clock each: 128 lanes a clock is the most an
# SM can issue. (64 lanes gave palette_lut a bound of 1.2036 ms at (q1),
# which the kernel beat in 0.6207 ms: no bound.)
H100_INT32_OPS_PER_S = 132 * 128 * 1.98e9
# Byte-pair marks in shared memory per second (mode 7 of filter_rows): 132
# SMs x 32 a clock (the shared memory's 32 banks, a word each a clock, none
# in conflict) x 1.98 GHz. No data sheet gives the rate of ATOMS; this is the
# most the banks can take.
H100_PAIR_MARKS_PER_S = 132 * 32 * 1.98e9
# The quantization kernels' integer work: a redmean distance as
# csrc/redmean.cuh writes it (4 differences, the red mean's add and shift,
# the two weights, 4 squares, 2 weight products, the green shift, 2 adds,
# the >> 8, the alpha add) and the argmin's compare: 20 operations; a
# k-means colour's accumulation: 4 products, 5 sums and the weight's test;
# a dithered pixel outside its distances: per channel 4 products, 4 adds,
# the shift and the clamp's 2, then the LUT index's 7 and the errors' 3 and
# the alpha test.
REDMEAN_OPS = 20
KMEANS_ACC_OPS = 10
DITHER_PIXEL_OPS = 3 * 11 + 7 + 3 + 1
# The trellis' work a block: the all-zero exit's test (an absolute value, a
# doubling and a compare for each of the 63 ACs) for every block; for a block
# that runs the DP, each of its 63 steps at least the candidates (a division,
# floor, ceil and the extension: 4), a rate lookup, two adds and a compare
# for each of up to 4 candidates and 8 states (128), and the merge of up to
# 12 entries into 8 (36 compares). None of it is a multiply-add, so its rate
# is one operation a lane a clock, the int32 issue rate below.
TRELLIS_EXIT_OPS = 3 * 63
TRELLIS_STEP_OPS = 4 + 4 * 8 * 4 + 36
OPS_TYPE = {"palette_lut": "int32", "kmeans_refine": "int32", "dither_fs": "int32",
            "trellis_quantize": "f32 without FMA", "filter_rows": "shared-memory pair mark"}
OPS_RATE = {"int32": H100_INT32_OPS_PER_S, "f32 without FMA": H100_INT32_OPS_PER_S,
            "shared-memory pair mark": H100_PAIR_MARKS_PER_S}
# f32 operations of one block through the coefficient chain: 16 AAN passes
# of 5 multiplies, 29 adds and 8 scales, then per coefficient the level
# shift, the division and the rounding.
AAN_OPS = 16 * (5 + 29 + 8)
COEFF_OPS = AAN_OPS + 3 * 64
LUT_ENTRIES = 64 * 64 * 64


def per_image(shape: dict, key: str):
    """``shape[key]``, one count or one an image, as an int64 array of one
    an image."""
    import numpy as np

    return np.broadcast_to(np.asarray(shape[key], np.int64), (shape["b"],))


def kernel_work(name: str, **shape):
    """(bytes, f32 operations) that kernel ``name`` must at least move and
    do at ``shape``: each input byte read once, each output byte written
    once. Shapes: coeffs and dct_zz (b, h, w, c, mode); compact (b, n, cap);
    count_symbols (b, n); trellis_quantize (n, and ``dp``, the blocks of
    this data that run the DP: ``TRELLIS_EXIT_OPS`` a block, and
    ``TRELLIS_STEP_OPS`` a step of the DP, at the issue rate);
    filter_rows and filter_bank (b, h, rb; filter_rows in mode 7 also
    ``bigrams``: five shared-memory pair marks a byte pair, one a candidate,
    ``OPS_TYPE``, whatever the kernel issues);
    idct_planes (n, out_bytes);
    dct8x8_aan and idct8x8_int (n); resize_lanczos3 (b, h, w, c, dh, dw, ky,
    kx: the taps of a vertical and a horizontal window, and optionally
    ``passes``, "horizontal" or "vertical" for one launch alone, whose
    bytes then include the intermediate as its output or its input). The
    other integer kernels count no operations. The quantization kernels
    count int32 operations (``OPS_TYPE``): palette_lut (b, k: the entries
    each image's scan takes, one count or one an image): a distance a grid
    colour and entry; kmeans_refine (b, k, m and, from the data,
    ``distances``, the colour-entry distances over both iterations of the
    colours of non-zero weight, and ``assigned``, those colours' count over
    both iterations); dither_fs (b, h, w, k as palette_lut's and
    ``alpha_pixels``, the pixels that take the direct redmean over the k
    entries, one count or one an image), whose LUT is an input read once. The resize's uint8 intermediate
    (b * h * dw * c bytes, written and read again) is its design's own
    traffic, not work the function must do, and is not counted for both
    passes together."""
    s = shape
    if name == "coeffs":
        from pixo_tpu_torch.ops.blockify import num_blocks

        blocks = s["b"] * num_blocks(s["h"], s["w"], s["mode"])
        return s["b"] * s["h"] * s["w"] * s["c"] + 128 * blocks, COEFF_OPS * blocks
    if name == "dct_zz":  # pixels in, f32 zigzag out; the AAN passes and the level shift
        from pixo_tpu_torch.ops.blockify import num_blocks

        blocks = s["b"] * num_blocks(s["h"], s["w"], s["mode"])
        return s["b"] * s["h"] * s["w"] * s["c"] + 256 * blocks, (AAN_OPS + 64) * blocks
    if name == "trellis_quantize":  # f32 blocks in, int16 out; dp: the blocks that run the DP
        return 384 * s["n"], TRELLIS_EXIT_OPS * s["n"] + 63 * TRELLIS_STEP_OPS * s["dp"]
    if name == "compact":  # zz in; dc, counts, poss, vals out
        return s["b"] * s["n"] * (128 + 3 + 3 * s["cap"]), 0
    if name == "count_symbols":  # zz in; 536 int64 counters an image out
        return s["b"] * (128 * s["n"] + 8 * 536), 0
    if name == "filter_rows":  # under Bigrams (``bigrams``) a pair mark a pair of each candidate
        pairs = 5 * s["b"] * s["h"] * max(s["rb"] - 1, 0) if s.get("bigrams") else 0
        return s["b"] * s["h"] * (2 * s["rb"] + 1), pairs
    if name == "filter_bank":  # rows in; five candidates and [5] int32 scores a row out
        return s["b"] * s["h"] * (6 * s["rb"] + 20), 0
    if name == "idct_planes":
        return 128 * s["n"] + s["out_bytes"], 0
    if name == "chain_candidates":  # n bytes in; the [n, k] int32 candidates and lengths out
        return s["n"] + 8 * s["n"] * s["k"], 0
    if name == "adler32":  # n bytes in
        return s["n"], 0
    if name == "unfilter":  # filtered rows and int32 ids in; rows out
        return s["b"] * s["h"] * (2 * s["rb"] + 4), 0
    if name == "dct8x8_aan":
        return 512 * s["n"], AAN_OPS * s["n"]
    if name == "idct8x8_int":
        return 320 * s["n"], 0
    if name == "resize_lanczos3":  # a multiply and an add a tap, each pass
        src = s["b"] * s["h"] * s["w"] * s["c"]
        mid, out = s["b"] * s["h"] * s["dw"] * s["c"], s["b"] * s["dh"] * s["dw"] * s["c"]
        passes = s.get("passes", "both")
        if passes == "horizontal":
            return src + mid, 2 * mid * s["kx"]
        if passes == "vertical":
            return mid + out, 2 * out * s["ky"]
        return src + out, 2 * (mid * s["kx"] + out * s["ky"])
    if name == "palette_lut":  # the entries scanned in, LUTs out
        entries = int(per_image(s, "k").sum())
        return 4 * entries + s["b"] * LUT_ENTRIES, LUT_ENTRIES * entries * REDMEAN_OPS
    if name == "kmeans_refine":  # palettes, colours, weights and sizes in; palettes out
        return (s["b"] * (8 * s["k"] + 8 * s["m"] + 4),
                REDMEAN_OPS * s["distances"] + KMEANS_ACC_OPS * s["assigned"])
    if name == "dither_fs":  # pixels, palettes and LUTs in; indices out
        px, k = s["b"] * s["h"] * s["w"], per_image(s, "k")
        return (5 * px + 4 * int(k.sum()) + s["b"] * LUT_ENTRIES,
                DITHER_PIXEL_OPS * px + REDMEAN_OPS * int((k * per_image(s, "alpha_pixels")).sum()))
    raise ValueError(f"no work model for kernel {name!r}")


def kernel_bound(name: str, **shape):
    """(bound_ms, bound_by): the least time the card could take for kernel
    ``name`` at ``shape``, the larger of its bytes over the memory rate and
    its operations over the rate of their type (``OPS_TYPE``: f32 unless
    named), and which of the two it is."""
    nbytes, ops = kernel_work(name, **shape)
    rate = OPS_RATE.get(OPS_TYPE.get(name), H100_F32_OPS_PER_S)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def coeff_edge_cases(rng):
    """The coefficient kernel's edge shapes, (label, [B, H, W, C] uint8
    noise): batch 1 of one 8x8 image, 17x23 images, rows whose W*C is no
    multiple of 16 and widths that end inside a tile of 128 pixels, RGBA
    input and one 3220x1812 image (heights no multiple of 16 too)."""
    import numpy as np

    shapes = (("batch 1 8x8", (1, 8, 8, 3)), ("17x23", (2, 17, 23, 3)),
              ("40x133, W*C 399, ends mid-tile", (2, 40, 133, 3)),
              ("33x200, W*C 600, ends mid-MCU", (3, 33, 200, 3)),
              ("RGBA 31x130, W*C 520", (2, 31, 130, 4)), ("1812x3220", (1, 1812, 3220, 3)))
    return [(label, rng.integers(0, 256, shape, dtype=np.uint8)) for label, shape in shapes]


EDGE_COUNTS = (0, 1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 62, 63)


def compact_edge_batch(rng, b: int, n: int):
    """[b, n, 64] int16 zigzag blocks whose nonzero AC counts cycle through
    ``EDGE_COUNTS`` (0, each cap, each cap + 1, 63, ...), at random
    positions, with values at the int16 extremes among them; the DC is
    random and sometimes 0. The compaction kernel's thread blocks (128
    rows each) then span several images when n is small."""
    import numpy as np

    zz = np.zeros((b * n, 64), np.int16)
    vals = np.array([-32768, -1024, -1, 1, 2, 1023, 32767], np.int16)
    for i in range(b * n):
        k = EDGE_COUNTS[i % len(EDGE_COUNTS)]
        pos = 1 + rng.choice(63, k, replace=False)
        zz[i, pos] = rng.choice(vals, k)
        zz[i, 0] = 0 if i % 5 == 0 else rng.integers(-2048, 2048)
    return zz.reshape(b, n, 64)


COUNT_PATTERNS = {"gray": (0,), "444": (0, 1, 2), "420": (0, 0, 0, 0, 1, 2), "422": (0, 0, 1, 2)}


def count_edge_blocks(rng):
    """[240, 64] int16 zigzag blocks at the symbol count's edges (240 is a
    multiple of every MCU's 1, 3, 4 and 6 blocks): runs of 15, 16, 31, 32
    and 48 zeros before a nonzero (ZRL splits, alone and with a run nibble),
    a nonzero last AC (no end-of-block), all-zero blocks (DC 0 and not),
    |v| at 2^k - 1 and 2^k up to 2047 in both signs, 48 blocks whose DCs of
    -1024 and 1023 make differences of category 11, and random sparse
    blocks."""
    import numpy as np

    zz = np.zeros((240, 64), np.int16)
    i = 0
    for run in (15, 16, 31, 32, 48):
        for lead in (0, 3):  # the run from the DC, or after a nonzero at zigzag lead
            if lead:
                zz[i, lead] = 5
            zz[i, lead + run + 1] = -3
            i += 1
    for _ in range(6):  # last AC nonzero
        zz[i, rng.choice(np.arange(1, 63), 4, replace=False)] = rng.integers(-40, 41, 4)
        zz[i, 63] = rng.choice([-1, 1, 2047])
        i += 1
    for dc in (0, 0, 7, -300):  # all-zero ACs
        zz[i, 0] = dc
        i += 1
    mags = sorted({m for k in range(12) for m in (2**k - 1, 2**k) if 0 < m <= 2047})
    for m in mags:
        zz[i, 1 + rng.integers(0, 63)] = m
        zz[i + 1, 1 + rng.integers(0, 63)] = -m
        i += 2
    zz[i:i + 48, 0] = rng.choice(np.array([-1024, 1023], np.int16), 48)
    i += 48
    rest = 240 - i
    vals = rng.integers(-60, 61, (rest, 64)) * (rng.random((rest, 64)) < 0.15)
    vals[:, 0] = rng.integers(-1024, 1024, rest)
    zz[i:] = vals
    return zz


TRELLIS_PATTERNS = {"420": (0, 0, 0, 0, 1, 2), "444": (0, 1, 2), "422": (0, 0, 1, 2), "gray": (0,)}


def trellis_edge_blocks(rng):
    """(label, [N, 64] f32 zigzag DCT blocks, lum [64], chrom [64] zigzag
    f32 tables, pattern) at the trellis' edges: exact halves coef = (k +
    0.5) q and |fq| = 1.5 (rounding and the extension's bound), 2|coef| = q
    and one float either side (the all-zero exit's boundary), runs of 15 and
    16 zeros before a nonzero (the ZRL wrap), the DC at +-0.49999997 q and
    at exact halves (the host library's f32 rounding), lattice blocks whose
    values are multiples of q / 4 (many exactly tied costs), the extremes of
    the JAX package's tests (an all-zero block, a dense one, a lone tail
    coefficient, one at a rounding boundary) and values up to category 13;
    every case under distinct lum and chrom tables, so the pattern picks."""
    import numpy as np

    f32 = np.float32
    lum = rng.integers(1, 80, 64).astype(f32)
    chrom = rng.integers(1, 80, 64).astype(f32)
    cases = []
    for pname, pattern in TRELLIS_PATTERNS.items():
        bpm = len(pattern)
        q = np.where((np.asarray(pattern)[np.arange(240) % bpm] != 0)[:, None], chrom, lum)
        dct = np.zeros((240, 64), f32)
        i = 0
        for k in range(-3, 3):  # exact halves: fq = k + 0.5 at one position, at all
            pos = 1 + rng.integers(0, 63)
            dct[i, pos] = (k + 0.5) * q[i, pos]
            dct[i + 1, 1:] = (k + 0.5) * q[i + 1, 1:]
            i += 2
        for sign in (1, -1):  # |fq| = 1.5, and 2|coef| = q with a float either side
            dct[i, 1:] = sign * f32(1.5) * q[i, 1:]
            half = sign * q[i + 1, 1:] / 2
            dct[i + 1, 1:] = half
            dct[i + 2, 1:] = np.nextafter(half.astype(f32), f32(0))
            dct[i + 3, 1:] = np.nextafter(half.astype(f32), f32(sign * 1e9))
            dct[i + 4, 5] = half[4]  # one coefficient at the boundary, the rest below
            dct[i + 4, 6:] = np.nextafter(half[5:].astype(f32), f32(0))
            i += 5
        for run in (15, 16, 17, 31, 32):  # zero runs before a nonzero, from the DC and after one
            for lead in (0, 2):
                if lead:
                    dct[i, lead] = 3 * q[i, lead]
                if lead + run + 1 < 64:
                    dct[i, lead + run + 1] = -2.2 * q[i, lead + run + 1]
                i += 1
        for x0 in (0.49999997, -0.49999997, 0.5, -0.5, 1.5, -2.5, 0.4999999):
            dct[i, 0] = f32(x0) * q[i, 0]
            dct[i, 1:] = rng.normal(0, 30, 63)
            i += 1
        lattice = 40
        dct[i:i + lattice] = rng.integers(-12, 13, (lattice, 64)) * q[i:i + lattice] / 4
        dct[i:i + lattice][rng.random((lattice, 64)) < 0.4] = 0
        i += lattice
        dct[i + 1] = rng.normal(0, 400, 64)  # i: all zero
        dct[i + 2, 63] = 100.0
        dct[i + 3, 1] = 8.0
        dct[i + 4] = rng.normal(0, 3000, 64) * (rng.random(64) < 0.3)
        i += 5
        rest = 240 - i
        dct[i:] = rng.normal(0, 80, (rest, 64)) * (rng.random((rest, 64)) < 0.5)
        dct[i:, 0] = rng.normal(0, 500, rest)
        cases.append((f"edge blocks 240 {pname}", dct.astype(f32), lum, chrom, pattern))
    return cases


def trellis_random_blocks(rng, n: int):
    """[n, 64] f32 DCT-like blocks: AC normal(0, 80) with half of them zero,
    DC normal(0, 500) (the JAX package's random trellis case, any size)."""
    import numpy as np

    dct = rng.normal(0, 80, (n, 64)).astype(np.float32)
    dct[:, 0] = rng.normal(0, 500, n).astype(np.float32)
    dct[rng.random((n, 64)) < 0.5] = 0.0
    return dct


def trellis_mixed_blocks(rng, n: int):
    """([n, 64] f32 DCT blocks, lum, chrom, the 4:2:0 pattern) whose warps
    mix the trellis kernel's kinds of step: rows in turn a ZRL block (runs
    of 15, 16, 17, 31 or 32 zeros before a nonzero, from the DC or after
    one; exact zeros, or in half of them values under 0.7 q), a dense block (no AC zero), a sparse one (three nonzeros,
    the rest exact zeros: steps with no nonzero candidate), a block that
    takes the all-zero exit and a random one; in the first half row by row,
    in the second 32 rows at a time (warps of one kind); the first row is a
    ZRL block."""
    import numpy as np

    f32 = np.float32
    lum = rng.integers(1, 80, 64).astype(f32)
    chrom = rng.integers(1, 80, 64).astype(f32)
    pattern = TRELLIS_PATTERNS["420"]
    q = np.where((np.asarray(pattern)[np.arange(n) % len(pattern)] != 0)[:, None], chrom, lum)
    dct = np.zeros((n, 64), f32)
    for i in range(n):
        kind = i % 5 if i < n // 2 else i // 32 % 5
        if kind == 0:
            lead, run = int(rng.choice([0, 1, 2])), int(rng.choice([15, 16, 17, 31, 32]))
            if lead:
                dct[i, lead] = rng.choice([3.0, -1.6]) * q[i, lead]
            if rng.random() < 0.5:  # the run's zeros close calls, not exact zeros
                dct[i, lead + 1:] = rng.uniform(-0.7, 0.7, 63 - lead) * q[i, lead + 1:]
            for at in (lead + run + 1, lead + 2 * run + 2):
                if at < 64:
                    dct[i, at] = rng.choice([-2.2, 1.3, 0.7]) * q[i, at]
        elif kind == 1:
            dct[i, 1:] = rng.normal(0, 60, 63)
        elif kind == 2:
            at = rng.choice(np.arange(1, 64), 3, replace=False)
            dct[i, at] = rng.normal(0, 3, 3) * q[i, at]
        elif kind == 3:
            dct[i, 1:] = rng.uniform(-0.49, 0.49, 63) * q[i, 1:]
        else:
            dct[i, 1:] = rng.normal(0, 80, 63) * (rng.random(63) < 0.5)
        dct[i, 0] = rng.normal(0, 500)
    return dct.astype(f32), lum, chrom, pattern


AAN_COUNTS = (1, 3, 4, 5, 127, 129)  # blocks: a group of 32 cut short, around a warp's four


def aan_cases(dev, n_dct: int) -> list:
    """The AAN contract's inputs on ``dev``, (label, [N, 8, 8] f32): the
    tail sizes ``AAN_COUNTS``, ``n_dct`` random blocks, and 129 blocks of a
    tensor that starts 16 bytes into its buffer."""
    import numpy as np
    import torch

    rng = np.random.default_rng(2)
    cases = [(f"{n} blocks", torch.from_numpy(rng.uniform(-128, 127, (n, 8, 8)).astype(np.float32)).to(dev))
             for n in (*AAN_COUNTS, n_dct)]
    flat = torch.from_numpy(rng.uniform(-1024, 1024, 4 + 129 * 64).astype(np.float32)).to(dev)
    return cases + [("129 blocks 16 bytes into their buffer", flat[4:].view(129, 8, 8))]


def dct_zz_tile_cases(slots: dict) -> list:
    """``dct_zz`` batches whose tile counts sit at the card's CTA slots of
    each mode (``slots``: ``dct_zz_slots`` by mode), (label, mode, images):
    128 pixels wide, one tile an MCU row, so an image of R MCU rows is R
    tiles; fewer tiles than slots, twice the slots, and one tile past them."""
    import numpy as np

    from pixo_tpu_torch.ops import kernels

    rng = np.random.default_rng(17)
    cases = []
    for mode, n in slots.items():
        rows = kernels.TILE_MCU[mode][1]
        for label, b, r in (("below the slots", 1, n // 2 + 1), ("twice the slots", 2, n),
                            ("one tile past the slots", 1, n + 1)):
            shape = (b, rows * r - 3, 128) + (() if mode == "gray" else (3,))
            cases.append((f"{label}: {b * r} tiles over {n} slots", mode,
                           rng.integers(0, 256, shape, dtype=np.uint8)))
    return cases


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
    named = [(f"{name} {'x'.join(map(str, batch.shape[:3]))}", batch)
             for name, batch in (("gradient", grad), ("noise", noise))]
    for label, batch in named + coeff_edge_cases(np.random.default_rng(8)):
        for mode in ("gray", "444", "420", "422"):
            host = np.ascontiguousarray(batch[..., 0] if mode == "gray" else batch)
            x = torch.from_numpy(host).to(dev)
            got = kernels.coeffs(x, lum, chrom, mode)
            ref = kernels.coeffs_plain(x, lum, chrom, mode)
            err = int((got.int() - ref.int()).abs().max())
            errs["coeffs"] = max(errs["coeffs"], err)
            got_h = got.cpu().numpy()
            rgb = host if mode == "gray" else np.ascontiguousarray(host[..., :3])
            host_bad = sum(
                not np.array_equal(got_h[i], native.native_jpeg_coefficients(rgb[i], mode, lum, chrom))
                for i in range(len(host))
            )
            _verdict(f"check coeffs mode={mode} {label} q{QUALITY}: max_abs_err vs plain {err}, "
                     f"images differing from the host library {host_bad}/{len(host)}",
                     err == 0 and host_bad == 0)
            if mode in ("420", "444") and label in dict(named):
                zz_cases.append((f"{label} {mode}", got))
    rng = np.random.default_rng(9)
    zz_cases += [(f"edge counts {b}x{n}", torch.from_numpy(compact_edge_batch(rng, b, n)).to(dev))
                 for b, n in ((3, 101), (70, 1), (1, 64))]

    for label, blocks in aan_cases(dev, n_dct):
        d_got, d_ref = kernels.dct8x8_aan(blocks), dct_plain(blocks)
        equal = torch.equal(d_got.view(torch.int32), d_ref.view(torch.int32))
        _verdict(f"check dct8x8_aan {label}: bitwise equal {equal}, "
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


def count_cases(rng):
    """The count kernel's cases of phase 2: (label, [B, N, 64] int16,
    pattern, restart interval): ``count_edge_blocks`` under every MCU
    pattern at batch 1 with restart intervals none, 1, 2 and 7, and at
    batch 64 (64 draws of them), and one image of one block."""
    import numpy as np

    edge = np.stack([count_edge_blocks(rng) for _ in range(64)])
    cases = []
    for mode, pattern in COUNT_PATTERNS.items():
        cases += [(f"edge blocks 1x240 {mode} restart {ri}", edge[:1], pattern, ri)
                  for ri in (None, 1, 2, 7)]
        cases.append((f"edge blocks 64x240 {mode} restart 7", edge, pattern, 7))
    cases.append(("one image of one block", np.ascontiguousarray(edge[:1, :1]), (0,), None))
    return cases


# Shares that check_count_kernel also forces on the count kernel: one block
# a CTA (every image's CTAs meet through the tickets), and 7 and 61 blocks
# (shares that start inside MCUs, restart segments and images).
COUNT_FORCED_SHARES = (1, 7, 61)


@contextlib.contextmanager
def count_shares(kernels, share):
    """Makes ``kernels.count_symbols`` split every batch into shares of
    ``share`` blocks, where it would take its own plan (``count_plan``;
    None leaves it)."""
    if share is None:
        yield
        return
    plan = kernels.count_plan
    kernels.count_plan = lambda b, n, sms=None: (-(-b * n // share), share)
    try:
        yield
    finally:
        kernels.count_plan = plan


def main_count_cases(dev, grad, corpus, noise) -> list:
    """The coefficients the balanced route gives the count kernel: the
    gradient and corpus batches at q85 4:2:0, and 3 noise images of
    517x389 (4,950 blocks an image: the wrapper's shares cross images), on
    the card."""
    import torch

    from pixo_tpu_torch.parallel.pipeline import jpeg_coeffs_sharded

    pattern = COUNT_PATTERNS["420"]
    cases = []
    for name, imgs in (("gradient", grad), ("corpus", corpus), ("noise", noise[:3])):
        h, w = imgs.shape[1], imgs.shape[2]
        opts = balanced_options(width=w, height=h)
        cases.append((f"{name} {len(imgs)}x{h}x{w} q{QUALITY} 4:2:0 coefficients",
                      jpeg_coeffs_sharded(torch.from_numpy(imgs).to(dev), opts, device=dev), pattern, None))
    return cases


def check_count_kernel(dev, main_cases) -> int:
    """Phase 2 for ``count_symbols``: on ``count_cases`` and on
    ``main_cases`` ((label, coefficients on the card, pattern, restart)),
    at byte offsets 0 and 2 of the input, under the wrapper's own plan and
    (but for the two largest batches) under ``COUNT_FORCED_SHARES``, equal
    to its plain version on the card and, image by image, to the host
    library's count. Returns the largest absolute error."""
    import numpy as np

    from pixo_tpu_torch import native
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.huffman_device import count_symbols_plain

    worst = 0
    cases = [(label, zz.cpu().numpy(), pat, ri) for label, zz, pat, ri in main_cases]
    for label, host, pattern, ri in cases + count_cases(np.random.default_rng(21)):
        ref_host = [native.native_count_symbols(host[i], pattern, ri) for i in range(host.shape[0])]
        shares = (None,) if host.size > 2**22 else (None, *COUNT_FORCED_SHARES)
        for share, offset in ((s, o) for s in shares for o in (0, 1)):  # int16 elements: bytes 0 and 2
            zz = at_offset(host, offset, dev)
            with count_shares(kernels, share):
                got = kernels.count_symbols(zz, pattern, ri)
            ref = count_symbols_plain(zz, pattern, ri)
            err = max(int((g - r).abs().max()) for g, r in zip(got, ref))
            dc, ac = (t.cpu().numpy() for t in got)
            host_bad = sum(
                not all(np.array_equal(a, b) for a, b in zip(
                    (dc[i, 0], dc[i, 1], ac[i, 0], ac[i, 1]), ref_host[i]))
                for i in range(host.shape[0]))
            worst = max(worst, err)
            plan = "the wrapper's plan" if share is None else f"shares of {share}"
            _verdict(f"check count_symbols {label} at byte offset {2 * offset}, {plan}: max_abs_err vs "
                     f"plain {err}, images differing from the host library {host_bad}/{host.shape[0]}",
                     err == 0 and host_bad == 0)
    return worst


def host_tier(imgs, opts, workers: int = 8):
    """Each image's JPEG from the port's host tier, ``jpeg.encode(img, opts,
    device="cpu")`` (the host library's coefficients, count and pack), on
    ``workers`` threads."""
    from pixo_tpu_torch import jpeg

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(lambda im: jpeg.encode(im, opts, device="cpu"), imgs))


def balanced_options(**kw):
    """The balanced preset (optimized Huffman tables) at q85 4:2:0, SIZE x
    SIZE, with the options ``kw`` replaced."""
    from pixo_tpu_torch import JpegOptions, Subsampling

    return JpegOptions.from_preset(SIZE, SIZE, QUALITY, 1).replace(subsampling=Subsampling.S420, **kw)


def jpeg_route_cases(grad, corpus) -> list:
    """Phase 3's batches of the optimized and progressive routes: (label,
    images, options)."""
    import numpy as np

    from pixo_tpu_torch import ColorType
    from pixo_tpu_torch.utils.synthetic import synth_gradient

    rng = np.random.default_rng(31)
    base = synth_gradient(SIZE, SIZE).astype(np.float64)
    light = (base + rng.normal(0, 4, (4, SIZE, SIZE, 3))).clip(0, 255).astype(np.uint8)
    mid = (base + rng.normal(0, 5, (4, SIZE, SIZE, 3))).clip(0, 255).astype(np.uint8)
    dense = rng.integers(0, 256, (4, SIZE, SIZE, 3), dtype=np.uint8)
    gray = np.ascontiguousarray(corpus[:8, :, :, 1])
    small = np.ascontiguousarray(corpus[:, :64, :64])  # 96 blocks an image: the SA fallback runs
    sa = balanced_options(progressive=True)
    return [
        ("balanced, gradient", grad, balanced_options()),
        ("balanced, corpus", corpus, balanced_options()),
        ("optimal, corpus", corpus, balanced_options(optimal_huffman=True)),
        ("balanced, noise sigma 4 (cap 16)", light, balanced_options()),
        ("balanced, noise sigma 5 q90 (cap 32)", mid, balanced_options(quality=90)),
        ("balanced, uniform noise q98 (dense)", dense, balanced_options(quality=98)),
        ("balanced, gray corpus, restart 5", gray,
         balanced_options(color_type=ColorType.GRAY, restart_interval=5)),
        ("progressive SA, corpus", corpus, sa),
        ("progressive no SA, corpus", corpus, sa.replace(progressive_sa=False)),
        ("progressive SA, corpus crops (SA fallback)", small, sa.replace(width=64, height=64)),
        ("progressive no SA, corpus crops", small,
         sa.replace(width=64, height=64, progressive_sa=False)),
    ]


def check_jpeg_routes(dev, grad, corpus) -> dict:
    """Phase 3 for the optimized-Huffman and progressive routes: each batch
    of ``jpeg_route_cases`` through ``encode_jpeg_batch_sharded(...,
    device="cuda")``, every file byte-equal to the host tier, with the
    launch counts of each call. Returns the launches of the balanced call
    on the gradient batch (the count kernel's main path)."""
    from pixo_tpu_torch import encode_jpeg_batch_sharded
    from pixo_tpu_torch.ops import kernels

    first = None
    for label, imgs, opts in jpeg_route_cases(grad, corpus):
        reset_counts()
        outs = encode_jpeg_batch_sharded(imgs, opts, device=dev)
        launches = {"coeffs": kernels.coeffs.launches, "count_symbols": kernels.count_symbols.launches,
                    "compact": kernels.compact_padded.launches}
        same = sum(a == b for a, b in zip(outs, host_tier(imgs, opts)))
        want_counts = 0 if opts.progressive else 1
        _verdict(f"route {label} {'x'.join(map(str, imgs.shape[:3]))} q{opts.quality}: "
                 f"{same}/{len(imgs)} files byte-equal to the host "
                 f"tier, mean {sum(map(len, outs)) / len(outs):.0f} B/file; launches {launches}",
                 same == len(imgs) and launches["coeffs"] == 1
                 and launches["count_symbols"] == want_counts)
        if first is None:
            first = launches
    return first


def time_kernel(name: str, at: str, call, plain, alone, card: str, plain_calls=(10, 5),
                kernel=None, library=None, **shape) -> dict:
    """Times kernel ``name`` four ways and prints one line: the profiler's
    device time (the kernel's own), the launch alone (the C function with
    everything made beforehand), the wrapper call and the
    plain version (CUDA events, per call; ``plain_calls`` gives the calls a
    repetition, the repetitions and the warm calls of a slow one), beside its bound at
    ``shape`` (``kernel_bound``) and the share of the bound that the device
    time reaches; ``kernel`` names the CUDA kernel for the profiler where
    it is not ``name`` + "_". ``library`` is one PyTorch call that computes
    the kernel's function, where there is one, timed as a yardstick
    (``library_ms``, CUDA events; the port never calls it); else
    ``library_ms`` is None."""
    bound, by = kernel_bound(name, **shape)
    key = kernel or f"{name}_"  # filter_rows_strip_kernel, coeffs_kernel, ...
    t = {"at": at, "ms": event_ms(call), "plain_ms": event_ms(plain, *plain_calls),
         "device_ms": profiler_ms(call, key),
         "launch_ms": event_ms(alone),
         "bound_ms": bound, "bound_by": by, "library_ms": None if library is None else event_ms(library)}
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    share = "not measured" if t["device_ms"] is None else f"{bound / t['device_ms']:.1%}"
    print(f"kernel {name} {at}: device {fmt(t['device_ms'])} (profiler, {PROFILED[key]} "
          f"launches traced in 20 calls), launch alone "
          f"{t['launch_ms']:.4f} ms, per call {t['ms']:.4f} ms, plain PyTorch {t['plain_ms']:.4f} ms, "
          f"library {fmt(t['library_ms'])}; "
          f"bound {bound:.4f} ms ({by}, {kernel_work(name, **shape)[0]} B, "
          f"{kernel_work(name, **shape)[1]} {OPS_TYPE.get(name, 'f32')} operations), device time at "
          f"{share} of it [{card}]")
    return t


def aan_library(blocks):
    """The AAN contract's yardstick, not bit-equal and never called by the
    port: one ``torch.matmul`` of the [N, 64] blocks by the 64x64 f32 matrix
    whose rows are the plain ``dct8x8_aan`` of the 64 unit blocks, in full
    f32 (TF32 off). Prints its largest difference from the kernel."""
    import torch

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.dct import dct8x8_aan as dct_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    n = blocks.shape[0]
    m = dct_plain(torch.eye(64, dtype=torch.float32, device=blocks.device).view(64, 8, 8)).view(64, 64)
    flat = blocks.view(n, 64)
    diff = float((torch.matmul(flat, m).view(n, 8, 8) - kernels.dct8x8_aan(blocks)).abs().max())
    print(f"dct8x8_aan yardstick: torch.matmul by the 64x64 DCT matrix, not bit-equal (yardstick only): "
          f"max_abs_diff from the kernel {diff}")
    return lambda: torch.matmul(flat, m)


def compact_library(zz, cap: int, kernel_out=None):
    """The compaction's yardstick, never called by the port: one
    ``torch.topk`` of ``cap`` over each block's packed key, the key of the
    JAX package's ``sparsify_blocks_padded`` (``pixo_tpu/ops/sparse_pack.py:
    111-117``: ``(64 - pos) << 16 | value`` for a nonzero AC, 0 else), built
    here beforehand from the [B, N, 64] int16 ``zz``. Where ``kernel_out``
    (``compact_padded``'s result) is given, prints whether the positions and
    values that the top ``cap`` keys spell equal the kernel's."""
    import torch

    ac = zz[..., 1:].to(torch.int32)
    pos = torch.arange(1, 64, dtype=torch.int32, device=zz.device)
    key = (torch.where(ac != 0, 64 - pos, 0) << 16) | (ac & 0xFFFF)
    if kernel_out is not None:
        top = torch.topk(key, cap, dim=-1).values
        keyk = top >> 16
        poss = torch.where(keyk > 0, 64 - keyk, 0).to(torch.uint8)
        vals = (top & 0xFFFF).to(torch.int16)
        fits = kernel_out[1].to(torch.int32) <= cap
        same = (torch.equal(poss[fits], kernel_out[2][fits]) and torch.equal(vals[fits], kernel_out[3][fits]))
        print(f"compact yardstick: torch.topk of {cap} over the packed (64 - pos) << 16 | value key of "
              f"{tuple(key.shape)} int32 (the JAX package's lax.top_k; yardstick only): its positions "
              f"and values equal the kernel's in every block within the cap: {same}")
    return lambda: torch.topk(key, cap, dim=-1)


def idct_matrix(device):
    """[64, 64] f32: row v * 8 + u is the exact float IDCT (T.81 A.3.3) of the
    unit coefficient at natural position (v, u), without the level shift."""
    import math

    import torch

    c = [1 / math.sqrt(2)] + [1.0] * 7
    m = torch.empty(64, 64, dtype=torch.float64)
    for v in range(8):
        for u in range(8):
            for y in range(8):
                for x in range(8):
                    m[v * 8 + u, y * 8 + x] = (0.25 * c[u] * c[v] * math.cos((2 * x + 1) * u * math.pi / 16)
                                               * math.cos((2 * y + 1) * v * math.pi / 16))
    return m.to(torch.float32).to(device)


def idct_library(blocks):
    """The integer IDCT contract's yardstick, not bit-equal and never called
    by the port: one ``torch.matmul`` of the [N, 64] blocks (as f32) by the
    64x64 f32 IDCT matrix (``idct_matrix``), in full f32 (TF32 off); the
    level shift and clamp are not in the call. Prints the largest difference
    of its rounded, shifted and clamped result from the kernel's."""
    import torch

    from pixo_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    n = blocks.shape[0]
    m = idct_matrix(blocks.device)
    flat = blocks.view(n, 64).to(torch.float32)
    px = (torch.matmul(flat, m).round() + 128).clamp(0, 255).view(n, 8, 8)
    diff = int((px - kernels.idct8x8_int(blocks).to(torch.float32)).abs().max())
    print(f"idct8x8_int yardstick: torch.matmul by the 64x64 f32 IDCT matrix, not bit-equal (yardstick "
          f"only): max_abs_diff from the kernel after rounding, +128 and the clamp {diff}")
    return lambda: torch.matmul(flat, m)


def time_everything(dev, grad, n_dct: int, card: str) -> dict:
    """Phase 4: median times on the card. Kernel times as ``time_kernel``
    gives them; stage times are host-clock times of one call ending in a
    synchronize (``wall_ms``)."""
    import numpy as np
    import torch

    from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.blockify import scan_layout
    from pixo_tpu_torch.ops.dct import dct8x8_aan as dct_plain
    from pixo_tpu_torch.ops.sparse_pack import sparsify_blocks_padded_batch
    from pixo_tpu_torch.parallel.pipeline import (_fetch_compacted, _pack_hosted, _to_device,
                                                  jpeg_coeffs_sharded)

    b, size = grad.shape[0], grad.shape[1]
    shape = f"{b}x{size}x{size}"
    mp = b * size * size / 1e6
    opts = JpegOptions(width=size, height=size, quality=QUALITY, subsampling=Subsampling.S420)
    quant = QuantizationTables(QUALITY)
    lum, chrom = quant.luminance_table, quant.chrominance_table
    grad_dev = torch.from_numpy(grad).to(dev)
    zz, launchers = main_path_launchers(kernels, grad_dev, lum, chrom)
    blocks = torch.from_numpy(
        np.random.default_rng(2).uniform(-128, 127, (n_dct, 8, 8)).astype(np.float32)
    ).to(dev)
    dct_out = torch.empty_like(blocks)
    lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
    at = f"{shape} q{QUALITY} 4:2:0"
    k_ms = {
        "coeffs": time_kernel(
            "coeffs", at, launchers["coeffs"][0],
            lambda: kernels.coeffs_plain(grad_dev, lum, chrom, "420"), launchers["coeffs"][1],
            card, b=b, h=size, w=size, c=3, mode="420"),
        "compact": time_kernel(
            "compact", f"{at} cap 8", launchers["compact"][0],
            lambda: sparsify_blocks_padded_batch(zz, 8), launchers["compact"][1],
            card, library=compact_library(zz, 8, kernels.compact_padded(zz, 8)), b=b, n=zz.shape[1], cap=8),
        "dct8x8_aan": time_kernel(
            "dct8x8_aan", f"{n_dct} blocks", lambda: kernels.dct8x8_aan(blocks),
            lambda: dct_plain(blocks),
            lambda: lib.pixo_dct8x8_aan(blocks.data_ptr(), dct_out.data_ptr(), n_dct, stream),
            card, library=aan_library(blocks), n=n_dct),
    }

    _, _, pattern = scan_layout(size, size, "rgb", "420")
    compacted = kernels.compact_padded(zz, 8)
    state = _fetch_compacted(zz, compacted)
    stages = {
        # the path's copy up (pinned staging, parallel/pipeline.py::_to_device)
        # beside a pageable .to() of the same batch, as the path made it before
        "h2d": wall_ms(lambda: _to_device(grad, dev)),
        "h2d_pageable": wall_ms(lambda: torch.from_numpy(grad).to(dev)),
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


def count_alone(kernels, zz, pattern, lib=None, planned=None, plan=None):
    """The count kernel's launch alone on ``zz`` [B, N, 64]: the C function
    of ``lib`` (the kernel library by default) with its output, slot table,
    plan and scratch made beforehand (no restart interval). The design of
    PR 12 (CTAs of 128 blocks) takes no plan; this one takes the wrapper's
    plan (or ``plan``, (grid, share)). ``planned`` says which (by default:
    whether ``kernels`` has a plan)."""
    import torch

    b, n = zz.shape[0], zz.shape[1]
    lib, stream = lib or kernels.load(), torch.cuda.current_stream().cuda_stream
    hist = torch.empty((b, kernels.HIST_BINS), dtype=torch.int64, device=zz.device)
    slots = kernels.count_layout(tuple(pattern))
    if hasattr(kernels, "count_plan") if planned is None else planned:
        grid, share = plan or kernels.count_plan(b, n, kernels._count_slots(zz.device))

        def alone():
            return lib.pixo_count_symbols(zz.data_ptr(), b, n, slots.ctypes.data, len(pattern), 0,
                                          grid, share, hist.data_ptr(), stream)
    else:
        def alone():
            return lib.pixo_count_symbols(zz.data_ptr(), b, n, slots.ctypes.data, len(pattern), 0,
                                          hist.data_ptr(), stream)

    if alone():
        raise Failed("the count kernel's launch alone returned an error")
    alone.hist = hist
    return alone


def time_jpeg_routes(dev, grad, corpus, card: str) -> dict:
    """Phase 4 for the optimized-Huffman and progressive routes. The
    balanced route (``balanced_options``) on the gradient batch: the count
    kernel four ways beside its bound (``time_kernel``), then each stage,
    median host-clock ms of WARM_RUNS synchronized calls (``wall_ms``): the
    copy up, the device stage (``coeffs``, ``count_symbols``, ``compact``),
    the copies back (compacted streams and histograms), the tables of every
    image on 8 threads, the pack with them on 8 threads, the whole call, and
    the host tier (``jpeg.encode(..., device="cpu")``) on 8 threads. The
    progressive route with SA on the corpus batch at q85 4:2:0: the device
    stage with its dense copy back, the host stage (each image's scans on 8
    threads), the whole call and the host tier on 8 threads (median, least,
    most of THUMB_RUNS, ``wall_stats``). Returns the count kernel's times."""
    import torch

    from pixo_tpu_torch import encode_jpeg_batch_sharded
    from pixo_tpu_torch.jpeg import encoder as jenc
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.huffman_device import count_symbols_plain
    from pixo_tpu_torch.parallel.pipeline import (_fetch_compacted, _pack_hosted, _to_device,
                                                  jpeg_coeffs_sharded)

    b, size = grad.shape[0], grad.shape[1]
    shape = f"{b}x{size}x{size}"
    mp = b * size * size / 1e6
    opts = balanced_options()
    _, pattern = jenc._pattern(opts)
    grad_dev = torch.from_numpy(grad).to(dev)
    zz = jpeg_coeffs_sharded(grad_dev, opts, device=dev)
    at = f"{shape} q{QUALITY} 4:2:0 balanced"
    k_ms = {"count_symbols": time_kernel(
        "count_symbols", at, lambda: kernels.count_symbols(zz, pattern),
        lambda: count_symbols_plain(zz, pattern), count_alone(kernels, zz, pattern), card,
        b=b, n=zz.shape[1])}
    one = zz[:1].contiguous()  # jpeg.encode's batch of one
    time_kernel("count_symbols", f"1x{size}x{size} q{QUALITY} 4:2:0 balanced, one image",
                lambda: kernels.count_symbols(one, pattern), lambda: count_symbols_plain(one, pattern),
                count_alone(kernels, one, pattern), card, b=1, n=one.shape[1])

    counts = kernels.count_symbols(zz, pattern)
    compacted = kernels.compact_padded(zz, 8)
    state = _fetch_compacted(zz, compacted)
    dc, ac = (h.cpu().numpy() for h in counts)
    built = [jenc.tables_from_counts(dc[i], ac[i], opts) for i in range(b)]

    def tables_on_pool():
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            return list(ex.map(lambda i: jenc.tables_from_counts(dc[i], ac[i], opts), range(b)))

    def device_stage():
        z = jpeg_coeffs_sharded(grad_dev, opts, device=dev)
        return kernels.count_symbols(z, pattern), kernels.compact_padded(z, 8)

    stages = {
        "balanced_h2d": wall_ms(lambda: _to_device(grad, dev)),
        "balanced_device": wall_ms(device_stage),
        "balanced_d2h": wall_ms(lambda: (_fetch_compacted(zz, compacted), [h.cpu() for h in counts])),
        "balanced_host_tables": wall_ms(tables_on_pool),
        "balanced_host_pack": wall_ms(lambda: _pack_hosted(state, opts, pattern, 8, built.__getitem__)),
        "balanced_end_to_end": wall_ms(lambda: encode_jpeg_batch_sharded(grad, opts, device=dev)),
        "balanced_host_library_8_threads": wall_ms(lambda: host_tier(grad, opts)),
    }
    for name, ms in stages.items():
        print(f"stage {name} {shape} q{QUALITY} 4:2:0: median {ms:.4f} ms, "
              f"{mp / (ms / 1e3):.1f} MP/s over {WARM_RUNS} warm runs [{card}]")
    device = k_ms["count_symbols"]["device_ms"]
    if device:
        print(f"balanced route: the host tables take {stages['balanced_host_tables'] / device:.0f}x "
              f"the count kernel's device time [{card}]")

    popts = balanced_options(progressive=True)
    quant = QuantizationTables(QUALITY)
    corpus_dev = torch.from_numpy(corpus).to(dev)
    zz_host = jpeg_coeffs_sharded(corpus_dev, popts, device=dev).cpu().numpy()

    def progressive_host():
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            return list(ex.map(lambda i: jenc._emit_with_sa_fallback(
                zz_host[i], None, popts, quant, pattern, zz_host.shape[1]), range(len(zz_host))))

    pstages = {
        "progressive_device_d2h": wall_stats(
            lambda: jpeg_coeffs_sharded(corpus_dev, popts, device=dev).cpu()),
        "progressive_host": wall_stats(progressive_host),
        "progressive_end_to_end": wall_stats(lambda: encode_jpeg_batch_sharded(corpus, popts, device=dev)),
        "progressive_host_library_8_threads": wall_stats(lambda: host_tier(corpus, popts)),
    }
    cmp = corpus.shape[0] * corpus.shape[1] * corpus.shape[2] / 1e6
    for name, (med, lo, hi) in pstages.items():
        print(f"stage {name} corpus {corpus.shape[0]}x{corpus.shape[1]}x{corpus.shape[2]} q{QUALITY} "
              f"4:2:0 SA: median {med:.4f} ms ({lo:.4f} to {hi:.4f}), {cmp / (med / 1e3):.1f} MP/s "
              f"over {THUMB_RUNS} warm runs [{card}]")
    return k_ms


def max_options(**kw):
    """The max preset (progressive with SA, optimized tables, trellis) at q85
    4:2:0, SIZE x SIZE, with the options ``kw`` replaced."""
    from pixo_tpu_torch import JpegOptions

    return JpegOptions.max(SIZE, SIZE, QUALITY).replace(**kw)


def trellis_cells(grad, corpus) -> dict:
    """The max preset's cells, {key: (label, images)}: (m1) the gradient
    batch (98,304 blocks, most of which take the all-zero exit) and (m2) the
    first 12 images of PNG (a)'s batch (three photo fixtures, four shifts
    each: 73,728 blocks, where the DP runs)."""
    import numpy as np

    return {"m1": (f"gradient {len(grad)}x{SIZE}x{SIZE}", grad),
            "m2": (f"corpus 12x{SIZE}x{SIZE}", np.ascontiguousarray(corpus[:12]))}


def cell_trellis_inputs(dev, imgs):
    """A max cell's trellis inputs on the card: its [B * N, 64] f32 DCT (the
    ``dct_zz`` kernel's), the zigzag tables and the 4:2:0 pattern."""
    import torch

    from pixo_tpu_torch.jpeg import encoder as jenc
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels

    dct = kernels.dct_zz(torch.from_numpy(imgs).to(dev), "420").reshape(-1, 64)
    return dct, *jenc.zigzag_tables(QuantizationTables(QUALITY)), TRELLIS_PATTERNS["420"]


def dp_blocks(dct, lum, chrom, pattern) -> int:
    """The blocks of [N, 64] f32 ``dct`` that run the trellis DP: those with
    an AC where 2|coef| >= q (the rest take the all-zero exit)."""
    import torch

    from pixo_tpu_torch.ops.trellis_device import block_tables

    q = block_tables(lum, chrom, pattern, dct.shape[0], dct.device)
    return int(((2 * dct[:, 1:].abs()) >= q[:, 1:]).any(dim=1).sum())


def check_trellis_kernels(dev, grad, noise, cells) -> dict:
    """Phase 2 for the max route's kernels. ``dct_zz`` in all four modes on
    the gradient and noise batches and ``coeff_edge_cases``, bit for bit
    against its plain version on the card and image by image against the
    host library's ``native_jpeg_dct_zz``; ``trellis_quantize`` on
    ``trellis_edge_blocks`` (every pattern), 70,000 random blocks,
    ``trellis_mixed_blocks`` and the real DCT of cells (m1) and (m2)
    (``trellis_cells``), bit for bit against its plain version on the card
    and against the host library's DP. Prints the occupancy of the
    coefficient kernel, its f32 variant and the trellis kernel. Returns the
    largest absolute error of each."""
    import numpy as np
    import torch

    from pixo_tpu_torch import native
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.trellis_device import trellis_quantize_batch_plain

    modes = ("gray", "444", "420", "422")
    occ = {raw: {m: kernels.coeffs_ctas_per_sm(m, 3, raw) for m in modes} for raw in (False, True)}
    slots = {m: kernels.dct_zz_slots(dev, m, 1 if m == "gray" else 3) for m in modes}
    print(f"occupancy at 3 channels, CTAs an SM: coeffs {occ[False]}, dct_zz {occ[True]} (its plan takes "
          f"{ {m: kernels.dct_zz_plan_ctas(m) for m in modes} }: slots {slots}); "
          f"trellis_quantize {kernels.load().pixo_trellis_ctas_per_sm()}")
    errs = {"dct_zz": 0.0, "trellis_quantize": 0}
    named = [(f"{name} {'x'.join(map(str, batch.shape[:3]))}", batch)
             for name, batch in (("gradient", grad), ("noise", noise))]
    cases = [(label, mode, batch) for label, batch in named + coeff_edge_cases(np.random.default_rng(8))
             for mode in modes] + dct_zz_tile_cases(slots)
    for label, mode, batch in cases:
        host = np.ascontiguousarray(batch[..., 0] if mode == "gray" and batch.ndim == 4 else batch)
        x = torch.from_numpy(host).to(dev)
        got, ref = kernels.dct_zz(x, mode), kernels.dct_zz_plain(x, mode)
        equal = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        err = float((got - ref).abs().max())
        errs["dct_zz"] = max(errs["dct_zz"], err)
        got_h = got.cpu().numpy()
        rgb = host if mode == "gray" else np.ascontiguousarray(host[..., :3])
        host_bad = sum(not np.array_equal(got_h[i].view(np.int32),
                                          native.native_jpeg_dct_zz(rgb[i], mode).view(np.int32))
                       for i in range(len(host)))
        _verdict(f"check dct_zz mode={mode} {label}: bitwise equal to plain {equal}, max_abs_err "
                 f"{err}, images differing from the host library {host_bad}/{len(host)}",
                 equal and host_bad == 0)

    rng = np.random.default_rng(61)
    cases = [(label, torch.from_numpy(dct).to(dev), lum, chrom, pat)
             for label, dct, lum, chrom, pat in trellis_edge_blocks(rng)]
    lum, chrom = (rng.integers(1, 80, 64).astype(np.float32) for _ in range(2))
    cases.append(("random 70000 (over 65,535 blocks)",
                  torch.from_numpy(trellis_random_blocks(rng, 70_000)).to(dev), lum, chrom,
                  TRELLIS_PATTERNS["420"]))
    dct, lum, chrom, pattern = trellis_mixed_blocks(rng, 4099)
    cases.append(("mixed warps 4099 (ZRL, pass-through, dense, exit)", torch.from_numpy(dct).to(dev), lum,
                  chrom, pattern))
    cases += [(f"({key}) {label} q{QUALITY} 4:2:0 DCT", *cell_trellis_inputs(dev, imgs))
              for key, (label, imgs) in cells.items()]
    for label, dct, lum, chrom, pattern in cases:
        got = kernels.trellis_quantize(dct, lum, chrom, pattern)
        ref = trellis_quantize_batch_plain(dct, lum, chrom, pattern)
        err = int((got.int() - ref.int()).abs().max())
        errs["trellis_quantize"] = max(errs["trellis_quantize"], err)
        host = native.native_trellis_quantize(dct.cpu().numpy(), pattern, lum, chrom)
        host_bad = int((got.cpu().numpy() != host).any(axis=1).sum())
        _verdict(f"check trellis_quantize {label}: {dct.shape[0]} blocks, "
                 f"{dp_blocks(dct, lum, chrom, pattern)} through the DP; max_abs_err vs plain {err}, "
                 f"blocks differing from the host library {host_bad}", err == 0 and host_bad == 0)
    return errs


def trellis_route_cases(corpus) -> list:
    """Phase 3's further max-preset batches, for correctness: (label,
    images, options, the launches the call must make)."""
    import numpy as np

    from pixo_tpu_torch import ColorType, Subsampling

    small = np.ascontiguousarray(corpus[:, :64, :64])  # 96 blocks an image: the SA fallback runs
    gray = np.ascontiguousarray(corpus[:4, :, :, 1])
    trellis = {"coeffs": 0, "dct_zz": 1, "trellis_quantize": 1}
    return [
        ("corpus crops 64x64 (SA fallback)", small, max_options(width=64, height=64), trellis),
        ("one corpus crop 64x64 (96 blocks)", small[:1], max_options(width=64, height=64), trellis),
        ("gray, restart 5", gray, max_options(color_type=ColorType.GRAY, restart_interval=5), trellis),
        ("4:4:4 optimal, no SA", corpus[:4],
         max_options(subsampling=Subsampling.S444, optimal_huffman=True, progressive_sa=False), trellis),
        ("baseline balanced with trellis_quant (the trellis unused)", corpus[:4],
         balanced_options(trellis_quant=True), {"coeffs": 1, "dct_zz": 0, "trellis_quantize": 0}),
    ]


def check_trellis_path(dev, cells, corpus) -> dict:
    """Phase 3 for the max route: each cell of ``trellis_cells`` through
    ``encode_jpeg_batch_sharded(..., device="cuda")`` (one ``dct_zz`` and
    one ``trellis_quantize`` launch, no ``coeffs``), then the batches of
    ``trellis_route_cases``; every file byte-equal to the host tier
    (``jpeg.encode_batch(..., device="cpu")``: the host library's DCT and
    DP). Returns the launches of each cell's call, by cell."""
    from pixo_tpu_torch import encode_jpeg_batch_sharded, jpeg
    from pixo_tpu_torch.ops import kernels

    def run(label, imgs, opts, want):
        reset_counts()
        outs = encode_jpeg_batch_sharded(imgs, opts, device=dev)
        launches = {"coeffs": kernels.coeffs.launches, "dct_zz": kernels.dct_zz.launches,
                    "trellis_quantize": kernels.trellis_quantize.launches}
        same = sum(a == b for a, b in zip(outs, jpeg.encode_batch(imgs, opts, device="cpu")))
        _verdict(f"max route {label} q{opts.quality}: {same}/{len(imgs)} "
                 f"files byte-equal to the host tier, mean {sum(map(len, outs)) / len(outs):.0f} B/file; "
                 f"launches {launches}", same == len(imgs) and launches == want)
        return launches

    found = {key: run(f"({key}) {label}", imgs, max_options(),
                      {"coeffs": 0, "dct_zz": 1, "trellis_quantize": 1})
             for key, (label, imgs) in cells.items()}
    for label, imgs, opts, want in trellis_route_cases(corpus):
        run(label, imgs, opts, want)
    return found


def trellis_alone(lib, dct, lum, chrom, pattern):
    """The trellis kernel's launch alone on [N, 64] ``dct``: the C function
    of ``lib`` (the kernel library, or a variant of ``trellis_parts``) with
    its output made beforehand, which the launcher keeps as ``.out``."""
    import numpy as np
    import torch

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.trellis_device import RATE_LUT

    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(dct.shape, dtype=torch.int16, device=dct.device)
    lum32, chrom32 = kernels._table(lum), kernels._table(chrom)
    pat = np.asarray(pattern, np.uint8)

    def alone():
        return lib.pixo_trellis_quantize(dct.data_ptr(), dct.shape[0], lum32.ctypes.data,
                                         chrom32.ctypes.data, pat.ctypes.data, len(pat), 1.0,
                                         RATE_LUT.ctypes.data, out.data_ptr(), stream)

    if alone():
        raise Failed("the trellis kernel's launch alone returned an error")
    alone.out = out
    return alone


# The dct_zz kernel at 4:2:0 in the profiler's names (demangled and mangled):
# its own kernel, or an earlier checkout's f32 variant of the coefficient
# kernel, so that --compare reads both trees.
DCT_ZZ_KERNEL = ("dct_zz_kernel<2>", "dct_zz_kernelILi2EE", "coeffs_kernel<2, true>", "coeffs_kernelILi2ELb1E")


def dct_zz_alone(kernels, imgs_dev):
    """The ``dct_zz`` kernel's launch alone at 4:2:0 on ``imgs_dev``."""
    import torch

    from pixo_tpu_torch.ops.blockify import num_blocks

    b, h, w, c = imgs_dev.shape
    lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
    out = torch.empty((b, num_blocks(h, w, "420"), 64), dtype=torch.float32, device=imgs_dev.device)

    def alone():
        return lib.pixo_dct_zz(imgs_dev.data_ptr(), b, h, w, c, 2, out.data_ptr(), stream)

    if alone():
        raise Failed("the dct_zz kernel's launch alone returned an error")
    return alone


def time_trellis(dev, cells, card: str) -> dict:
    """Phase 4 for the max route. For each cell of ``trellis_cells``:
    ``dct_zz`` and ``trellis_quantize`` four ways beside their bounds
    (``time_kernel``; the trellis' operations count the blocks that run the
    DP in this data), then the stages, median, least and most of THUMB_RUNS
    synchronized calls (``wall_stats``): the copy up, ``dct_zz``, the
    trellis kernel, the int16 copy back, the progressive scans of every
    image on 8 threads, the whole call, the host library's DP alone on 8
    threads (the f32 DCT already on the host) and the host tier
    (``jpeg.encode_batch(..., device="cpu")``) on 8 threads. Returns (m1)'s
    kernel times, with (m2)'s under "m2"."""
    import torch

    from pixo_tpu_torch import encode_jpeg_batch_sharded, jpeg, native
    from pixo_tpu_torch.jpeg import encoder as jenc
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.trellis_device import trellis_quantize_batch_plain
    from pixo_tpu_torch.parallel.pipeline import _to_device

    opts = max_options()
    quant = QuantizationTables(QUALITY)
    found = {}
    for key, (label, imgs) in cells.items():
        b = len(imgs)
        imgs_dev = torch.from_numpy(imgs).to(dev)
        dct, lum, chrom, pattern = cell_trellis_inputs(dev, imgs)
        n = dct.shape[0] // b
        dp = dp_blocks(dct, lum, chrom, pattern)
        at = f"({key}) {label} q{QUALITY} 4:2:0 max"
        k_ms = {
            "dct_zz": time_kernel(
                "dct_zz", at, lambda: kernels.dct_zz(imgs_dev, "420"),
                lambda: kernels.dct_zz_plain(imgs_dev, "420"), dct_zz_alone(kernels, imgs_dev), card,
                kernel=DCT_ZZ_KERNEL, b=b, h=SIZE, w=SIZE, c=3, mode="420"),
            "trellis_quantize": time_kernel(
                "trellis_quantize", f"{at}, {dp} of {dct.shape[0]} blocks through the DP",
                lambda: kernels.trellis_quantize(dct, lum, chrom, pattern),
                lambda: trellis_quantize_batch_plain(dct, lum, chrom, pattern),
                trellis_alone(kernels.load(), dct, lum, chrom, pattern), card, plain_calls=(2, 3),
                n=dct.shape[0], dp=dp),
        }
        found[key] = k_ms
        zz_dev = kernels.trellis_quantize(dct, lum, chrom, pattern)
        zz = zz_dev.cpu().numpy().reshape(b, n, 64)
        dct_host = dct.cpu().numpy()

        def host_scans():
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(lambda i: jenc._emit_with_sa_fallback(
                    zz[i], None, opts, quant, pattern, n), range(b)))

        stages = {
            "max_h2d": wall_stats(lambda: _to_device(imgs, dev)),
            "max_dct_zz": wall_stats(lambda: kernels.dct_zz(imgs_dev, "420")),
            "max_trellis": wall_stats(lambda: kernels.trellis_quantize(dct, lum, chrom, pattern)),
            "max_d2h": wall_stats(lambda: zz_dev.cpu()),
            "max_host_scans": wall_stats(host_scans),
            "max_end_to_end": wall_stats(lambda: encode_jpeg_batch_sharded(imgs, opts, device=dev)),
            "max_host_trellis_8_threads": wall_stats(
                lambda: native.native_trellis_quantize(dct_host, pattern, lum, chrom, nthreads=8)),
            "max_host_library_8_threads": wall_stats(
                lambda: jpeg.encode_batch(imgs, opts, device="cpu")),
        }
        mp = b * SIZE * SIZE / 1e6
        for name, (med, lo, hi) in stages.items():
            print(f"stage {name} ({key}) {label} q{QUALITY} 4:2:0: median {med:.4f} ms ({lo:.4f} to "
                  f"{hi:.4f}), {mp / (med / 1e3):.1f} MP/s over {THUMB_RUNS} warm runs [{card}]")
    return {**found["m1"], "m2": found["m2"]}


def filter_edge_cases(rng, bpp: int):
    """The fused filter kernel's edge shapes for ``bpp``, (label, [B, H, RB]
    uint8): rows of 1, bpp - 1, bpp, 15, 16 and 17 bytes; heights of 1, of
    one strip of the strip kernel, of one strip and a row, 32 and 33 (the
    sticky rule's limit); all-zero and all-255 rows (every score tied); and,
    for bpp 4, the longest row the strip kernel takes and the shortest the
    long-row kernel does (``filter_rows_plan``)."""
    import numpy as np

    from pixo_tpu_torch.ops import kernels

    strip = kernels.FILTER_STRIP_ROWS
    shapes = [(2, 1, 1), (2, strip, 15), (2, strip + 1, 16), (3, 33, 17), (2, 32, bpp),
              (1, 2 * strip + 3, 40 + bpp)]
    if bpp > 1:
        shapes.append((2, 3, bpp - 1))
    cases = [(f"noise {b}x{h}x{rb}", rng.integers(0, 256, (b, h, rb), dtype=np.uint8))
             for b, h, rb in shapes]
    cases += [(f"all {v} 2x{strip + 2}x{3 * bpp + 1}", np.full((2, strip + 2, 3 * bpp + 1), v, np.uint8))
              for v in (0, 255)]
    if bpp == 4:
        h = strip + 1
        fits = max(rb for rb in range(1, 1 << 17) if kernels.filter_rows_plan(h, rb, False))
        for rb in (fits, fits + 1):
            plan = kernels.filter_rows_plan(h, rb, False)
            cases.append((f"low noise 1x{h}x{rb} ({'strips of ' + str(plan) if plan else 'long rows'})",
                          rng.integers(0, 9, (1, h, rb), dtype=np.uint8)))
    return cases


UNFILTER_BAND_ROWS = (1023, 1024, 1025, 2100)  # heights around and past 1024 rows: groups wrap round the warps
# (label, B, H, RB, bpp): heights around csrc/unfilter.cu's warp group (32
# rows), a CTA of 16 warps (512) and the plan's clusters of 8 CTAs: at rows
# of 513 pixels, 24 warps (769 rows wrap round them); at 2051, 64 warps
# (2049 rows wrap)
UNFILTER_SCHEDULE_CASES = (("group", 2, 31, 10, 3), ("group", 2, 32, 11, 3), ("group", 2, 33, 9, 3),
                           ("CTA", 1, 513, 1537, 3), ("cluster", 2, 768, 1539, 3), ("cluster wrap", 1, 769, 1537, 3),
                           ("cluster wrap", 1, 2049, 2051, 1))


def unfilter_edge_cases(rng) -> list:
    """The unfilter kernel's cases, (label, [B, H, RB] uint8 filtered rows,
    [B, H] int32 filter ids, bpp): for every bpp 1 to 8 a batch whose rows
    take every filter id 0-4 in turn and at random; one row (H = 1), rows
    shorter than a pixel (RB < bpp), rows of one byte, all-255 rows (every
    predictor at its largest); ids outside 0-4, which take no predictor;
    batches whose heights end around the kernel's warp group, CTA and
    cluster split (``UNFILTER_SCHEDULE_CASES``) and whose groups wrap round
    the warps (``UNFILTER_BAND_ROWS``)."""
    import numpy as np

    def case(label, b, h, rb, bpp, filters=None, fill=None):
        rows = (np.full((b, h, rb), fill, np.uint8) if fill is not None
                else rng.integers(0, 256, (b, h, rb), dtype=np.uint8))
        if filters is None:
            filters = np.where(np.arange(h) < 5, np.arange(h) % 5, rng.integers(0, 5, (b, h)))
        return (f"{label} {b}x{h}x{rb} bpp={bpp}", rows,
                np.ascontiguousarray(np.broadcast_to(filters, (b, h)), dtype=np.int32), bpp)

    cases = []
    for bpp in range(1, 9):
        cases += [case("every id", 3, 13, 5 * bpp + 3, bpp),
                  case("one row", 2, 1, 4 * bpp + 1, bpp),
                  case("one byte", 2, 9, 1, bpp),
                  case("all 255", 1, 7, 3 * bpp + 2, bpp, fill=255)]
        if bpp > 1:
            cases.append(case("RB<bpp", 2, 6, bpp - 1, bpp))
    cases.append(case("ids 5, 7, 255", 1, 6, 10, 3, filters=np.array([4, 5, 1, 7, 255, 2])))
    for h in UNFILTER_BAND_ROWS:
        cases.append(case("band", 2, h, 7, 4 if h % 2 else 3))
    for label, b, h, rb, bpp in UNFILTER_SCHEDULE_CASES:
        cases.append(case(label, b, h, rb, bpp))
    return cases


def bigram_edge_cases(rng, bpp: int):
    """Mode 7's (Bigrams') own edge shapes for ``bpp``, (label, [B, H, RB]
    uint8): rows of 1 and 2 bytes (one pair or none); all-zero rows (every
    candidate counts one pair: None wins the tie); identical ramp rows (Up
    and Paeth tie at one pair, and on row 0 Sub and Paeth: the lower id
    wins); and, for bpp 4, the longest row the strip kernel takes under
    mode 7's plan (8 KB more a row) and the shortest the long-row kernel
    does. The 262,140-byte noise rows of ``check_png_kernels``, whose pairs
    fill most of the bitmap, take the long-row kernel in mode 7 too. For
    bpp 1, 3, 4 and 8 also ``bigram_merge_cases``, which stress how the
    strip kernel's lanes meet in the bitmap."""
    import numpy as np

    from pixo_tpu_torch.ops import kernels

    strip = kernels.FILTER_STRIP_ROWS
    cases = [(f"bigram noise 2x{strip + 1}x{rb}", rng.integers(0, 256, (2, strip + 1, rb), dtype=np.uint8))
             for rb in (1, 2)]
    cases.append((f"bigram zeros 2x{strip + 2}x{4 * bpp + 3}", np.zeros((2, strip + 2, 4 * bpp + 3), np.uint8)))
    ramp = (np.arange(3 * bpp + 41) % 256).astype(np.uint8)
    cases.append((f"bigram tied ramp 2x{strip + 3}x{ramp.size}",
                  np.broadcast_to(ramp, (2, strip + 3, ramp.size)).copy()))
    if bpp == 4:
        h = strip + 1
        fits = max(rb for rb in range(1, 1 << 17) if kernels.filter_rows_plan(h, rb, False, True))
        for rb in (fits, fits + 1):
            plan = kernels.filter_rows_plan(h, rb, False, True)
            cases.append((f"bigram noise 1x{h}x{rb} ({'strips of ' + str(plan) if plan else 'long rows'})",
                          rng.integers(0, 256, (1, h, rb), dtype=np.uint8)))
    if bpp in (1, 3, 4, 8):
        cases += bigram_merge_cases(rng, bpp)
    return cases


BIGRAM_STEP = 128  # bytes a step of the mode 7 strip kernel's walk: 32 lanes of a word each


def bigram_merge_cases(rng, bpp: int):
    """Rows on which the lanes of one mode-7 mark instruction (lane l of a
    step takes word k = 32s + l, instruction j the pair that starts at byte
    4k + j) meet in the bitmap, (label, [B, H, RB] uint8):
    - a period of four distinct bytes: under None every instruction puts
      all 32 lanes on one key, and no pair equals the one before it;
    - bytes 4k and 4k + 1 of None's words 77 and 96 + l for lane l: pair 0
      of every lane on one bitmap word (word key >> 5) with 32 keys, pair 2
      alike;
    - at lengths around the steps of 128 bytes, images of two rows: a noise
      row, and the same row but for one byte pair put at every lane-31/lane-0
      step boundary (bytes 128s - 1 and 128s). Under Up and Paeth the second
      row is zeros but at the boundaries, and the images drawn are those
      whose second row ties its two fewest counts under ``bpp`` (the plain
      version's), so that a count one off at a boundary changes the filter
      chosen."""
    import numpy as np
    import torch

    from pixo_tpu_torch.ops import png_filters

    step = BIGRAM_STEP
    period = np.resize(np.array([17, 90, 201, 3], np.uint8), 2 * step + 1)
    cases = [(f"bigram one key a lane instruction 2x9x{period.size}",
              np.broadcast_to(period, (2, 9, period.size)).copy())]
    words = 3 * 32 + 1
    row = rng.integers(0, 256, 4 * words + 2, dtype=np.uint8)
    k = np.arange(words)
    row[4 * k], row[4 * k + 1] = 77, 96 + k % 32
    row[4 * k + 2], row[4 * k + 3] = 200, 32 + (k + 5) % 32
    cases.append((f"bigram one word 32 keys 2x9x{row.size}", np.broadcast_to(row, (2, 9, row.size)).copy()))
    for rb in [step * s + t for s in (1, 2, 3) for t in (-1, 0, 1, 2, 5)]:
        tied, edges = [], np.arange(step, rb, step)
        for _ in range(400):
            img = np.broadcast_to(rng.integers(0, 256, rb, dtype=np.uint8), (2, rb)).copy()
            img[1, edges - 1], img[1, edges] = rng.integers(0, 256, 2)
            counts = png_filters._bigram_scores(png_filters._candidates(torch.from_numpy(img), bpp))
            two = np.sort(counts[1].numpy())[:2]
            if two[0] == two[1]:
                tied.append(img)
            if len(tied) == 2:
                break
        found = tied or [img]
        cases.append((f"bigram step boundaries {len(found)}x2x{rb}", np.stack(found)))
    return cases


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
    strategies = list(FilterStrategy)
    errs = {"filter_bank": 0, "filter_rows": 0}
    y, x = np.mgrid[0:16, 0:300]
    ramp = np.broadcast_to(((y + x) % 256).astype(np.uint8), (2, 16, 300))  # tied scores
    for bpp in range(1, 9):
        cases = filter_edge_cases(rng, bpp) + bigram_edge_cases(rng, bpp) + [
            ("noise 4x33x1001", rng.integers(0, 256, (4, 33, 1001), dtype=np.uint8)),
            ("low noise 2x40x1001", rng.integers(0, 12, (2, 40, 1001), dtype=np.uint8)),
            ("ramp 2x16x300", np.ascontiguousarray(ramp)),
            ("one row 2x1x77", rng.integers(0, 256, (2, 1, 77), dtype=np.uint8)),
            (f"RB<=bpp 2x3x{max(bpp // 2, 1)}",
             rng.integers(0, 256, (2, 3, max(bpp // 2, 1)), dtype=np.uint8)),
        ]
        if bpp in (3, 8):
            cases.append(("long rows 1x3x262140",
                          rng.integers(0, 256, (1, 3, 262140), dtype=np.uint8)))
        if bpp == 3:
            cases.append((f"corpus {corpus.shape[0]}x{SIZE}x{SIZE * 3}",
                          corpus.reshape(corpus.shape[0], SIZE, SIZE * 3)))
        for label, host in cases:
            # at an odd byte offset of its buffer: the kernels take rows at any
            flat = torch.empty(host.size + 1, dtype=torch.uint8, device=dev)
            rows = flat[1:].view(host.shape).copy_(torch.from_numpy(host))
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


MAX_PNG_IMAGES = 12  # PNG cell (e): the first 12 images of (a) at the max preset


def png_max_case(corpus):
    """PNG cell (e), the max preset: (label, options, images)."""
    from pixo_tpu_torch import ColorType, PngOptions

    return ("corpus RGB max", PngOptions.max(SIZE, SIZE).replace(color_type=ColorType.RGB),
            corpus[:MAX_PNG_IMAGES])


@contextlib.contextmanager
def filter_modes_recorded():
    """Yields a list that receives the mode (``native_mode``) of each
    ``filter_rows`` call the PNG batch encode makes while it is open."""
    from pixo_tpu_torch.ops import png_filters
    from pixo_tpu_torch.parallel import pipeline

    modes, real = [], pipeline.filter_rows

    def recorded(rows, **kw):
        modes.append(png_filters.native_mode(png_filters.resolve_strategy(kw["strategy"],
                                                                          kw["small_image"])))
        return real(rows, **kw)

    pipeline.filter_rows = recorded
    try:
        yield modes
    finally:
        pipeline.filter_rows = real


def check_png_max_path(dev, corpus) -> dict:
    """Phase 3, PNG (e): the max preset's batch, byte-equal to the per-image
    ``png.encode`` and decoded back, with its ``filter_rows`` launches, all
    in mode 7 (Bigrams). Returns the launch counts."""
    from pixo_tpu_torch.ops import kernels

    label, opts, imgs = png_max_case(corpus)
    reset_counts()
    with filter_modes_recorded() as modes:
        _check_png_bytes(dev, f"(e) {label}", imgs, opts, roundtrip=True)
    launches = {"filter_rows": kernels.filter_rows.launches}
    _verdict(f"main path png (e): launches {launches}, filter modes {modes}",
             launches["filter_rows"] >= 1 and modes == [7] * launches["filter_rows"])
    return launches


def _decoded(data: bytes):
    from pixo_tpu_torch.decode import decode_png as port_decode

    return port_decode(data, keep_bit_depth=True).pixels


def check_png_options(dev, corpus) -> None:
    """Phase 3, PNG, correctness only: interlaced batches (gray, RGB and
    RGBA; reductions to 1-, 2- and 4-bit gray and to palettes; one
    quantized), 16-bit batches (RGB and RGBA, uint16 little- and big-endian),
    ``encode_png_row_sharded`` at the max and balanced presets and
    ``png.encode_batch`` with its default device: every file equal to the
    per-image ``png.encode``; the interlaced and 16-bit files also decoded
    by the port's decoder to the pixels of the same image's non-interlaced
    file (16-bit: the input's values)."""
    import numpy as np

    from pixo_tpu_torch import ColorType, PngOptions, QuantizationMode, QuantizationOptions
    from pixo_tpu_torch import encode_png_batch_sharded, encode_png_row_sharded, png
    from pixo_tpu_torch.ops import kernels

    rng = np.random.default_rng(17)
    h, w = 45, 61
    gray = lambda top: np.repeat(rng.integers(0, top + 1, (3, h, w, 1)).astype(np.uint8), 3, -1)  # noqa: E731
    palette = rng.integers(0, 256, (12, 4), dtype=np.uint8)
    palette[:, 3] = 255
    # (colour type, images, the bit depth of the balanced and max files;
    # the gray images with palettes off, so that they reduce to gray)
    interlaced = {
        "gray noise": (ColorType.GRAY, rng.integers(0, 256, (3, h, w, 1), dtype=np.uint8), 8),
        "RGB photo crops": (ColorType.RGB, np.ascontiguousarray(corpus[:3, :h, :w]), 8),
        "RGBA noise": (ColorType.RGBA, rng.integers(0, 256, (3, h, w, 4), dtype=np.uint8), 8),
        "RGB of gray 0-1 (1-bit gray)": (ColorType.RGB, gray(1), 1),
        "RGB of gray 0-3 (2-bit gray)": (ColorType.RGB, gray(3), 2),
        "RGB of gray 0-15 (4-bit gray)": (ColorType.RGB, gray(15), 4),
        "RGBA of 12 colours (4-bit palette)": (ColorType.RGBA, palette[rng.integers(0, 12, (3, h, w))], 4),
    }
    for label, (ct, imgs, depth) in interlaced.items():
        for preset in ("balanced", "max"):
            opts = getattr(PngOptions, preset)(w, h).replace(color_type=ct, interlace=True,
                                                             reduce_palette="gray" not in label)
            outs = encode_png_batch_sharded(imgs, opts, device=dev)
            same = sum(o == png.encode(img, opts) for o, img in zip(outs, imgs))
            back = sum(np.array_equal(_decoded(o), _decoded(png.encode(img, opts.replace(interlace=False))))
                       for o, img in zip(outs, imgs))
            depths = sorted({o[24] for o in outs})
            _verdict(f"png interlaced {label} {preset}: {same}/{len(imgs)} files byte-equal to the "
                     f"per-image png.encode, {back}/{len(imgs)} decode as the non-interlaced file, "
                     f"bit depth {depths}", same == back == len(imgs) and depths == [depth])
    opts = PngOptions.balanced(w, h).replace(color_type=ColorType.RGB, interlace=True, quantization=(
        QuantizationOptions(mode=QuantizationMode.FORCE, max_colors=64, dithering=True)))
    imgs = np.ascontiguousarray(corpus[:3, :h, :w])
    outs = encode_png_batch_sharded(imgs, opts, device=dev)
    same = sum(o == png.encode(img, opts) for o, img in zip(outs, imgs))
    shapes = sum(_decoded(o).shape == (h, w, 3) for o in outs)
    _verdict(f"png interlaced quantized FORCE 64: {same}/{len(imgs)} files byte-equal to the per-image "
             f"png.encode, {shapes}/{len(imgs)} decode to {h}x{w}x3", same == shapes == len(imgs))

    for ct, c in ((ColorType.RGB, 3), (ColorType.RGBA, 4)):
        big = rng.integers(0, 65536, (3, h, w, c)).astype(">u2")
        for preset in ("fast", "max"):
            opts = getattr(PngOptions, preset)(w, h).replace(color_type=ct, bit_depth=16)
            outs = encode_png_batch_sharded(big, opts, device=dev)
            little = encode_png_batch_sharded(big.astype("<u2"), opts, device=dev)
            same = sum(o == png.encode(img, opts) for o, img in zip(outs, big))
            back = sum(np.array_equal(_decoded(o), img) for o, img in zip(outs, big))
            _verdict(f"png 16-bit {ct.name} {preset}: {same}/{len(big)} files byte-equal to the per-image "
                     f"png.encode, little-endian input {'the same' if little == outs else 'DIFFERENT'}, "
                     f"{back}/{len(big)} decode to their input", same == back == len(big) and little == outs)

    for preset in ("max", "balanced"):
        opts = getattr(PngOptions, preset)(SIZE, SIZE).replace(color_type=ColorType.RGB)
        kernels.filter_rows.launches = 0
        outs = [encode_png_row_sharded(img, opts, device=dev) for img in corpus[:4]]
        same = sum(o == png.encode(img, opts) for o, img in zip(outs, corpus))
        _verdict(f"png row-sharded {preset} 4x{SIZE}x{SIZE}: {same}/4 files byte-equal to png.encode, "
                 f"filter_rows launches {kernels.filter_rows.launches}",
                 same == 4 and kernels.filter_rows.launches >= 1)

    label, opts, imgs = png_max_case(corpus)
    outs = png.encode_batch(imgs[:4], opts)
    same = sum(o == png.encode(img, opts) for o, img in zip(outs, imgs))
    _verdict(f"png.encode_batch (default device) {label} 4x{SIZE}x{SIZE}: {same}/4 files byte-equal to "
             f"png.encode", same == 4)


def filter_rows_alone(raw, kw):
    """The launch alone of ``filter_rows`` on ``raw`` with the keyword
    arguments ``kw``: the C function with its output made beforehand."""
    import torch

    from pixo_tpu_torch.ops import kernels, png_filters

    strat = png_filters.resolve_strategy(kw["strategy"], kw["small_image"])
    mode = png_filters.native_mode(strat)
    sticky = int(kw["sticky_fast"] and mode == png_filters.MODE_ADAPTIVE_FAST)
    b, h, rb = raw.shape
    out = torch.empty((b, h, rb + 1), dtype=torch.uint8, device=raw.device)
    lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
    # a checkout from before the strip kernel has no plan and no such
    # argument; one from before mode 7 has no ``bigrams`` argument
    plan_args = (h, rb, bool(sticky)) + ((True,) if mode == 7 else ())
    plan = [kernels.filter_rows_plan(*plan_args)] if hasattr(kernels, "filter_rows_plan") else []
    args = (raw.data_ptr(), b, h, rb, kw["bpp"], mode, png_filters.early_stop(mode, rb), sticky,
            *plan, out.data_ptr(), stream)
    return lambda: lib.pixo_filter_rows(*args)


def png_group(dev, opts, imgs):
    """Batch ``imgs`` as the PNG path hands it to the filter kernel: (the
    pixels on the card, the one group's raw rows [B, H, RB], its colour
    type, the filter's keyword arguments)."""
    import torch

    from pixo_tpu_torch.parallel.pipeline import _png_route_batch, png_filter_kwargs, png_group_rows

    px = torch.from_numpy(imgs).to(dev).reshape(imgs.shape[0], -1, 3)
    (((mode, ct), gidx),) = _png_route_batch(px, opts)[0].items()  # one group: pass RGB
    return px, png_group_rows(px, gidx, mode, ct, opts), ct, png_filter_kwargs(ct, opts)


def png_device_stage(px, opts, filter_fn):
    """The PNG path's device stage on pixels ``px``: routing, each group's
    rows and ``filter_fn`` on them."""
    from pixo_tpu_torch.parallel.pipeline import _png_route_batch, png_filter_kwargs, png_group_rows

    groups, _ = _png_route_batch(px, opts)
    return [filter_fn(png_group_rows(px, g, m, c, opts), **png_filter_kwargs(c, opts))
            for (m, c), g in groups.items()]


def time_png(dev, corpus, grad, card: str) -> dict:
    """Phase 4, PNG: the filter kernels against their plain versions, then
    the stages of batches (a) and (b). Returns the kernels' times
    (``time_kernel``) at batch (a)'s shape and strategy."""
    import torch

    from pixo_tpu_torch import encode_png_batch_sharded
    from pixo_tpu_torch.ops import kernels, png_filters
    from pixo_tpu_torch.parallel.pipeline import _to_device, png_frame

    k_ms = {}
    for key, (label, opts, imgs) in png_cases(corpus, grad).items():
        b = imgs.shape[0]
        at = f"({key}) {label} {b}x{SIZE}x{SIZE}"
        mp = b * SIZE * SIZE / 1e6
        px, raw, ct, kw = png_group(dev, opts, imgs)
        shape_kw = dict(zip(("b", "h", "rb"), raw.shape))
        times = {"filter_rows": time_kernel(
            "filter_rows", f"{at} {opts.filter_strategy.name}", lambda: kernels.filter_rows(raw, **kw),
            lambda: png_filters.filter_rows_plain(raw, **kw), filter_rows_alone(raw, kw), card,
            **shape_kw)}
        if key == "a":
            cands = torch.empty((raw.shape[0], 5, *raw.shape[1:]), dtype=torch.uint8, device=dev)
            scores = torch.empty((*raw.shape[:2], 5), dtype=torch.int32, device=dev)
            lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
            times["filter_bank"] = time_kernel(
                "filter_bank", at, lambda: kernels.filter_bank(raw, 3),
                lambda: kernels.filter_bank_plain(raw, 3),
                lambda: lib.pixo_filter_bank(raw.data_ptr(), *raw.shape, 3,
                                             kernels.filter_rows_plan(*raw.shape[1:], False),
                                             cands.data_ptr(), scores.data_ptr(), stream),
                card, **shape_kw)
            k_ms = times

        filtered_dev = kernels.filter_rows(raw, **kw)
        filtered = filtered_dev.cpu().numpy()

        def deflate():
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(lambda f: png_frame(f, ct, opts), filtered))

        stages = {
            "png_h2d": wall_ms(lambda: _to_device(imgs, dev)),
            "png_device": wall_ms(lambda: png_device_stage(px, opts, kernels.filter_rows)),
            "png_device_plain": wall_ms(
                lambda: png_device_stage(px, opts, png_filters.filter_rows_plain)),
            "png_d2h": wall_ms(lambda: filtered_dev.cpu()),
            "png_deflate": wall_ms(deflate),
            "png_end_to_end": wall_ms(lambda: encode_png_batch_sharded(imgs, opts, device=dev)),
        }
        for name, ms in stages.items():
            print(f"stage {name} {at}: median {ms:.4f} ms, {mp / (ms / 1e3):.1f} MP/s over "
                  f"{WARM_RUNS} warm runs [{card}]")
    return k_ms


MAX_PNG_RUNS = 3  # a max-preset call takes seconds: its optimal DEFLATE


def time_png_max(dev, corpus, card: str) -> dict:
    """Phase 4, PNG (e): ``filter_rows`` in mode 7 at the cell's device group
    (``time_kernel``), then the cell's stages (median, least and most of
    ``MAX_PNG_RUNS`` warm runs): the device stage (routing, layout and the
    filter kernel), the optimal DEFLATE and framing on 8 threads, the whole
    call, and beside it the per-image host ``png.encode`` on 8 threads; the
    DEFLATE and the whole call also under ``PIXO_TPU_LZ77=device``
    (``png_max_deflate_lz77_device``, ``png_max_end_to_end_lz77_device``),
    and that route's time image by image (``lz77_split``). Returns the
    kernel's times."""
    import torch

    from pixo_tpu_torch import encode_png_batch_sharded, png
    from pixo_tpu_torch.ops import kernels, png_filters
    from pixo_tpu_torch.parallel.pipeline import _png_route_batch, png_filter_kwargs, png_frame, png_group_rows

    label, opts, imgs = png_max_case(corpus)
    b = imgs.shape[0]
    px = torch.from_numpy(imgs).to(dev).reshape(b, -1, 3)
    groups, fallback = _png_route_batch(px, opts)
    (((mode, ct), gidx),) = groups.items()  # one group: pass RGB
    raw = png_group_rows(px, gidx, mode, ct, opts)
    kw = png_filter_kwargs(ct, opts)
    at = f"(e) {label} {b}x{SIZE}x{SIZE}, device group {'x'.join(map(str, raw.shape))}"
    t = time_kernel("filter_rows", f"{at} BIGRAMS", lambda: kernels.filter_rows(raw, **kw),
                    lambda: png_filters.filter_rows_plain(raw, **kw), filter_rows_alone(raw, kw), card,
                    plain_calls=(3, 3, 1), **dict(zip(("b", "h", "rb"), raw.shape)), bigrams=True)
    filtered = kernels.filter_rows(raw, **kw).cpu().numpy()

    with env_var("PIXO_TPU_LZ77", None):
        stages = {
            "png_max_device": wall_stats(lambda: png_device_stage(px, opts, kernels.filter_rows),
                                         MAX_PNG_RUNS),
            "png_max_deflate": wall_stats(lambda: _pool(lambda f: png_frame(f, ct, opts), filtered),
                                          MAX_PNG_RUNS),
        }
    with env_var("PIXO_TPU_LZ77", "device"):
        stages["png_max_deflate_lz77_device"] = wall_stats(
            lambda: _pool(lambda f: png_frame(f, ct, opts, dev), filtered), MAX_PNG_RUNS)
    with env_var("PIXO_TPU_LZ77", None):
        stages["png_max_end_to_end"] = wall_stats(lambda: encode_png_batch_sharded(imgs, opts, device=dev),
                                                  MAX_PNG_RUNS)
    with env_var("PIXO_TPU_LZ77", "device"):
        stages["png_max_end_to_end_lz77_device"] = wall_stats(
            lambda: encode_png_batch_sharded(imgs, opts, device=dev), MAX_PNG_RUNS)
    with env_var("PIXO_TPU_LZ77", None):
        stages["png_max_host_8_threads"] = wall_stats(lambda: _pool(lambda img: png.encode(img, opts), imgs),
                                                      MAX_PNG_RUNS)
    mp = b * SIZE * SIZE / 1e6
    print(f"png (e): {len(gidx)} images in the device group, {len(fallback)} per-image on the host")
    for name, (med, lo, hi) in stages.items():
        print(f"stage {name} {at}: median {med:.4f} ms ({lo:.4f} to {hi:.4f}), "
              f"{mp / (med / 1e3):.1f} MP/s over {MAX_PNG_RUNS} warm runs [{card}]")
    lz77_split(dev, filtered, card)
    return t


LZ77_SORT_TILE = 4096  # csrc/lz77.cu's kSortTile: positions a tile of the chain sort
LZ77_ROW_TILE = 512  # its kRowTile: sorted indices a CTA of the rows' kernel
LZ77_KERNELS = ("hash4_kernel", "digit_hist_kernel", "bin_scan_kernel", "digit_scatter_kernel",
                "chain_rows_kernel")  # the launches of one chain_candidates call (the counting passes twice)
ADLER_KERNELS = ("adler32_kernel",)
# around the plain version's 2048-byte chunks and zlib's NMAX, and the
# kernel's shares: one of 4096 bytes (a chunk a thread), two, the second
# with a ragged end of 15 bytes
ADLER_SIZES = (0, 1, 15, 16, 17, 2047, 2048, 2049, 4095, 4096, 4097, 5552, 5553, 8207, 1 << 24)
ADLER_STARTS = (1, 0x12345678)


def adler_boundary_sizes(slots: int) -> tuple:
    """Sizes where ``adler32_plan`` on ``slots`` CTA slots turns from shares
    of ``ADLER_MIN_SHARE`` to a grid of ``slots``: n = slots * 4096 and a
    byte either side, and that grid's shares at 16 MiB plus 17 bytes."""
    from pixo_tpu_torch.compress.checksums import ADLER_MIN_SHARE

    edge = slots * ADLER_MIN_SHARE
    return edge - 1, edge, edge + 1, (1 << 24) + 17


def _chain_keys(data):
    """The chain sort's keys of ``data``, the 16-bit hash of each of its
    first n - 3 positions, in numpy."""
    import numpy as np

    d = data.astype(np.uint64)
    v = d[:-3] | d[1:-2] << 8 | d[2:-1] << 16 | d[3:] << 24
    return ((v * 2654435761) & 0xFFFFFFFF) >> 16


def lz77_edge_cases(rng) -> dict:
    """Inputs at the edges of ``chain_candidates``' tiling, each at most
    8,000 bytes (label -> [N] uint8): runs of one byte of 1 to 299 bytes
    (lengths that two runs decide, or not); a 700-position bucket among noise (a
    run of equal hashes across the rows' tiles of ``LZ77_ROW_TILE`` sorted
    indices); buckets of exactly 1, 2, 4, 5, 16 and 17 positions (k and k +
    1 at k = 1, 4 and 16) among noise; a zero run to the stream's end and
    one that ends 100 bytes before it (lengths within 258 bytes of the end);
    and values 0-3 with n - 3 = 3 rows' tiles of sorted indices and a byte
    either side. The noise is drawn again until no noise position shares a
    planted bucket's hash."""
    import numpy as np

    def planted(reps, n):
        pats = [np.array([0xA0 + c, 0x5B, 0xC3 - c, 0x1D], np.uint8) for c in range(len(reps))]
        while True:
            d = rng.integers(0, 256, n, dtype=np.uint8)
            at = 0
            for pat, r in zip(pats, reps):
                for _ in range(r):
                    d[at:at + 4] = pat
                    at += 9
            keys = _chain_keys(d)
            if [int((keys == _chain_keys(p)[0]).sum()) for p in pats] == list(reps):
                return d

    noise = rng.integers(0, 256, 3000, dtype=np.uint8)
    runs = np.repeat(rng.integers(0, 4, 600, dtype=np.uint8), rng.integers(1, 300, 600))[:6000]
    cases = {
        "runs of 1 to 299 bytes of values 0-3": runs,
        "a 700-position bucket among noise": planted((700,), 7000),
        "buckets of 1, 2, 4, 5, 16 and 17 positions": planted((1, 2, 4, 5, 16, 17), 2000),
        "noise, then zeros to the end": np.concatenate([noise, np.zeros(1000, np.uint8)]),
        "noise, zeros, 100 bytes of noise": np.concatenate(
            [noise, np.zeros(1000, np.uint8), rng.integers(0, 256, 100, dtype=np.uint8)]),
    }
    for dn in (-1, 0, 1):
        n = 3 * LZ77_ROW_TILE + 3 + dn
        cases[f"n = {n}, values 0-3"] = rng.integers(0, 4, n, dtype=np.uint8)
    return cases


def lz77_cases(rng) -> dict:
    """The LZ77 kernels' inputs beside (e)'s streams, (label -> [N] uint8):
    1 MiB of zeros (one bucket, every length 258), 1 MiB of noise, 16 MiB of
    values 0-3 (256 buckets of 65,536 positions), three tiles of the chain
    sort and 20 bytes of values 0-3, n - 3 = two sort tiles and a byte
    either side, a 37-byte period, ``lz77_edge_cases``, and n = 0 to 5 of
    zeros and of a ramp."""
    import numpy as np

    cases = {
        "1 MiB of zeros": np.zeros(1 << 20, np.uint8),
        "1 MiB of noise": rng.integers(0, 256, 1 << 20, dtype=np.uint8),
        "16 MiB of values 0-3": rng.integers(0, 4, 1 << 24, dtype=np.uint8),
        "3 sort tiles and 20 bytes of values 0-3": rng.integers(0, 4, 3 * LZ77_SORT_TILE + 20, dtype=np.uint8),
        "37-byte period": np.tile(rng.integers(0, 256, 37, dtype=np.uint8), 300),
    }
    for dn in (-1, 0, 1):
        n = 2 * LZ77_SORT_TILE + 3 + dn
        cases[f"n = {n}, values 0-3"] = rng.integers(0, 4, n, dtype=np.uint8)
    cases.update(lz77_edge_cases(rng))
    for n in range(6):
        cases[f"n = {n}, zeros"] = np.zeros(n, np.uint8)
        cases[f"n = {n}, ramp"] = np.arange(n, dtype=np.uint8)
    return cases


def match_pairs(rng, n: int, m: int):
    """``m`` (position, candidate) int32 pairs for ``batched_match_lengths``
    on ``n`` bytes: anywhere from -3 to past the end (pos >= n, negative
    indices), and the first ones with cand > pos near the end."""
    import numpy as np

    pos = rng.integers(-3, n + 8, m)
    cand = rng.integers(-5, n + 10, m)
    tail = np.arange(max(n - 12, 0), n)[:m]
    pos[: len(tail)], cand[: len(tail)] = tail - 3, tail
    return pos.astype(np.int32), cand.astype(np.int32)


@contextlib.contextmanager
def env_var(name: str, value):
    """Environment variable ``name`` set to ``value`` (unset for None) while open."""
    before = os.environ.pop(name, None)
    if value is not None:
        os.environ[name] = value
    try:
        yield
    finally:
        os.environ.pop(name, None)
        if before is not None:
            os.environ[name] = before


def png_max_streams(dev, corpus):
    """(e)'s filtered streams: the device group's rows through
    ``filter_rows`` in mode 7, [8, 512, 1537] uint8 on the host."""
    from pixo_tpu_torch.ops import kernels

    _, opts, imgs = png_max_case(corpus)
    _, raw, _, kw = png_group(dev, opts, imgs)
    return kernels.filter_rows(raw, **kw).cpu().numpy()


def _max_abs(got, ref) -> int:
    return 0 if got.numel() == 0 else int((got.long() - ref.long()).abs().max())


def check_lz77_kernels(dev, streams) -> dict:
    """Phase 2, the device LZ77 route's kernels against their plain versions
    on the card, on (e)'s streams and ``lz77_cases``: ``hash4``,
    ``chain_candidates`` at k = 1, 4 and 16, ``batched_match_lengths`` at
    max_len 3 and 258 on 100,000 ``match_pairs``; then ``adler32_device``
    against its plain version and ``zlib.adler32`` at ``ADLER_SIZES`` and
    the card's ``adler_boundary_sizes`` from ``ADLER_STARTS``. Returns the
    largest difference of each kernel."""
    import zlib

    import numpy as np
    import torch

    from pixo_tpu_torch.compress.checksums import _adler_slots, adler32_device, adler32_plain
    from pixo_tpu_torch.compress.deflate import LZ77_ASSIST_STEPS
    from pixo_tpu_torch.ops import lz77_assist as lz

    rng = np.random.default_rng(29)
    inputs = {f"(e) stream {i}": np.ascontiguousarray(f).reshape(-1) for i, f in enumerate(streams)}
    inputs.update(lz77_cases(rng))
    err = 0
    for label, data in inputs.items():
        t = torch.from_numpy(data.copy()).to(dev)
        hashes = _max_abs(lz.hash4(t), lz.hash4_plain(t))
        chains = []
        for k in (1, 4, LZ77_ASSIST_STEPS):
            (cand, lens), (ref_cand, ref_lens) = lz.chain_candidates(t, k=k), lz.chain_candidates_plain(t, k)
            chains.append(max(_max_abs(cand, ref_cand), _max_abs(lens, ref_lens)))
            found = int((cand >= 0).sum())
            del cand, lens, ref_cand, ref_lens
        pos, cand = (torch.from_numpy(a).to(dev) for a in match_pairs(rng, len(data), 100_000))
        lengths = max(_max_abs(lz.batched_match_lengths(t, pos, cand, max_len=ml),
                               lz.batched_match_lengths_plain(t, pos, cand, ml)) for ml in (3, 258))
        torch.cuda.synchronize()
        err = max(err, hashes, lengths, *chains)
        _verdict(f"lz77 {label} ({len(data)} B): largest difference to the plain version: hash4 {hashes}, "
                 f"chain_candidates k=1 {chains[0]}, k=4 {chains[1]}, k={LZ77_ASSIST_STEPS} {chains[2]} "
                 f"({found} candidates), batched_match_lengths at max_len 3 and 258 {lengths}",
                 hashes == lengths == max(chains) == 0)
        del t
        torch.cuda.empty_cache()
    adler_err = 0
    for n in ADLER_SIZES + adler_boundary_sizes(_adler_slots(dev)):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        data[::3] = 255  # the largest weighted sums, on a third of the bytes
        t = torch.from_numpy(data).to(dev)
        for start in ADLER_STARTS:
            got, plain, ref = adler32_device(t, start), adler32_plain(t, start), zlib.adler32(data.tobytes(), start)
            adler_err = max(adler_err, abs(got - plain), abs(got - ref))
            _verdict(f"adler32 {n} B from {start:#x}: kernel {got:#010x}, plain {plain:#010x}, "
                     f"zlib {ref:#010x}", got == plain == ref)
    return {"chain_candidates": err, "adler32": adler_err}


def _pool(fn, items, workers: int = 8):
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, items))


def check_lz77_route(dev, corpus, streams) -> int:
    """Phase 3, the route: under ``PIXO_TPU_LZ77=device`` each of (e)'s
    streams' ``deflate_optimal_zlib`` on the card equals its bytes with the
    variable unset and inflates back; then the (e) call end to end under the
    variable, each file equal to its host reference (``png.encode`` with the
    variable unset). Returns the launches of ``chain_candidates`` and
    ``adler32_device`` in that call (the latter on no path, as in the JAX
    package)."""
    import zlib

    from pixo_tpu_torch import encode_png_batch_sharded, png
    from pixo_tpu_torch.compress import checksums, deflate_optimal_zlib
    from pixo_tpu_torch.ops import lz77_assist as lz

    with env_var("PIXO_TPU_LZ77", None):
        host = _pool(lambda f: deflate_optimal_zlib(f, 5), streams)
    with env_var("PIXO_TPU_LZ77", "device"):
        card = _pool(lambda f: deflate_optimal_zlib(f, 5, device=dev), streams)
    same = sum(a == b for a, b in zip(card, host))
    back = sum(zlib.decompress(c) == f.tobytes() for c, f in zip(card, streams))
    _verdict(f"lz77 route: {same}/{len(streams)} of (e)'s streams' deflate_optimal_zlib under "
             f"PIXO_TPU_LZ77=device byte-equal to the host route's, {back}/{len(streams)} inflate back",
             same == back == len(streams))
    label, opts, imgs = png_max_case(corpus)
    with env_var("PIXO_TPU_LZ77", None):
        refs = _pool(lambda img: png.encode(img, opts), imgs)
    reset_counts()
    with env_var("PIXO_TPU_LZ77", "device"):
        outs = encode_png_batch_sharded(imgs, opts, device=dev)
    launches = {"chain_candidates": lz.chain_candidates.launches, "adler32": checksums.adler32_device.launches}
    same = sum(o == r for o, r in zip(outs, refs))
    _verdict(f"main path png (e) {label} under PIXO_TPU_LZ77=device: {same}/{len(imgs)} files byte-equal "
             f"to the host route's png.encode, launches {launches}",
             same == len(imgs) and launches["chain_candidates"] == len(imgs))
    return launches


def chain_alone(t, k: int):
    """The launch alone of ``chain_candidates`` on ``t``: the C function with
    its tables and workspace made beforehand."""
    import torch

    from pixo_tpu_torch.ops import kernels

    lib, n = kernels.load(), t.numel()
    cand = torch.empty((n, k), dtype=torch.int32, device=t.device)
    lens = torch.empty_like(cand)
    work = torch.empty(lib.pixo_chain_workspace(n), dtype=torch.int32, device=t.device)
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: lib.pixo_chain_candidates(t.data_ptr(), n, k, work.data_ptr(), cand.data_ptr(),
                                             lens.data_ptr(), stream)


def adler_alone(t):
    """The launch alone of ``adler32_device`` on ``t`` (the ticket's memset
    and the kernel over ``adler32_plan``'s shares; a checkout from before the
    one-launch kernel: its two kernels), with its scratch made beforehand
    and the checksum left on the card."""
    import torch

    from pixo_tpu_torch.compress import checksums
    from pixo_tpu_torch.ops import kernels

    lib, n = kernels.load(), t.numel()
    stream = torch.cuda.current_stream().cuda_stream
    if not hasattr(checksums, "adler32_plan"):
        scratch = torch.empty(lib.pixo_adler32_scratch_words(n), dtype=torch.int32, device=t.device)
        return lambda: lib.pixo_adler32(t.data_ptr(), n, 1, scratch.data_ptr(), stream)
    grid, share = checksums.adler32_plan(n, checksums._adler_slots(t.device))
    scratch = torch.empty(2 * grid + 2, dtype=torch.int32, device=t.device)
    return lambda: lib.pixo_adler32(t.data_ptr(), n, 1, grid, share, scratch.data_ptr(), stream)


def time_lz77(dev, streams, card: str) -> dict:
    """Phase 4, the route's kernels (``time_kernel``): ``chain_candidates``
    at k = 16 at one of (e)'s streams and at 16 MiB of values 0-3, and
    ``adler32`` at 16 MiB. Returns the times at (e), the 16 MiB chain's
    under "16 MiB"."""
    import numpy as np
    import torch

    from pixo_tpu_torch.compress.checksums import adler32_device, adler32_plain
    from pixo_tpu_torch.compress.deflate import LZ77_ASSIST_STEPS
    from pixo_tpu_torch.ops import lz77_assist as lz

    e = torch.from_numpy(np.ascontiguousarray(streams[0]).reshape(-1).copy()).to(dev)
    big = torch.from_numpy(np.random.default_rng(31).integers(0, 4, 1 << 24, dtype=np.uint8)).to(dev)
    k = LZ77_ASSIST_STEPS
    t = {"chain_candidates": time_kernel(
        "chain_candidates", f"(e) stream 0, {e.numel()} B, k={k}", lambda: lz.chain_candidates(e, k=k),
        lambda: lz.chain_candidates_plain(e, k), chain_alone(e, k), card, plain_calls=(2, 3, 1),
        kernel=LZ77_KERNELS, n=e.numel(), k=k)}
    t["chain_candidates"]["16 MiB"] = time_kernel(
        "chain_candidates", f"16 MiB of values 0-3, k={k}", lambda: lz.chain_candidates(big, k=k),
        lambda: lz.chain_candidates_plain(big, k), chain_alone(big, k), card, plain_calls=(1, 1, 1),
        kernel=LZ77_KERNELS, n=big.numel(), k=k)
    torch.cuda.empty_cache()
    t["adler32"] = time_kernel(
        "adler32", "16 MiB of values 0-3", lambda: adler32_device(big), lambda: adler32_plain(big),
        adler_alone(big), card, plain_calls=(2, 3, 1), kernel=ADLER_KERNELS, n=big.numel())
    print(f"lz77 launches a call: chain_candidates {PROFILED[LZ77_KERNELS]} kernels traced in 20 calls "
          f"(8 a call), adler32 {PROFILED[ADLER_KERNELS]} in 20 (1 a call, after a memset) [{card}]")
    for at, t_in in (("(e) stream 0", e), ("16 MiB of values 0-3", big)):
        parts = {name: profiler_ms(lambda: lz.chain_candidates(t_in, k=k), name) for name in LZ77_KERNELS}
        print(f"kernel chain_candidates {at}, by kernel (profiler, ms a call; launches traced in 20 calls): "
              + ", ".join(f"{name} {'not measured' if ms is None else f'{ms:.4f}'} ({PROFILED[name]})"
                          for name, ms in parts.items()) + f" [{card}]")
    return t


def lz77_split(dev, streams, card: str) -> None:
    """Phase 4, (e) under the route, image by image on one thread: the card's
    part as the route takes it (the stream's upload, ``chain_candidates`` at
    k = 16, the tables back, 8 * 16 bytes a byte, both copies through pinned
    memory) and the host's assisted parse, beside the host route's parse of
    the same stream (``native_deflate_optimal``); and the tables' copy back
    to pageable memory (``.cpu()``), as the route first took it."""
    import numpy as np
    import torch

    from pixo_tpu_torch.compress.deflate import LZ77_ASSIST_STEPS
    from pixo_tpu_torch.native import native_deflate_optimal, native_deflate_optimal_assisted
    from pixo_tpu_torch.ops import lz77_assist as lz

    flat = [np.ascontiguousarray(f).reshape(-1) for f in streams]
    # warm: the allocators' device and pinned blocks
    lz.tables_to_host(*lz.chain_candidates(lz.stream_to(flat[0], dev), k=LZ77_ASSIST_STEPS))
    rows = []
    for i, f in enumerate(flat):
        t0 = time.perf_counter()
        t = lz.stream_to(f, dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cand, lens = lz.chain_candidates(t, k=LZ77_ASSIST_STEPS)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        c, ln = lz.tables_to_host(cand, lens)
        t3 = time.perf_counter()
        native_deflate_optimal_assisted(f, 5, True, c, ln)
        t4 = time.perf_counter()
        native_deflate_optimal(f, 5, True)
        t5 = time.perf_counter()
        cand.cpu(), lens.cpu()
        t6 = time.perf_counter()
        rows.append([1e3 * x for x in (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4, t6 - t5)])
        print(f"lz77 split (e) stream {i} ({len(f)} B): upload {rows[-1][0]:.4f} ms, chain_candidates "
              f"{rows[-1][1]:.4f}, tables back ({c.nbytes + ln.nbytes} B) {rows[-1][2]:.4f} (pageable "
              f"{rows[-1][5]:.4f}), assisted host parse {rows[-1][3]:.4f}; host route's parse "
              f"{rows[-1][4]:.4f} [{card}]")
    med = [_median(col) for col in zip(*rows)]
    print(f"lz77 split (e), median of {len(rows)} streams: card's part {med[0] + med[1] + med[2]:.4f} ms "
          f"(upload {med[0]:.4f}, kernel {med[1]:.4f}, tables back {med[2]:.4f}; pageable {med[5]:.4f}), "
          f"assisted host parse {med[3]:.4f}, route total {sum(med[:4]):.4f}; host route's parse "
          f"{med[4]:.4f} [{card}]")


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


def plane_edge_case(rng):
    """(coefficients [333, 64] int16 at the int16 extremes, tables, planes)
    for the decode-tail kernel's edges: blocks before the first plane, a
    first thread block (128 coefficient blocks) that spans three planes, a
    plane of one block, gaps between planes, a plane that crosses into the
    next thread block, a block count that is no multiple of 128, pitches
    wider than their planes and gaps in the output, tables of 255 and
    65535 among random ones."""
    import numpy as np

    zz = rng.choice(np.array(I16_EXTREMES, np.int16), (333, 64))
    planes = np.array([[7, 5, 10, 0, 64],          # 50 blocks, pitch 40 + 24
                       [60, 1, 1, 5120, 8],        # one block, after a gap of 3
                       [61, 3, 7, 5184, 24],
                       [100, 8, 4, 6600, 72],      # blocks 100..131: crosses block 128
                       [140, 9, 21, 8904, 80]],    # 189 blocks, to 328 of 333
                      np.int64)
    qtables = rng.integers(1, 256, (5, 64))
    qtables[1], qtables[3] = 255, 65535
    return zz, qtables, planes


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
        table = kernels.PlaneTable(planes, zz.shape[0], qtables)
        packed = kernels.idct_planes_table(zz, table, kernels.upload_pinned(table.packed, dev))
        err = max(err, int((packed.int() - ref.int()).abs().max()))
        errs["idct_planes"] = max(errs["idct_planes"], err)
        cpu_ok = torch.equal(ref.cpu(), kernels.idct_planes(zz.cpu(), qtables, planes)) if cpu_too else True
        _verdict(f"check idct_planes {label}: {zz.shape[0]} blocks, {len(planes)} planes, "
                 f"max_abs_err vs plain {err}"
                 + (f", plain on the card equal to plain on the CPU {cpu_ok}" if cpu_too else ""),
                 err == 0 and cpu_ok)

    for key in ("d1", "d3"):
        label, files, _ = cases[key]
        batch = jd._host_stage(files, 8, pinned=True)
        held(f"({key}) {label}", batch.to_device(dev)[0], batch.qtables, batch.layout.planes)

    rng = np.random.default_rng(6)
    zz, qtables, planes = plane_edge_case(rng)
    held("edge planes (three in one thread block, one of a single block, gaps, wide pitches)",
         torch.from_numpy(zz).to(dev), qtables, planes, cpu_too=True)
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


def decode_launchers(dev, files):
    """For the decode tail on ``files``: the host batch, its coefficients on
    the card, and ``idct_planes`` three ways: as the decode calls it, the
    launch alone (the C function, its plane table and output already on the
    card) and the plain version. A checkout from before the packed plane
    table is driven as its decode drove it."""
    import torch

    from pixo_tpu_torch.decode import jpeg_decoder as jd
    from pixo_tpu_torch.ops import kernels

    lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
    if hasattr(kernels, "idct_planes_table"):
        batch = jd._host_stage(files, 8, pinned=True)
        zz, desc = batch.to_device(dev)
        table = batch.layout.table
        out = table.output(dev)
        call = lambda: kernels.idct_planes_table(zz, table, desc)  # noqa: E731
        h2d = lambda: batch.to_device(dev)  # noqa: E731
        host = lambda: jd._host_stage(files, 8, pinned=True)  # noqa: E731
    else:
        batch = jd._host_stage(files, 8)
        zz = torch.from_numpy(batch.coeffs).to(dev)
        desc, out = kernels._plane_descriptors(zz, batch.qtables, batch.layout.planes)
        call = lambda: kernels.idct_planes(zz, batch.qtables, batch.layout.planes)  # noqa: E731
        h2d = lambda: torch.from_numpy(batch.coeffs).to(dev)  # noqa: E731
        host = lambda: jd._host_stage(files, 8)  # noqa: E731
    args = (zz.data_ptr(), zz.shape[0], desc.data_ptr(), desc.shape[0], out.data_ptr(), stream)
    return {"batch": batch, "zz": zz, "out_bytes": out.numel(), "call": call, "h2d": h2d,
            "host": host, "alone": lambda: lib.pixo_idct_planes(*args),
            "plain": lambda: kernels.idct_planes_plain(zz, batch.qtables, batch.layout.planes)}


def time_decode(dev, cases, card: str, n_idct: int) -> dict:
    """Phase 4, decode: for (d1) and (d3), the stages of the decode and the
    host library's decode of the same batch on 8 threads; the standalone
    integer IDCT on ``n_idct`` blocks. Returns the times of idct_planes at
    (d1) and of idct8x8_int (``time_kernel``)."""
    import numpy as np
    import torch

    from pixo_tpu_torch.decode import decode_jpeg_batch
    from pixo_tpu_torch.decode import jpeg_decoder as jd
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.jpeg_decode import idct8x8_int as idct_plain

    k_ms = {}
    for key in ("d1", "d3"):
        label, files, _ = cases[key]
        at = f"({key}) {label}"
        run = decode_launchers(dev, files)
        batch, zz = run["batch"], run["zz"]
        mp = sum(s.width * s.height for s in batch.scans) / 1e6
        args = (zz, batch.qtables, batch.layout.planes)
        planes = run["call"]()
        pixels = jd._upsample_colour(planes, batch, False)
        lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
        t = time_kernel(
            "idct_planes", f"{at}, {batch.coeffs.shape[0]} blocks (per call: as the decode calls "
            "it, its plane table packed once a batch and on the card)", run["call"], run["plain"],
            run["alone"], card, n=zz.shape[0], out_bytes=run["out_bytes"])
        print(f"kernel idct_planes {at}: per call with the table as numpy arrays (checked, "
              f"packed and sent up through pinned memory in the call) "
              f"{event_ms(lambda: kernels.idct_planes(*args)):.4f} ms [{card}]")
        if key == "d1":
            k_ms["idct_planes"] = t
            nat = torch.from_numpy(np.random.default_rng(6).integers(
                -1024, 1024, (n_idct, 8, 8)).astype(np.int32)).to(dev)
            px = torch.empty(nat.shape, dtype=torch.uint8, device=dev)
            k_ms["idct8x8_int"] = time_kernel(
                "idct8x8_int", f"{n_idct} blocks", lambda: kernels.idct8x8_int(nat),
                lambda: idct_plain(nat),
                lambda: lib.pixo_idct8x8_int(nat.data_ptr(), px.data_ptr(), n_idct, stream),
                card, library=idct_library(nat), n=n_idct)

        def host_tier(data):  # the reference's CPU tier: fused for baseline files
            return host_decode(data, fused=not jd._parse(data).progressive)

        def host_decode_all():
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(host_tier, files))

        split = host_stage_split(files)
        print(f"decode host stage split {at}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in split.items())
              + f" (medians over {WARM_RUNS} warm runs) [{card}]")
        stages = {
            "decode_host_entropy": wall_ms(run["host"]),
            "decode_host_entropy_1_worker": wall_ms(lambda: jd._host_stage(files, 1)),
            "decode_h2d": wall_ms(run["h2d"]),
            "decode_idct_planes": wall_ms(run["call"]),
            "decode_upsample_colour": wall_ms(lambda: jd._upsample_colour(planes, batch, False)),
            "decode_device": wall_ms(lambda: jd._upsample_colour(run["call"](), batch, False)),
            "decode_device_plain": wall_ms(
                lambda: jd._upsample_colour(kernels.idct_planes_plain(*args), batch, False)),
            "decode_d2h": wall_ms(lambda: pixels.cpu()),
            "decode_end_to_end": wall_ms(lambda: decode_jpeg_batch(files, device=dev)),
            "decode_host_library_8_threads": wall_ms(host_decode_all),
            "decode_host_library_1_thread": wall_ms(lambda: [host_tier(d) for d in files]),
            # the port's own host pixel tier through its entry point (device="cpu")
            "decode_host_tier_8_threads": wall_ms(lambda: decode_jpeg_batch(files, workers=8, device="cpu")),
            "decode_host_tier_1_thread": wall_ms(lambda: decode_jpeg_batch(files, workers=1, device="cpu")),
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


def resize_cases(rng):
    """The resize kernel's shapes, (label, [B, H, W, C] uint8 noise, dst_h,
    dst_w): the thumbnail cell's chunk (64x256x256x3 to 128x128); up- and
    downscales at odd sizes and a 16x16 to 3x5 with 1, 3 and 4 channels; a
    target of one pixel; sources one pixel wide and one pixel high; the same
    size (a pass at scale 1); output rows of two horizontal tiles, the
    second cut short; windows too long for shared memory (16000 -> 64, 1502
    taps: the direct route of ``resize_plan``); one 3220x1812 image to
    128x128 (windows of 153 and 87 taps); batches of 1 and of 64."""
    import numpy as np

    shapes = [("thumbnail chunk", (T1_CHUNK, T1_SIZE, T1_SIZE, 3), THUMB, THUMB)]
    for sh, sw, dh, dw in ((48, 48, 96, 96), (37, 51, 100, 77), (100, 7, 13, 29), (16, 16, 3, 5),
                           (128, 128, 32, 32)):
        shapes += [(f"{c} channels", (2, sh, sw, c), dh, dw) for c in (1, 3, 4)]
    shapes += [("target of one pixel", (3, 9, 14, 3), 1, 1),
               ("source one pixel wide", (2, 30, 1, 4), 8, 5),
               ("source one pixel high", (2, 1, 30, 1), 5, 8),
               ("same size", (1, THUMB, THUMB, 3), THUMB, THUMB),
               ("two channels, batch 64", (64, 20, 31, 2), 9, 13),
               ("columns past one tile", (2, 45, 301, 3), 33, 203),
               ("a window past shared memory", (2, 3, 16000, 3), 2, 64),
               ("one large image", (1, 1812, 3220, 3), THUMB, THUMB)]
    return [(f"{label} {'x'.join(map(str, shape))} -> {dh}x{dw}",
             rng.integers(0, 256, shape, dtype=np.uint8), dh, dw) for label, shape, dh, dw in shapes]


RESIZE_OFFSETS = (1, 3, 15)  # byte offsets of a group in a decoded batch's buffer


def resize_route(host, dh: int, dw: int) -> str:
    """``resize_plan``'s route for a ``resize_cases`` case, in words."""
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.resize_kernels import _taps_on

    b, h, w, c = host.shape
    plan = kernels.resize_plan(b, h, w, c, dh, dw, _taps_on(w, dw, "cpu")[1].shape[1],
                               _taps_on(h, dh, "cpu")[1].shape[1])
    tile = (f"{plan.cols} columns x {4 * plan.quads} rows, span {plan.span}, {plan.smem} B"
            if plan.cols else "no tile")
    return f"horizontal {plan.horizontal} ({tile}), vertical {plan.vertical}"


def check_resize_kernel(dev) -> dict:
    """Phase 2, resize: ``resize_lanczos3`` against its plain version on
    ``dev`` bit for bit, and against the host library's Lanczos3 image by
    image, on ``resize_cases``; each case also from byte offsets 1, 3 and 15
    of its buffer, as a geometry group of a decoded batch lies. Prints each
    case's route (``resize_route``). Returns the kernel's largest absolute
    error."""
    import numpy as np
    import torch

    from pixo_tpu_torch.native import native_resize_lanczos3
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.resize_kernels import lanczos_taps

    worst = 0
    for label, host, dh, dw in resize_cases(np.random.default_rng(10)):
        taps = (*lanczos_taps(host.shape[2], dw), *lanczos_taps(host.shape[1], dh))
        imgs = torch.from_numpy(host).to(dev)
        got = kernels.resize_lanczos3(imgs, *taps)
        ref = kernels.resize_lanczos3_plain(imgs, *taps)
        err = int((got.int() - ref.int()).abs().max())
        for off in RESIZE_OFFSETS:
            flat = torch.empty(host.size + off, dtype=torch.uint8, device=dev)
            shifted = flat[off:].view(host.shape).copy_(imgs)
            err = max(err, int((kernels.resize_lanczos3(shifted, *taps).int() - ref.int()).abs().max()))
        worst = max(worst, err)
        got_h = got.cpu().numpy()
        host_bad = sum(not np.array_equal(got_h[i], native_resize_lanczos3(host[i], *taps))
                       for i in range(len(host)))
        _verdict(f"check resize_lanczos3 {label}, taps {taps[1].shape[1]} and {taps[3].shape[1]}, "
                 f"{resize_route(host, dh, dw)}: max_abs_err vs plain {err} (offsets 0, "
                 f"{', '.join(map(str, RESIZE_OFFSETS))}), images differing from the host library "
                 f"{host_bad}/{len(host)}", err == 0 and host_bad == 0)
    return {"resize_lanczos3": worst}


def thumbnail_cases(dev, cases) -> dict:
    """The thumbnail path's calls: key -> (label, files, chunk size). (t1)
    BASELINE.json config 5 as benches/pipeline.py builds it: 1000 JPEGs of
    256x256 (one gradient rolled along x by seeded shifts, encoded by the
    port at q90 4:4:4). (t2) one mixed call in chunks of 5: the four corpus
    PNGs, the 13 files of decode batch (d3) (baseline and progressive, 16x16
    to 3220x1812), a gray JPEG, an RGBA and a gray+alpha PNG, a P6 and a P5
    file and an input that is thumbnail-sized already."""
    import numpy as np

    from pixo_tpu_torch import ColorType, JpegOptions, PngOptions, encode_jpeg_batch_sharded, png
    from pixo_tpu_torch.utils.synthetic import synth_gradient

    base = synth_gradient(T1_SIZE, T1_SIZE, 3)
    shifts = np.random.default_rng(0).integers(0, 64, T1_COUNT)
    imgs = np.stack([np.roll(base, int(s), axis=1) for s in shifts])
    t1 = encode_jpeg_batch_sharded(imgs, JpegOptions.fast(T1_SIZE, T1_SIZE, 90), device=dev)

    here = os.path.dirname(os.path.abspath(__file__))
    rng = np.random.default_rng(12)
    corpus = [_read(os.path.join(here, "tests", "fixtures", f"corpus_{name}_512.png"))
              for name in CORPUS]
    gray = rng.integers(0, 256, (1, 77, 120), dtype=np.uint8)
    gray_jpeg = encode_jpeg_batch_sharded(
        gray, JpegOptions(width=120, height=77, quality=90, color_type=ColorType.GRAY), device=dev)
    rgba = rng.integers(0, 256, (90, 141, 4), dtype=np.uint8)
    gray_alpha = rng.integers(0, 256, (141, 90, 2), dtype=np.uint8)
    pngs = [png.encode(rgba, PngOptions.fast(141, 90).replace(color_type=ColorType.RGBA)),
            png.encode(gray_alpha, PngOptions.fast(90, 141).replace(color_type=ColorType.GRAY_ALPHA))]
    ppm = b"P6\n# made by chip_smoke\n200 150\n255\n" + rng.integers(
        0, 256, (150, 200, 3), dtype=np.uint8).tobytes()
    pgm = b"P5 150 200 255\n" + rng.integers(0, 256, (200, 150), dtype=np.uint8).tobytes()
    small = encode_jpeg_batch_sharded(
        rng.integers(0, 256, (1, THUMB, THUMB, 3), dtype=np.uint8),
        JpegOptions.fast(THUMB, THUMB, 90), device=dev)
    # the first chunk of 5 holds no JPEG, so it launches no decode tail
    t2 = corpus + pngs[:1] + list(cases["d3"][1]) + gray_jpeg + pngs[1:] + [ppm, pgm] + small
    return {
        "t1": (f"{T1_COUNT} JPEGs {T1_SIZE}x{T1_SIZE} q90 4:4:4 -> {THUMB}x{THUMB} q{THUMB_QUALITY}",
               t1, T1_CHUNK),
        "t2": (f"mixed: {len(corpus)} corpus PNGs, {len(cases['d3'][1])} JPEGs of (d3), gray JPEG, "
               f"RGBA and gray+alpha PNGs, P6, P5, a {THUMB}x{THUMB} JPEG -> {THUMB}x{THUMB} "
               f"q{THUMB_QUALITY}", t2, 5),
    }


def host_pixels(data: bytes):
    """One input's [H, W, C] pixels, by other means than the pipeline's:
    ``host_decode`` (the host library) for a JPEG, this script's own zlib
    and numpy reader (``decode_png``) for a PNG, the PNM parser otherwise."""
    from pixo_tpu_torch.cli import _parse_pnm

    if data[:2] == b"\xff\xd8":
        px = host_decode(data)
    elif data[:4] == b"\x89PNG":
        px = decode_png(data)
    else:
        px = _parse_pnm(data)[0]
    return px if px.ndim == 3 else px[..., None]


def host_thumbnails(files, workers: int = 8):
    """The host composition every thumbnail is held to: ``host_pixels``
    (the host library's JPEG decode, this script's PNG reader), ``_to_rgb``,
    the host library's Lanczos3 with ``lanczos_taps``, then its fused JPEG
    encode in the pipeline's marker frame (``_host_reference``). Returns
    (files, the inputs' pixel shapes)."""
    import numpy as np
    import torch

    from pixo_tpu_torch import ColorType, JpegOptions
    from pixo_tpu_torch.native import native_resize_lanczos3
    from pixo_tpu_torch.ops.resize_kernels import lanczos_taps
    from pixo_tpu_torch.parallel.pipeline import _to_rgb

    opts = JpegOptions(width=THUMB, height=THUMB, quality=THUMB_QUALITY, color_type=ColorType.RGB)

    def one(data):
        px = host_pixels(data)
        rgb = _to_rgb(torch.from_numpy(np.array(px))).numpy()  # a copy: PNM pixels are read-only
        thumb = native_resize_lanczos3(rgb, *lanczos_taps(rgb.shape[1], THUMB),
                                       *lanczos_taps(rgb.shape[0], THUMB))
        return _host_reference([thumb], opts)[0], px.shape

    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        outs = list(ex.map(one, files))
    return [o for o, _ in outs], [shape for _, shape in outs]


def check_thumbnail_path(dev, tcases) -> dict:
    """Phase 3, thumbnails: ``thumbnail_pipeline(..., device="cuda")`` on (t1)
    and (t2), every output held byte for byte against ``host_thumbnails``,
    with the launch counts a call: ``coeffs`` and ``compact`` one a chunk
    (``compact`` more where the cap escalates), ``idct_planes`` one a chunk
    that holds a JPEG, ``resize_lanczos3`` at least one a shape group of a
    chunk and at most one an input. The port's decode of every PNG of (t2)
    is also held to this script's own reader, and a corrupt file in a call must raise
    InvalidDecode. Returns the launch counts of run (t1)."""
    import numpy as np

    from pixo_tpu_torch import errors, thumbnail_pipeline
    from pixo_tpu_torch.decode import decode_png as port_decode_png
    from pixo_tpu_torch.ops import kernels

    wrappers = {"resize_lanczos3": kernels.resize_lanczos3, "coeffs": kernels.coeffs,
                "compact": kernels.compact_padded, "idct_planes": kernels.idct_planes}
    first = None
    for key, (label, files, chunk) in tcases.items():
        stats = {}
        reset_counts()
        outs = thumbnail_pipeline(files, thumb_size=THUMB, quality=THUMB_QUALITY, host_workers=8,
                                  chunk_size=chunk, device=dev, stats=stats)
        launches = {name: fn.launches for name, fn in wrappers.items()}
        first = first or launches
        want, shapes = host_thumbnails(files)
        same = sum(a == b for a, b in zip(outs, want))
        chunks = [range(lo, min(lo + chunk, len(files))) for lo in range(0, len(files), chunk)]
        with_jpeg = sum(any(files[i][:2] == b"\xff\xd8" for i in c) for c in chunks)
        groups = sum(len({(files[i][:2] == b"\xff\xd8", shapes[i]) for i in c}) for c in chunks)
        counts_ok = (launches["coeffs"] == len(chunks) and launches["compact"] >= len(chunks)
                     and launches["idct_planes"] == with_jpeg
                     and groups <= launches["resize_lanczos3"] <= len(files))
        _verdict(f"thumbnail path ({key}) {label}, chunks of {chunk}: {same}/{len(files)} thumbnails "
                 f"byte-equal to the host composition, mean {sum(map(len, outs)) / len(outs):.0f} "
                 f"B/thumbnail; {len(chunks)} chunks, {with_jpeg} with a JPEG, {groups} shape groups; "
                 f"launches {launches}; stage seconds "
                 + ", ".join(f"{k} {v:.4f}" for k, v in stats.items()),
                 same == len(files) and counts_ok and set(stats) == {"decode_wait_s", "device_s",
                                                                      "pack_s"})
    _, files, chunk = tcases["t2"]
    pngs = [d for d in files if d[:4] == b"\x89PNG"]
    same = sum(np.array_equal(port_decode_png(d).pixels, decode_png(d)) for d in pngs)
    _verdict(f"decode_png on the PNGs of (t2) (corpus, RGBA, gray+alpha): {same}/{len(pngs)} images "
             f"equal to this script's zlib and numpy reader", same == len(pngs))
    for what, bad in (("a truncated JPEG", files[6][: len(files[6]) // 2]),
                      ("a PNG with a flipped byte",
                       files[0][:200] + bytes([files[0][200] ^ 0xFF]) + files[0][201:])):
        try:
            thumbnail_pipeline(files[:7] + [bad] + files[7:9], thumb_size=THUMB, chunk_size=chunk,
                               device=dev)
            raised = "nothing"
        except errors.InvalidDecode as e:
            raised = f"InvalidDecode({e})"
        _verdict(f"thumbnail path with {what} in the call raises {raised}",
                 raised.startswith("InvalidDecode"))
    return first


def thumbnail_chunks(dev, files, chunk: int):
    """The chunks of a thumbnail call as ``thumbnail_pipeline`` forms them:
    for each, what its host decode stage hands to the device stage
    (``_thumb_decode``: the JPEGs' host batch or None, their positions, the
    other inputs' pixels)."""
    from pixo_tpu_torch.cli import load_image
    from pixo_tpu_torch.parallel.pipeline import _thumb_decode

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        loaded = [None if d[:2] == b"\xff\xd8" else ex.submit(load_image, d, device="cpu")
                  for d in files]
        for lo in range(0, len(files), chunk):
            yield _thumb_decode(files[lo:lo + chunk], loaded[lo:lo + chunk], 8, dev)


def check_thumbnail_kernels(dev, tcases) -> dict:
    """Phase 2, thumbnails: the kernels that the thumbnail path shares with
    the encode and the decode, each against its plain version on the very
    tensors this path gives it, chunk by chunk of (t1) and (t2):
    ``idct_planes`` (through ``idct_planes_table``, as ``_device_tail`` calls
    it) on the chunk's JPEG coefficients, ``coeffs`` in mode 444 on the
    chunk's thumbnails, ``compact`` on their coefficients at cap 8 and at the
    cap that ``_fetch_compacted`` escalates to. Returns the largest absolute
    error of each."""
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.sparse_pack import PADDED_CAP_TIERS, sparsify_blocks_padded_batch
    from pixo_tpu_torch.parallel.pipeline import _thumb_resize

    quant = QuantizationTables(THUMB_QUALITY)
    lum, chrom = quant.luminance_table, quant.chrominance_table
    worst = {"idct_planes": 0, "coeffs": 0, "compact": 0}
    for key, (label, files, chunk) in tcases.items():
        errs = {"idct_planes": 0, "coeffs": 0, "compact": 0}
        blocks, chunks, caps = 0, 0, set()
        for batch, jpegs, others in thumbnail_chunks(dev, files, chunk):
            chunks += 1
            if batch is not None:
                zz, desc = batch.to_device(dev)
                got = kernels.idct_planes_table(zz, batch.layout.table, desc)
                ref = kernels.idct_planes_plain(zz, batch.qtables, batch.layout.planes)
                errs["idct_planes"] = max(errs["idct_planes"], int((got.int() - ref.int()).abs().max()))
                blocks += zz.shape[0]
            thumbs = _thumb_resize(batch, jpegs, others, THUMB, dev)
            zz = kernels.coeffs(thumbs, lum, chrom, "444")
            ref = kernels.coeffs_plain(thumbs, lum, chrom, "444")
            errs["coeffs"] = max(errs["coeffs"], int((zz.int() - ref.int()).abs().max()))
            most = int(kernels.compact_padded(zz, 8)[5].max())
            for cap in {8, next((t for t in PADDED_CAP_TIERS if most <= t), 8)}:
                caps.add(cap)
                pairs = zip(kernels.compact_padded(zz, cap), sparsify_blocks_padded_batch(zz, cap))
                errs["compact"] = max([errs["compact"]]
                                      + [int((g.int() - r.int()).abs().max()) for g, r in pairs])
        _verdict(f"check the thumbnail path's shared kernels on ({key}) {label}, {chunks} chunks of "
                 f"{chunk}: idct_planes on {blocks} coefficient blocks, coeffs mode=444 on "
                 f"[<={chunk}, {THUMB}, {THUMB}, 3] thumbnails, compact at caps {sorted(caps)}: "
                 f"max_abs_err vs plain {errs}", not any(errs.values()))
        worst = {k: max(worst[k], v) for k, v in errs.items()}
    return worst


def resize_alone(imgs, dst: int, lib=None, plan=None):
    """The launch alone of ``resize_lanczos3`` on ``imgs`` to ``dst`` square:
    the C function (of ``lib``, by default the checkout's) with its taps,
    plan (``plan``, by default ``resize_plan``'s), scratch and output made
    beforehand. A tree from before ``resize_plan`` launches as its own
    wrapper did."""
    import torch

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.resize_kernels import _taps_on, lanczos_taps

    b, h, w, c = imgs.shape
    sx, wx = _taps_on(w, dst, imgs.device)
    sy, wy = _taps_on(h, dst, imgs.device)
    tmp = torch.empty((b, h, dst, c), dtype=torch.uint8, device=imgs.device)
    out = torch.empty((b, dst, dst, c), dtype=torch.uint8, device=imgs.device)
    lib, stream = lib or kernels.load(), torch.cuda.current_stream().cuda_stream
    args = (imgs.data_ptr(), b, h, w, c, sx.data_ptr(), wx.data_ptr(), wx.shape[1], dst,
            sy.data_ptr(), wy.data_ptr(), wy.shape[1], dst, tmp.data_ptr(), out.data_ptr())
    if hasattr(kernels, "resize_plan"):
        plan = plan or kernels.resize_plan(b, h, w, c, dst, dst, wx.shape[1], wy.shape[1])
        args += (plan.cols, plan.quads, plan.span)
    args += (stream,)
    return (lambda: lib.pixo_resize_lanczos3(*args)), dict(  # the windows' own taps, unpadded
        b=b, h=h, w=w, c=c, dh=dst, dw=dst, ky=lanczos_taps(h, dst)[1].shape[1],
        kx=lanczos_taps(w, dst)[1].shape[1]), out


def resize_passes(call, at: str, card: str, work: dict) -> dict:
    """The profiler's device time of each of the resize's two launches in
    ``call`` (the direct route's horizontal kernel included), each beside
    its own bound (``kernel_bound`` with ``passes``); prints one line."""
    times = {}
    for name in ("horizontal", "vertical"):
        ms = profiler_ms(call, f"resize_lanczos3_{name[0]}_")
        bound, _ = kernel_bound("resize_lanczos3", passes=name, **work)
        times[name] = (ms, bound)
    both = None if None in [ms for ms, _ in times.values()] else sum(ms for ms, _ in times.values())
    print(f"kernel resize_lanczos3 {at}, its two launches on the device: " + ", ".join(
        f"{k} {'not measured' if ms is None else f'{ms:.4f} ms'} (bound {b:.4f} ms)"
        for k, (ms, b) in times.items())
        + ("" if both is None else f", both {both:.4f} ms") + f" [{card}]")
    return times


def two_call_thumbnails(dev, files, chunk: int):
    """The thumbnails of ``files`` through the entry points that existed
    before the thumbnail pipeline, chunk by chunk: ``decode_jpeg_batch`` to
    host pixels, the host library's Lanczos3 on 8 threads,
    ``encode_jpeg_batch_sharded`` of the thumbnails. The pixels cross to the
    host after the decode and back before the encode."""
    import numpy as np

    from pixo_tpu_torch import ColorType, JpegOptions, encode_jpeg_batch_sharded
    from pixo_tpu_torch.decode import decode_jpeg_batch
    from pixo_tpu_torch.native import native_resize_lanczos3
    from pixo_tpu_torch.ops.resize_kernels import lanczos_taps

    opts = JpegOptions(width=THUMB, height=THUMB, quality=THUMB_QUALITY, color_type=ColorType.RGB)

    def shrink(img):
        px = img.pixels
        return native_resize_lanczos3(px, *lanczos_taps(px.shape[1], THUMB),
                                      *lanczos_taps(px.shape[0], THUMB))

    outs = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        for lo in range(0, len(files), chunk):
            images = decode_jpeg_batch(files[lo:lo + chunk], device=dev)
            thumbs = np.stack(list(ex.map(shrink, images)))
            outs += encode_jpeg_batch_sharded(thumbs, opts, device=dev)
    return outs


def time_thumbnail(dev, tcases, card: str) -> dict:
    """Phase 4, thumbnails: ``resize_lanczos3`` at (t1)'s chunk shape
    (``time_kernel``), then for (t1) the stages of one chunk of 64 (host
    decode stage, the decode's device tail, resize, coefficients and
    compaction, the copy of the compacted streams, host pack) and the whole
    call of 1000 files, beside the same files through ``two_call_thumbnails``;
    medians with least and most over ``THUMB_RUNS`` warm runs; and the
    kernels this path shares with the encode and the decode (``coeffs`` in
    mode 444, ``compact`` at cap 8 and at the cap its chunks escalate to,
    ``idct_planes``) at one chunk's shapes, each beside its bound there.
    Returns the resize kernel's times and the shared kernels' (name -> one
    ``time_kernel`` record a shape)."""
    from pixo_tpu_torch import ColorType, JpegOptions, thumbnail_pipeline
    from pixo_tpu_torch.decode import jpeg_decoder as jd
    from pixo_tpu_torch.jpeg import encoder as jenc
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.blockify import scan_layout
    from pixo_tpu_torch.ops.resize_kernels import _taps_on, resize_lanczos3_batch
    from pixo_tpu_torch.ops.sparse_pack import PADDED_CAP_TIERS, sparsify_blocks_padded_batch
    from pixo_tpu_torch.parallel.pipeline import _assemble_jpeg, _fetch_compacted, _pack_hosted

    label, files, chunk = tcases["t1"]
    first = files[:chunk]
    batch = jd._host_stage(first, 8, pinned=True)
    pixels = jd._device_tail(batch, False, dev)
    ((members, shape, offset),) = jd._pixel_groups(batch)  # one geometry group
    imgs = pixels[offset:].view(len(members), *shape)
    alone, work, _ = resize_alone(imgs, THUMB)
    taps = (*_taps_on(shape[1], THUMB, dev), *_taps_on(shape[0], THUMB, dev))
    at = f"(t1) chunk {'x'.join(map(str, imgs.shape))} -> {THUMB}x{THUMB}"
    k_ms = {"resize_lanczos3": time_kernel(
        "resize_lanczos3", f"{at}, windows of {work['kx']} and {work['ky']} taps (its uint8 "
        f"intermediate, {work['b'] * work['h'] * work['dw'] * work['c']} B written and read again, "
        "is not in the bound)", lambda: resize_lanczos3_batch(imgs, dst_w=THUMB, dst_h=THUMB),
        lambda: kernels.resize_lanczos3_plain(imgs, *taps), alone, card, **work)}

    resize_passes(lambda: resize_lanczos3_batch(imgs, dst_w=THUMB, dst_h=THUMB), at, card, work)

    opts = JpegOptions(width=THUMB, height=THUMB, quality=THUMB_QUALITY, color_type=ColorType.RGB)
    quant = QuantizationTables(THUMB_QUALITY)
    _, _, pattern = scan_layout(THUMB, THUMB, "rgb", "444")
    thumbs = resize_lanczos3_batch(imgs, dst_w=THUMB, dst_h=THUMB)

    def coeffs_compact():
        zz = jenc._device_coeffs_batch(thumbs, quant.luminance_table, quant.chrominance_table,
                                       color="rgb", subsampling="444")
        return zz, kernels.compact_padded(zz, 8)

    zz, compacted = coeffs_compact()
    state = _fetch_compacted(zz, compacted)

    # the kernels this path shares with the encode and the decode, at the
    # shapes it gives them: one chunk's thumbnails and JPEG coefficients
    lum, chrom = quant.luminance_table, quant.chrominance_table
    tier = next((t for t in PADDED_CAP_TIERS if int(compacted[5].max()) <= t), 8)
    shared = {"coeffs": [], "compact": [], "idct_planes": []}
    for cap in sorted({8, tier}):
        _, launchers = main_path_launchers(kernels, thumbs, lum, chrom, mode="444", cap=cap)
        if cap == 8:
            shared["coeffs"].append(time_kernel(
                "coeffs", f"(t1) chunk {'x'.join(map(str, thumbs.shape))} q{THUMB_QUALITY} 4:4:4",
                launchers["coeffs"][0], lambda: kernels.coeffs_plain(thumbs, lum, chrom, "444"),
                launchers["coeffs"][1], card, b=chunk, h=THUMB, w=THUMB, c=3, mode="444"))
        shared["compact"].append(time_kernel(
            "compact", f"(t1) chunk {'x'.join(map(str, zz.shape))} cap {cap}"
            + ("" if cap == 8 else " (the cap every chunk escalates to)"), launchers["compact"][0],
            lambda: sparsify_blocks_padded_batch(zz, cap), launchers["compact"][1], card,
            library=compact_library(zz, cap, kernels.compact_padded(zz, cap)), b=chunk, n=zz.shape[1],
            cap=cap))
    run = decode_launchers(dev, first)
    shared["idct_planes"].append(time_kernel(
        "idct_planes", f"(t1) chunk {chunk} JPEGs {T1_SIZE}x{T1_SIZE} 4:4:4, {run['zz'].shape[0]} "
        "blocks", run["call"], run["plain"], run["alone"], card, n=run["zz"].shape[0],
        out_bytes=run["out_bytes"]))
    mp_chunk, mp_all = chunk * T1_SIZE * T1_SIZE / 1e6, len(files) * T1_SIZE * T1_SIZE / 1e6

    def run_pipeline():
        return thumbnail_pipeline(files, thumb_size=THUMB, quality=THUMB_QUALITY, host_workers=8,
                                  chunk_size=chunk, device=dev)

    same = sum(a == b for a, b in zip(two_call_thumbnails(dev, files, chunk), run_pipeline()))
    _verdict(f"thumbnail (t1): {same}/{len(files)} files of the two-call path byte-equal to the "
             f"pipeline's", same == len(files))
    stages = {
        "thumb_decode_host_stage": (lambda: jd._host_stage(first, 8, pinned=True), chunk, mp_chunk),
        "thumb_decode_device_tail": (lambda: jd._device_tail(batch, False, dev), chunk, mp_chunk),
        "thumb_resize": (lambda: resize_lanczos3_batch(imgs, dst_w=THUMB, dst_h=THUMB), chunk,
                         mp_chunk),
        "thumb_coeffs_compact": (coeffs_compact, chunk, mp_chunk),
        "thumb_d2h": (lambda: _fetch_compacted(zz, compacted), chunk, mp_chunk),
        "thumb_host_pack": (lambda: [_assemble_jpeg(s, opts, quant)
                                     for s in _pack_hosted(state, opts, pattern, 8)], chunk, mp_chunk),
        "thumb_end_to_end": (run_pipeline, len(files), mp_all),
        "thumb_two_call_path": (lambda: two_call_thumbnails(dev, files, chunk), len(files), mp_all),
    }
    result = {}
    for name, (fn, count, mp) in stages.items():
        med, least, most = result[name] = wall_stats(fn)
        print(f"stage {name} (t1) {count} images: median {med:.4f} ms (least {least:.4f}, most "
              f"{most:.4f}), {count / (med / 1e3):.1f} images/s, {mp / (med / 1e3):.1f} input MP/s "
              f"over {THUMB_RUNS} warm runs [{card}]")
    stats = {}
    thumbnail_pipeline(files, thumb_size=THUMB, quality=THUMB_QUALITY, host_workers=8,
                       chunk_size=chunk, device=dev, stats=stats)
    print(f"thumbnail (t1) stats of one call: " + ", ".join(f"{k} {v * 1e3:.4f} ms"
                                                             for k, v in stats.items())
          + f"; no pixel crosses to the host between the decode and the compaction [{card}]")
    one, two = result["thumb_end_to_end"][0], result["thumb_two_call_path"][0]
    print(f"thumbnail (t1): the pipeline {one:.4f} ms, the two-call path {two:.4f} ms: "
          f"{'the pipeline' if one < two else 'the two-call path'} is faster by "
          f"{max(one, two) / min(one, two):.2f}x [{card}]")
    return k_ms, shared


# The lossy PNG cells (BASELINE.json config 3, palette quantization and
# dithering at 64 and 256 colours): (q1) the corpus batch, FORCE, 256
# colours, the balanced preset; (q2) the gradient batch, FORCE, 64 colours,
# the fast preset; both dithered.
LOSSY_RUNS = 3


def lossy_options(max_colors: int, dithering: bool, preset: str = "balanced", mode: str = "FORCE",
                  color_type: str = "RGB"):
    """A lossy cell's PngOptions for SIZE x SIZE images."""
    from pixo_tpu_torch import ColorType, PngOptions, QuantizationMode, QuantizationOptions

    opts = getattr(PngOptions, preset)(SIZE, SIZE)
    return opts.replace(color_type=ColorType[color_type], quantization=QuantizationOptions(
        mode=QuantizationMode[mode], max_colors=max_colors, dithering=dithering))


def lossy_cases(corpus, grad) -> dict:
    """The lossy cells (q1) and (q2): (label, options, images)."""
    return {
        "q1": ("corpus RGB balanced FORCE 256 colours dithered", lossy_options(256, True), corpus),
        "q2": ("gradient RGB fast FORCE 64 colours dithered", lossy_options(64, True, "fast"), grad),
    }


def alpha_batch(corpus, size: int = SIZE):
    """[4, size, size, 4]: corpus photos with graded alpha (a ramp over the
    columns, 255 on the right half), so the dither takes the direct redmean
    for about half the pixels and the palettes need tRNS."""
    import numpy as np

    ramp = np.minimum(np.arange(size) * 510 // size, 255).astype(np.uint8)
    alpha = np.broadcast_to(ramp[None, :, None], (size, size, 1))
    return np.stack([np.concatenate([img[:size, :size], alpha], -1) for img in corpus[::4]])


def auto_mix_batch(corpus, size: int = SIZE):
    """[4, size, size, 3] for AUTO at 256 colours, one image of each branch:
    uniform noise (too many colours: declined), a 200-colour image whose
    pixels at multiples of the heuristic's sampling stride but not of the
    histogram's carry 250 more colours (accepted by the heuristic's sample,
    exact-mapped by the histogram's, which sees 40 colours), a corpus photo
    and a corpus photo rolled (quantized on the device)."""
    import numpy as np

    rng = np.random.default_rng(11)
    n = size * size
    auto_stride, hist_stride = max(n // 20_000, 1), max(n // 50_000, 1)
    base = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    extra = rng.integers(0, 256, (250, 3), dtype=np.uint8)
    exact = base[np.arange(n) % 200]
    marked = np.nonzero((np.arange(n) % auto_stride == 0) & (np.arange(n) % hist_stride != 0))[0]
    exact[marked] = extra[np.arange(len(marked)) % 250]
    noise = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    photo = corpus[0][:size, :size]
    return np.stack([noise, exact.reshape(size, size, 3), photo, np.roll(photo, 77, axis=1)])


def lossy_correctness_cases(corpus, grad) -> list:
    """(q3), for correctness only: (label, options, images)."""
    return [
        ("(q1) without dithering", lossy_options(256, False), corpus),
        ("(q2) without dithering", lossy_options(64, False, "fast"), grad),
        ("RGBA graded alpha FORCE 256 dithered", lossy_options(256, True, color_type="RGBA"),
         alpha_batch(corpus)),
        ("RGBA graded alpha FORCE 64 undithered", lossy_options(64, False, color_type="RGBA"),
         alpha_batch(corpus)),
        ("AUTO 256 dithered: declined, exact-mapped and device members",
         lossy_options(256, True, mode="AUTO"), auto_mix_batch(corpus)),
    ]


def quantize_edge_cases(rng) -> dict:
    """The quantization kernels' edge cases, numpy arrays by kernel:
    kmeans_refine (label, palettes [B, K, 4], colours [B, M, 4], weights
    [B, M] int32, k_valid [B] int32 and, in some, counts [B] int32, the
    colours the kernel's schedule takes, ``kmeans_plan``): K = 1, K = 256
    with duplicate entries, k_valid below K, all-zero weights, colours on
    palette entries (ties), a colour count that ends inside a CTA's range,
    one colour, counts below M (one of them 0), counts of 1 to 4000 in one
    batch, weights whose chunks need 64-bit sums beside chunks that do not,
    runs of equal colours (many of a warp's colours on one entry); palette_lut
    (label, palettes, k_valid): K = 1, K = 256 with duplicates (all scanned,
    and only the first 16), entries with alpha, three palettes, k_valid
    below K; dither_fs (label, rgba [B, H, W, 4], palettes, k_valid): H = 1
    (1x7000), W = 1, heights at the kernel's band edges (31, 32, 33, 64, 65
    rows), 1100x40 (35 bands on 2 warps: the last warp's ring feeds warp 0),
    70x4000 (3 warps, capped at the bands), alpha other than 255, K = 1, K =
    256 with duplicates, noise, alpha with k_valid below K."""
    import numpy as np

    def pal(b, k, unique=None, opaque=True):
        p = rng.integers(0, 256, (b, unique or k, 4), dtype=np.uint8)
        if opaque:
            p[..., 3] = 255
        return np.ascontiguousarray(np.tile(p, (1, k // (unique or k), 1))) if unique else p

    def cols(b, m, alpha=False):
        c = rng.integers(0, 256, (b, m, 4), dtype=np.uint8)
        if not alpha:
            c[..., 3] = 255
        return c

    def weights(b, m, zero_every=3):
        w = rng.integers(1, 900, (b, m)).astype(np.int32)
        w[:, ::zero_every] = 0
        return w

    ties = pal(1, 40)
    kmeans = [
        ("K=1", pal(2, 1), cols(2, 1500), weights(2, 1500), np.array([1, 1], np.int32)),
        ("K=256 duplicates", pal(1, 256, unique=64), cols(1, 8192), weights(1, 8192),
         np.array([256], np.int32)),
        ("k_valid < K", pal(3, 256), cols(3, 8192, alpha=True), weights(3, 8192),
         np.array([1, 37, 200], np.int32)),
        ("all-zero weights", pal(2, 64), cols(2, 2048), np.zeros((2, 2048), np.int32),
         np.array([64, 10], np.int32)),
        ("colours on entries", ties, np.ascontiguousarray(np.repeat(ties, 3, axis=1)),
         weights(1, 120, 7), np.array([40], np.int32)),
        ("M=1500 ends mid-CTA", pal(2, 100), cols(2, 1500), weights(2, 1500),
         np.array([100, 99], np.int32)),
        ("one colour", pal(1, 16), cols(1, 1), np.array([[5]], np.int32), np.array([16], np.int32)),
    ]
    def sizes(*k):
        return np.array(k, np.int32)

    dup = pal(1, 256, unique=16)
    luts = [("K=1", pal(1, 1), sizes(1)), ("K=256 duplicates", dup, sizes(256)),
            ("K=256 duplicates, k_valid 16", dup, sizes(16)),
            ("K=37 with alpha", pal(2, 37, opaque=False), sizes(37, 37)),
            ("three K=256", pal(3, 256), sizes(256, 256, 256)),
            ("k_valid < K", pal(3, 256), sizes(1, 64, 200))]
    dithers = []
    for label, shape, k, alpha, k_valid in (
            ("H=1", (1, 1, 7000), 64, False, None), ("W=1", (2, 40, 1), 64, False, None),
            *((f"H={h} band edge", (1, h, 70), 64, False, None) for h in (31, 32, 33, 64, 65)),
            ("bands wrap round the warps", (1, 1100, 40), 32, False, None),
            ("the warp cap binds", (1, 70, 4000), 64, False, None),
            ("alpha != 255", (2, 23, 37), 48, True, None), ("K=1", (1, 16, 16), 1, False, None),
            ("K=256 duplicates", (2, 31, 45), 256, False, None),
            ("noise", (3, 64, 96), 200, False, None),
            ("alpha != 255, k_valid < K", (2, 23, 37), 64, True, (10, 64))):
        rgba = rng.integers(0, 256, (*shape, 4), dtype=np.uint8)
        if alpha:
            rgba[..., 3] = rng.choice(np.array([0, 1, 128, 254, 255, 255], np.uint8), shape)
        else:
            rgba[..., 3] = 255
        dithers.append((f"{label} {'x'.join(map(str, shape))}", rgba,
                        pal(shape[0], k, unique=16 if k == 256 else None, opaque=not alpha),
                        sizes(*(k_valid or [k] * shape[0]))))
    # drawn after the others, so that the cases above keep their data
    few = weights(2, 3000)
    few[0, 1000:] = few[1] = 0
    spread = weights(5, 4000)
    for i, n in enumerate((1, 63, 64, 65, 4000)):
        spread[i, n:] = 0
    heavy = rng.integers(1, 900, (1, 2000)).astype(np.int32)
    heavy[0, 1000:] = rng.integers(1 << 24, (1 << 31) - 1, 1000)
    runs = np.repeat(cols(1, 120), rng.integers(1, 40, 120), axis=1)[:, :2500]
    kmeans += [
        ("counts below M, one 0", pal(2, 64), cols(2, 3000), few, sizes(64, 20), sizes(1000, 0)),
        ("counts of 1 to 4000", pal(5, 256), cols(5, 4000, alpha=True), spread,
         sizes(256, 3, 64, 255, 200), sizes(1, 63, 64, 65, 4000)),
        ("64-bit sums beside 32-bit", pal(1, 32), cols(1, 2000), heavy, sizes(32)),
        ("runs of equal colours", pal(1, 12), np.ascontiguousarray(runs), weights(1, runs.shape[1], 5),
         sizes(12)),
    ]
    return {"kmeans_refine": kmeans, "palette_lut": luts, "dither_fs": dithers}


def at_offset(host, offset: int, dev):
    """``host`` (numpy) on ``dev``, ``offset`` elements into a buffer of
    its own: a uint8 tensor at that byte offset, an int32 one at 4 times it."""
    import numpy as np
    import torch

    src = torch.from_numpy(np.ascontiguousarray(host))
    buf = torch.empty(src.numel() + offset, dtype=src.dtype, device=dev)
    return buf[offset:].view(src.shape).copy_(src)


def real_entries(pal, k_valid) -> list:
    """Each palette of ``pal`` [B, K, 4] cut to its first ``k_valid``
    entries, clamped to 1..K as the kernels clamp them."""
    return [pal[i][:max(1, min(int(k_valid[i]), pal.shape[1]))] for i in range(len(pal))]


def dither_inputs(rgba, pal, k_valid) -> tuple:
    """A dither case's kernel inputs: (rgba, palettes, the host library's LUT
    of each palette's real entries, k_valid)."""
    import numpy as np

    from pixo_tpu_torch.native import native_palette_lut

    return rgba, pal, np.stack([native_palette_lut(p) for p in real_entries(pal, k_valid)]), k_valid


def quantize_host_oracles(name: str, args) -> list:
    """The host library's result of kernel ``name`` on numpy ``args`` (its
    inputs: k_valid last, or before the k-means' counts), image by image, on
    each palette's real entries:
    ``refine_palette_kmeans``, ``native_palette_lut``, ``native_dither_fs``
    with the LUT of ``args``."""
    from pixo_tpu_torch.native import native_dither_fs, native_palette_lut
    from pixo_tpu_torch.png.quantize import refine_palette_kmeans

    if name == "kmeans_refine":
        pal, colors, weights, k_valid = args[:4]
        return [refine_palette_kmeans(p, colors[i], weights[i].astype("uint32"))
                for i, p in enumerate(real_entries(pal, k_valid))]
    if name == "palette_lut":
        return [native_palette_lut(p) for p in real_entries(*args)]
    rgba, pal, lut, k_valid = args
    b, h, w = rgba.shape[:3]
    return [native_dither_fs(rgba[i].reshape(-1, 4), w, h, p, lut[i]).reshape(h, w)
            for i, p in enumerate(real_entries(pal, k_valid))]


def check_quantize_case(dev, name: str, label: str, args, offsets=(0,)) -> int:
    """Kernel ``name`` on numpy ``args`` (its inputs; a dither's LUTs are
    made by the host library here, ``dither_inputs``) at each byte offset
    against its plain version on the card and the host library image by
    image. Returns the largest absolute error against the plain version."""
    import numpy as np

    from pixo_tpu_torch.ops import kernels, quantize_device

    if name == "dither_fs":
        args = dither_inputs(*args)
    host = quantize_host_oracles(name, args)
    ref = getattr(quantize_device, name)(*[at_offset(a, 0, dev) for a in args])
    err = 0
    for off in offsets:
        got = getattr(kernels, name)(*[at_offset(a, off, dev) for a in args])
        e = int((got.int() - ref.int()).abs().max())
        got_h = got.cpu().numpy()
        if name == "kmeans_refine":
            bad = sum(not np.array_equal(got_h[i][:len(host[i])], host[i]) for i in range(len(host)))
        else:
            bad = sum(not np.array_equal(got_h[i], host[i]) for i in range(len(host)))
        plan = ""
        if name == "dither_fs":
            p = kernels.dither_plan(*args[0].shape[1:3])
            plan = f", {p.warps} warps, rings of {p.ring_slots} slots in {p.ring} memory, path +{p.grown} steps"
        _verdict(f"check {name} {label} at byte offset {off}{plan}: max_abs_err vs plain {e}, "
                 f"images differing from the host library {bad}/{len(host)}", e == 0 and bad == 0)
        err = max(err, e)
    return err


DITHER_REPEATS = 20


def dither_repeat_case(rng) -> tuple:
    """Two noise images of 1100x2500 with palettes of 64 (the dither's
    inputs, ``dither_inputs``): 35 bands on 32 warps, so bands wrap round
    the warps, the cap binds (the path grows by 516 steps) and the ring that
    feeds warp 0 fills while warp 0 finishes its first band."""
    import numpy as np

    rgba = rng.integers(0, 256, (2, 1100, 2500, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    pal = rng.integers(0, 256, (2, 64, 4), dtype=np.uint8)
    pal[..., 3] = 255
    return dither_inputs(rgba, pal, np.array([64, 64], np.int32))


def check_dither_repeats(dev, args) -> None:
    """The dither kernel on one input (``dither_repeat_case``)
    ``DITHER_REPEATS`` times: every output equal to the first and to the host
    library. No sanitizer runs on the card's machine, so a race in the rings
    shows only as outputs that differ."""
    import numpy as np

    from pixo_tpu_torch.ops import kernels

    t = [at_offset(a, 0, dev) for a in args]
    outs = [kernels.dither_fs(*t) for _ in range(DITHER_REPEATS)]
    differ = sum(not np.array_equal(o.cpu().numpy(), outs[0].cpu().numpy()) for o in outs)
    host = quantize_host_oracles("dither_fs", args)
    bad = sum(not np.array_equal(outs[0][i].cpu().numpy(), h) for i, h in enumerate(host))
    plan = kernels.dither_plan(*args[0].shape[1:3])
    _verdict(f"check dither_fs {DITHER_REPEATS} repeats of {'x'.join(map(str, args[0].shape[:3]))} "
             f"({plan.warps} warps, {plan.ring_slots} slots, path +{plan.grown} steps): {differ} outputs "
             f"differ from the first, images differing from the host library {bad}/{len(host)}",
             differ == 0 and bad == 0)


def dither_global_ring(args, dev):
    """The dither kernel through its C entry on numpy ``args`` with the
    rings in a global scratch (where the plan puts them for rows past
    shared memory), at the plan's warps and slots: the result [B, H, W]."""
    import torch

    from pixo_tpu_torch.ops import kernels

    rgba, pal, lut, kv = [at_offset(a, 0, dev) for a in args]
    b, h, w = rgba.shape[:3]
    plan = kernels.dither_plan(h, w)
    ring = torch.empty((b, plan.warps, plan.ring_slots), dtype=torch.int32, device=dev)
    out = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    lib = kernels.load()
    rc = lib.pixo_dither_fs(rgba.data_ptr(), b, h, w, pal.data_ptr(), pal.shape[1], kv.data_ptr(),
                            lut.data_ptr(), plan.warps, plan.ring_slots, ring.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise Failed(f"dither_fs with global rings: {lib.pixo_cuda_error_string(rc).decode()}")
    return out


def check_dither_global_ring(dev, args, label: str) -> None:
    """``dither_global_ring`` on ``args`` against the host library."""
    host = quantize_host_oracles("dither_fs", args)
    got = dither_global_ring(args, dev).cpu().numpy()
    bad = sum(not (got[i] == h).all() for i, h in enumerate(host))
    _verdict(f"check dither_fs {label} with the rings in global memory: images differing from the host "
             f"library {bad}/{len(host)}", bad == 0)


def lossy_cell_tensors(imgs, opts, dev):
    """One cell's tensors as the path hands them to the kernels: the host
    stage's ``LossyBatch`` and each kernel's inputs, numpy, in call order
    (the k-means's palettes, colours, weights, sizes and colour counts; the
    refined and re-padded palettes with the sizes; the rgba pixels with
    them; the LUTs are the host library's, ``dither_inputs``)."""
    from pixo_tpu_torch.png import quantize as q

    batch = q.quantize_host_stage(imgs, min(opts.quantization.max_colors, 256),
                                  opts.quantization.dithering)
    pal, _, _ = q.quantize_device_stage(batch, False, dev)
    pal = pal.cpu().numpy()
    km = (batch.palettes, batch.colors, batch.weights, batch.k, batch.counts)
    return batch, {"kmeans_refine": km, "palette_lut": (pal, batch.k), "dither_fs": (batch.rgba, pal, batch.k)}


def check_quantize_kernels(dev, corpus, grad) -> dict:
    """Phase 2, lossy PNG: each quantization kernel against its plain
    version on the card and the host library, on ``quantize_edge_cases`` at
    byte offsets 0, 1 and 3, and on the tensors of (q1) and (q2). Returns
    the largest absolute error of each kernel."""
    import numpy as np

    errs = {"kmeans_refine": 0, "palette_lut": 0, "dither_fs": 0}
    for name, cases in quantize_edge_cases(np.random.default_rng(12)).items():
        for label, *args in cases:
            errs[name] = max(errs[name], check_quantize_case(dev, name, label, args, (0, 1, 3)))
            if name == "dither_fs" and "wrap" in label:
                check_dither_global_ring(dev, dither_inputs(*args), label)
    check_dither_repeats(dev, dither_repeat_case(np.random.default_rng(15)))
    for key, (label, opts, imgs) in lossy_cases(corpus, grad).items():
        batch, tensors = lossy_cell_tensors(imgs, opts, dev)
        for name, args in tensors.items():
            errs[name] = max(errs[name], check_quantize_case(
                dev, name, f"({key}) {label}, its {len(batch.members)} device members", args))
    return errs


LOSSY_KERNELS = ("kmeans_refine", "palette_lut", "dither_fs")


def lossy_branches(imgs, opts):
    """(declined, exact-mapped, device) image counts of a lossy batch: the
    per-image decision, then ``quantize_host_stage``'s branches."""
    from pixo_tpu_torch.png import encoder as penc
    from pixo_tpu_torch.png import quantize as q

    bpp = imgs.shape[3]
    ids = [i for i in range(len(imgs)) if penc.quantize_decision(imgs[i].reshape(-1, bpp), opts)]
    batch = q.quantize_host_stage(imgs[ids], penc.max_colors(opts), opts.quantization.dithering)
    return len(imgs) - len(ids), sum(r is not None for r in batch.results), len(batch.members)


def _check_lossy_bytes(dev, label, imgs, opts) -> tuple:
    """Every file of the lossy batch encode against the per-image
    ``png.encode`` (host quantization, host filter); returns the branch
    counts (``lossy_branches``)."""
    from pixo_tpu_torch import encode_png_batch_sharded, png

    outs = encode_png_batch_sharded(imgs, opts, device=dev)
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        same = sum(o == r for o, r in zip(outs, ex.map(lambda img: png.encode(img, opts), imgs)))
    indexed = sum(o[25] == 3 for o in outs)  # IHDR's colour type: 3, a palette
    trns = sum(b"tRNS" in o for o in outs)
    declined, exact, device = lossy_branches(imgs, opts)
    _verdict(f"main path png lossy {label} {'x'.join(map(str, imgs.shape))}: {same}/{len(imgs)} files "
             f"byte-equal to the per-image png.encode; {indexed} indexed, {trns} with tRNS; "
             f"{declined} declined, {exact} exact-mapped, {device} quantized on the card; mean "
             f"{sum(map(len, outs)) / len(outs):.0f} B/file", same == len(imgs))
    return declined, exact, device, trns


def check_lossy_main_path(dev, corpus, grad) -> dict:
    """Phase 3, lossy PNG: (q1) and (q2), each one call of
    ``encode_png_batch_sharded`` with every kernel's launch count set to 0
    before it and read after it; then (q3). Returns each cell's counts."""
    import numpy as np

    from pixo_tpu_torch.ops import kernels

    launches = {}
    for key, (label, opts, imgs) in lossy_cases(corpus, grad).items():
        reset_counts()
        _check_lossy_bytes(dev, f"({key}) {label}", imgs, opts)
        launches[key] = {name: getattr(kernels, name).launches for name in LOSSY_KERNELS}
        _verdict(f"main path png lossy ({key}): launches {launches[key]}",
                 all(n >= 1 for n in launches[key].values()))
    for label, opts, imgs in lossy_correctness_cases(corpus, grad):
        declined, exact, device, trns = _check_lossy_bytes(dev, f"(q3) {label}", imgs, opts)
        if imgs.shape[3] == 4:
            share = float((imgs[..., 3] != 255).mean())
            _verdict(f"(q3) {label}: {share:.1%} of the pixels have alpha below 255, "
                     f"{device} images on the card, {trns} files with tRNS",
                     share > 0 and device >= 1 and trns >= 1)
        if opts.quantization.mode.name == "AUTO":
            _verdict(f"(q3) {label}: every branch taken", min(declined, exact, device) >= 1)
    return launches


def kmeans_work(batch) -> dict:
    """The k-means' work shape for ``kernel_work`` on a ``LossyBatch``:
    both iterations' distances and colours of non-zero weight."""
    import numpy as np

    nz = (batch.weights > 0).sum(1)
    b, k, m = batch.palettes.shape[0], batch.palettes.shape[1], batch.colors.shape[1]
    return dict(b=b, k=k, m=m, distances=int(2 * (nz * np.maximum(batch.k, 1)).sum()),
                assigned=int(2 * nz.sum()))


def quantize_launchers(dev, batch, pal, lut):
    """For each quantization kernel on one cell's tensors (``batch`` a
    ``LossyBatch``, ``pal`` and ``lut`` its refined palettes and their LUTs
    on ``dev``): (the wrapper call, its plain version, the launch alone,
    its work shape for ``kernel_work``)."""
    import numpy as np
    import torch

    from pixo_tpu_torch.ops import kernels, quantize_device

    lib, stream = kernels.load(), torch.cuda.current_stream().cuda_stream
    km = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
          for a in (batch.palettes, batch.colors, batch.weights, batch.k)]
    kv = km[3]
    rgba = torch.from_numpy(batch.rgba).to(dev)
    b, k, m = km[0].shape[0], km[0].shape[1], km[1].shape[1]
    h, w = rgba.shape[1:3]
    km_out, lut_out = torch.empty_like(km[0]), torch.empty_like(lut)
    scratch = torch.zeros(b * k * 5 + b, dtype=torch.int64, device=dev)  # each call leaves it zero
    if hasattr(kernels, "kmeans_plan"):  # the schedule over real colours, one launch an iteration
        counts = tuple(int(n) for n in batch.counts)
        chunks = torch.from_numpy(kernels.kmeans_plan(counts, kernels._sm_count(dev)).chunks).to(dev)

        def km_call():
            return kernels.kmeans_refine(*km, counts)

        def km_args():  # the closure keeps chunks and scratch alive
            return chunks.data_ptr(), chunks.shape[0], scratch.data_ptr(), scratch.data_ptr() + 8 * b * k * 5
    else:  # a checkout from before it: CTAs over slots, an update launch an iteration
        def km_call():
            return kernels.kmeans_refine(*km)

        def km_args():
            return (scratch.data_ptr(),)
    idx_out = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
    plan = kernels.dither_plan(h, w)
    # a checkout from before the band design launches threads over shared or global lags
    dither_launch = ((plan.warps, plan.ring_slots) if hasattr(plan, "warps") else
                     (plan.threads, plan.smem) if plan.route == "shared" else None)
    if dither_launch is None:
        raise Failed(f"the cell's {h}x{w} dither takes the {plan.route} route")
    km_work = kmeans_work(batch)
    return {
        "kmeans_refine": (
            km_call, lambda: quantize_device.kmeans_refine(*km),
            lambda: lib.pixo_kmeans_refine(km[0].data_ptr(), b, k, km[3].data_ptr(), km[1].data_ptr(),
                                           km[2].data_ptr(), m, *km_args(), km_out.data_ptr(), stream),
            km_work),
        "palette_lut": (
            lambda: kernels.palette_lut(pal, kv), lambda: quantize_device.palette_lut(pal, kv),
            lambda: lib.pixo_palette_lut(pal.data_ptr(), b, k, kv.data_ptr(), lut_out.data_ptr(), stream),
            dict(b=b, k=batch.k)),
        "dither_fs": (
            lambda: kernels.dither_fs(rgba, pal, lut, kv),
            lambda: quantize_device.dither_fs(rgba, pal, lut, kv),
            lambda: lib.pixo_dither_fs(rgba.data_ptr(), b, h, w, pal.data_ptr(), k, kv.data_ptr(),
                                       lut.data_ptr(), *dither_launch, None, idx_out.data_ptr(),
                                       stream),
            dict(b=b, h=h, w=w, k=batch.k, alpha_pixels=(batch.rgba[..., 3] != 255).sum((1, 2)))),
    }


def time_lossy(dev, corpus, grad, card: str) -> dict:
    """Phase 4, lossy PNG: each quantization kernel four ways
    (``time_kernel``) at the shapes of (q1) and (q2), the dither's critical
    path beside it, then the stages of each cell (median, least and most of
    ``LOSSY_RUNS`` warm runs): the host stage (histograms, median cut), the
    device stage (the copies up and the three kernels), the copies back, the
    indexed encode and DEFLATE on 8 threads, the whole call, and beside
    them the per-image host ``png.encode`` on 8 threads. Returns the
    kernels' times at (q1) and, under "q2", at (q2)."""
    from pixo_tpu_torch import encode_png_batch_sharded, png
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.png import encoder as penc
    from pixo_tpu_torch.png import quantize as q

    k_ms = {}
    for key, (label, opts, imgs) in lossy_cases(corpus, grad).items():
        b = imgs.shape[0]
        at = f"({key}) {label} {b}x{SIZE}x{SIZE}"
        mp = b * SIZE * SIZE / 1e6
        mc, dith = penc.max_colors(opts), opts.quantization.dithering
        batch = q.quantize_host_stage(imgs, mc, dith)
        pal, lut, idx = q.quantize_device_stage(batch, dith, dev)
        times = {}
        for name, (call, plain, alone, work) in quantize_launchers(dev, batch, pal, lut).items():
            # the plain dither is a Python loop of W + 2(H - 1) steps (1.5-1.8 s a
            # call), the plain LUT 80 ms a call: one call after one warm call
            slow = name in ("dither_fs", "palette_lut")
            times[name] = time_kernel(name, f"{at}, {len(batch.members)} on the card", call, plain,
                                      alone, card, plain_calls=(1, 1, 1) if slow else (10, 5), **work)
        # the same LUT kernel with no k_valid, scanning every padded entry as
        # its first design did: what scanning only the real entries saves
        full_ms = profiler_ms(lambda: kernels.palette_lut(pal), "palette_lut_")
        print(f"kernel palette_lut {at}: device {'not measured' if full_ms is None else f'{full_ms:.4f} ms'}"
              f" (profiler, {PROFILED['palette_lut_']} launches traced in 20 calls) scanning all "
              f"{pal.shape[1]} padded entries, against {times['palette_lut']['device_ms']} ms scanning "
              f"the {int(batch.k.sum())} real ones ({int(batch.k.min())}-{int(batch.k.max())} a palette) "
              f"[{card}]")
        steps = kernels.dither_plan(SIZE, SIZE).steps
        mhz = busy_sm_mhz(quantize_launchers(dev, batch, pal, lut)["dither_fs"][2])
        print(f"kernel dither_fs {at}: critical path {steps} dependent steps, "
              f"{step_line(times['dither_fs']['device_ms'], steps, mhz)} on the card "
              f"(SM clock read under load) [{card}]")
        if key == "q1":
            k_ms.update(times)
        else:
            k_ms["q2"] = times
        results = q.quantize_finish(batch, pal, lut, idx)

        def deflate():
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(lambda r: penc.encode_quantized(*r, opts), results))

        def host_encode():
            with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
                return list(ex.map(lambda img: png.encode(img, opts), imgs))

        stages = {
            "png_lossy_host": lambda: q.quantize_host_stage(imgs, mc, dith),
            "png_lossy_device": lambda: q.quantize_device_stage(batch, dith, dev),
            "png_lossy_d2h": lambda: q.quantize_finish(batch, pal, lut, idx),
            "png_lossy_deflate": deflate,
            "png_lossy_end_to_end": lambda: encode_png_batch_sharded(imgs, opts, device=dev),
            "png_lossy_host_encode_8_threads": host_encode,
        }
        for name, fn in stages.items():
            med, lo, hi = wall_stats(fn, LOSSY_RUNS)
            print(f"stage {name} {at}: median {med:.4f} ms ({lo:.4f} to {hi:.4f}), "
                  f"{mp / (med / 1e3):.1f} MP/s over {LOSSY_RUNS} warm runs [{card}]")
    return k_ms


STREAM_BATCHES = 8  # the stream's batches of the main path's 16x512x512 gradients
STREAM_RUNS = 3  # warm runs of each stream timed


def stream_batches(grad, n: int = STREAM_BATCHES) -> list:
    """``n`` batches of the main path's gradient batch, batch i rolled by 3i
    columns more (so no two batches are equal)."""
    import numpy as np

    return [np.ascontiguousarray(np.roll(grad, 3 * i, axis=2)) for i in range(n)]


def check_stream_path(dev, grad) -> dict:
    """Phase 3, the streams: ``encode_jpeg_stream`` and
    ``encode_jpeg_stream_overlapped`` on ``stream_batches`` at q85 4:2:0,
    every file held to ``_host_reference``, with the launches of each run
    (``coeffs`` and ``compact`` one a batch); then 4 batches at the balanced
    preset (every file held to ``host_tier``, ``count_symbols`` one a
    batch), a noise batch in mid-stream that escalates the cap (one more
    ``compact``, on the copy thread), and a mesh of every visible card (the
    batch entry and the overlapped stream). Returns the launches of the
    overlapped stream's run on the 8 batches, with ``count_symbols``' of
    the balanced run."""
    import numpy as np

    from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.parallel import encode_jpeg_stream, encode_jpeg_stream_overlapped, make_mesh

    size = grad.shape[1]
    opts = JpegOptions(width=size, height=size, quality=QUALITY, subsampling=Subsampling.S420)
    batches = stream_batches(grad)
    want = [_host_reference(b, opts) for b in batches]
    n = len(batches) * len(grad)
    launches = {}
    for name, stream in (("stream", encode_jpeg_stream), ("overlapped", encode_jpeg_stream_overlapped)):
        reset_counts()
        got = list(stream(batches, opts, device=dev))
        launches = {"coeffs": kernels.coeffs.launches, "compact": kernels.compact_padded.launches}
        same = sum(a == b for g, w in zip(got, want) for a, b in zip(g, w))
        _verdict(f"stream {name} {len(batches)}x{grad.shape[0]}x{size}x{size} q{QUALITY} 4:2:0: {same}/{n} "
                 f"files byte-equal to the host encode, in order; launches {launches}",
                 same == n and [len(g) for g in got] == [len(b) for b in batches]
                 and launches == {"coeffs": len(batches), "compact": len(batches)})

    bopts = balanced_options()
    reset_counts()
    got = list(encode_jpeg_stream_overlapped(batches[:4], bopts, device=dev))
    launches["count_symbols"] = kernels.count_symbols.launches
    same = sum(a == b for g, imgs in zip(got, batches[:4]) for a, b in zip(g, host_tier(imgs, bopts)))
    _verdict(f"stream overlapped, balanced preset, 4 batches: {same}/{4 * len(grad)} files byte-equal "
             f"to the host tier; count_symbols launches {launches['count_symbols']}",
             same == 4 * len(grad) and launches["count_symbols"] == 4)

    rng = np.random.default_rng(3)
    base = grad[:4].astype(np.float64)
    light = (base + rng.normal(0, 4, base.shape)).clip(0, 255).astype(np.uint8)
    mixed = [grad[:4], light, grad[4:8]]
    reset_counts()
    got = list(encode_jpeg_stream_overlapped(mixed, opts, device=dev))
    same = sum(a == b for g, imgs in zip(got, mixed) for a, b in zip(g, _host_reference(imgs, opts)))
    escalated = kernels.compact_padded.launches
    _verdict(f"stream overlapped with a noise batch in mid-stream: {same}/12 files byte-equal to the "
             f"host encode; compact launches {escalated} (3 batches, one escalated on the copy thread)",
             same == 12 and escalated == 4)

    mesh = make_mesh(device="cuda")
    flat = [f for w in want[:2] for f in w]
    got_batch = encode_jpeg_batch_sharded(np.concatenate(batches[:2]), opts, mesh=mesh)
    got_stream = list(encode_jpeg_stream_overlapped(batches[:2], opts, mesh=mesh))
    _verdict(f"mesh of {mesh.size} visible card(s) {[str(d) for d in mesh.devices]}: the batch entry "
             f"on 32 images and the overlapped stream on 2 batches give the host encode's files",
             got_batch == flat and got_stream == want[:2])
    return launches


def _busy(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _union(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _overlap(xs, ys) -> float:
    """Total length of the pairwise intersections of two interval lists."""
    return sum(max(0.0, min(b, d) - max(a, c)) for a, b in xs for c, d in ys)


def device_busy_ms(fn):
    """(wall ms of one call of ``fn``, ms in which the card ran a kernel or a
    copy: the union of the CUDA events of ``torch.profiler``'s trace of it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return wall, _union(spans) / 1e3 if spans else None


def time_stream(dev, grad, card: str) -> dict:
    """Phase 4, the streams on ``stream_batches``: the batch entry's time a
    batch (median, least and most of 5 warm runs), then ``STREAM_RUNS`` warm
    runs of each stream: its wall clock, each batch's time (between
    consecutive yields, the first from the call), and for the overlapped
    form the stages' busy sums (``stats``: the copy stage, which waits on
    the card and copies back, and the pack stage), their overlap, and the
    card's busy time in one traced run. Returns the numbers printed."""
    from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded
    from pixo_tpu_torch.parallel import encode_jpeg_stream, encode_jpeg_stream_overlapped

    size = grad.shape[1]
    opts = JpegOptions(width=size, height=size, quality=QUALITY, subsampling=Subsampling.S420)
    batches = stream_batches(grad)
    res = {}
    batch_ms = wall_stats(lambda: encode_jpeg_batch_sharded(batches[0], opts, device=dev))
    res["batch_ms"] = batch_ms
    print(f"stage stream_batch_entry: {batch_ms[0]:.4f} ms a batch of {len(grad)} (least "
          f"{batch_ms[1]:.4f}, most {batch_ms[2]:.4f}; encode_jpeg_batch_sharded, 5 warm runs) [{card}]")
    for name, stream in (("stream", encode_jpeg_stream), ("overlapped", encode_jpeg_stream_overlapped)):
        list(stream(batches[:2], opts, device=dev))  # warm
        walls, per_batch, stage = [], [], []
        for _ in range(STREAM_RUNS):
            stats = {} if name == "overlapped" else None
            kw = {"stats": stats} if stats is not None else {}
            marks = [time.perf_counter()]
            for _files in stream(batches, opts, device=dev, **kw):
                marks.append(time.perf_counter())
            walls.append((marks[-1] - marks[0]) * 1e3)
            per_batch.append([(b - a) * 1e3 for a, b in zip(marks, marks[1:])])
            if stats is not None:
                copy, pack = stats["copy_iv"], stats["pack_iv"]
                stage.append((_busy(copy) * 1e3, _busy(pack) * 1e3, _overlap(copy, pack) * 1e3))
        k = walls.index(_median(walls))
        res[name] = {"wall_ms": walls[k], "per_batch_ms": per_batch[k]}
        print(f"stage stream_{name}: {walls[k]:.4f} ms for {len(batches)} batches of {len(grad)} "
              f"(median of {STREAM_RUNS}: {sorted(walls)}), {walls[k] / len(batches):.4f} ms a batch "
              f"against the batch entry's {batch_ms[0]:.4f}; each batch "
              f"{[round(t, 4) for t in per_batch[k]]} [{card}]")
        if stage:
            c, p, o = stage[k]
            res[name].update(copy_busy_ms=c, pack_busy_ms=p, overlap_ms=o)
            print(f"stage stream_overlapped_stages: copy busy {c:.4f} ms, pack busy {p:.4f} ms, "
                  f"sum {c + p:.4f} ms = {(c + p) / walls[k]:.1%} of the wall clock {walls[k]:.4f} ms; "
                  f"copy and pack in flight together {o:.4f} ms [{card}]")
    wall, busy = device_busy_ms(lambda: list(encode_jpeg_stream_overlapped(batches, opts, device=dev)))
    res["traced"] = {"wall_ms": wall, "device_busy_ms": busy}
    share = "not measured" if busy is None else f"{busy:.4f} ms, {busy / wall:.1%}"
    print(f"stage stream_overlapped_traced: wall {wall:.4f} ms under the profiler, the card busy "
          f"(a kernel or a copy) {share} [{card}]")
    return res


SERVICE_REQUESTS = 32


def worker_kernel_launches() -> dict:
    """The kernel launches counted in the worker that runs this (a
    ``submit_raw`` probe)."""
    from pixo_tpu_torch.ops import kernels

    return {name: getattr(kernels, name).launches
            for name in ("coeffs", "compact_padded", "idct_planes", "resize_lanczos3")}


def service_requests(grad, corpus) -> list:
    """The service phase's 32 mixed requests, 8 of each kind: (kind, args),
    kind one of ``jpeg`` (q85 4:2:0 512x512 gradients), ``png`` (the
    balanced preset on PNG (a)'s photos), ``resize`` (Lanczos3 512 -> 128)
    and ``job`` (``compress_bytes`` of a 512x512 JPEG to a 128x128 JPEG)."""
    from pixo_tpu_torch import ColorType, JpegOptions, PngOptions, Subsampling, jpeg
    from pixo_tpu_torch.options import ResizeFilter, ResizeOptions

    size = grad.shape[1]
    jopts = JpegOptions(width=size, height=size, quality=QUALITY, subsampling=Subsampling.S420)
    popts = PngOptions.balanced(size, size).replace(color_type=ColorType.RGB)
    ropts = ResizeOptions(src_width=size, src_height=size, dst_width=THUMB, dst_height=THUMB,
                          color_type=ColorType.RGB, filter=ResizeFilter.LANCZOS3)
    files = [jpeg.encode(im, jopts.replace(quality=90), device="cpu") for im in corpus[:8]]
    params = {"name": "photo.jpg", "rw": str(THUMB), "rh": str(THUMB), "quality": str(QUALITY)}
    reqs = []
    for i in range(SERVICE_REQUESTS // 4):
        reqs += [("jpeg", (grad[i], jopts)), ("png", (corpus[i], popts)),
                 ("resize", (corpus[8 + i], ropts)), ("job", (files[i], params))]
    return reqs


def run_service(device: str, reqs) -> tuple:
    """The requests ``reqs`` through ``CompressService(workers=2, device=...)``
    after one warm request of each kind on each worker: (results, requests/s
    of the 32, the worker launches of one probe)."""
    import functools

    from pixo_tpu_torch.parallel import CompressService
    from pixo_tpu_torch.playground import compress_bytes

    job = functools.partial(compress_bytes, device=device)

    def submit(svc, kind, args):
        if kind == "job":
            return svc.submit_raw(job, *args)
        return {"jpeg": svc.submit_jpeg, "png": svc.submit_png, "resize": svc.submit_resize}[kind](*args)

    with CompressService(workers=2, device=device) as svc:
        warm = [submit(svc, kind, args) for kind, args in reqs[:4] * 2]
        for r in warm:
            r.result()
        t0 = time.perf_counter()
        handles = [submit(svc, kind, args) for kind, args in reqs]
        results = [h.result() for h in handles]
        rps = len(reqs) / (time.perf_counter() - t0)
        probe = svc.submit_raw(worker_kernel_launches).result()
    return [r[0] if kind == "job" else r for (kind, _), r in zip(reqs, results)], rps, probe


def check_service(dev, grad, corpus, card: str) -> dict:
    """Phase 3, the service: ``CompressService(workers=2)`` on the card with
    ``service_requests``' 32 mixed requests, each result equal to the same
    request on ``device="cpu"`` workers, with the requests/s of both; then on
    the card a request past its deadline, a cancelled one and a crash whose
    respawned workers serve a JPEG on the card again. Returns the
    requests/s."""
    import os as _os

    import numpy as np

    from pixo_tpu_torch.parallel import (
        CompressService,
        RequestCancelled,
        RequestTimeout,
        WorkerCrashed,
    )

    reqs = service_requests(grad, corpus)
    on_card, card_rps, probe = run_service("cuda", reqs)
    on_cpu, cpu_rps, cpu_probe = run_service("cpu", reqs)
    same = sum(bool(np.array_equal(a, b)) if isinstance(a, np.ndarray) else a == b
               for a, b in zip(on_card, on_cpu))
    print(f"stage service_requests_per_s: {card_rps:.2f} on the card, {cpu_rps:.2f} with device=cpu "
          f"(workers=2, {len(reqs)} mixed requests after a warm request of each kind) [{card}]")
    _verdict(f"service on the card: {same}/{len(reqs)} results equal to device=cpu workers' "
             f"(8 each of JPEG q85 4:2:0 512x512, balanced PNG, Lanczos3 512 -> {THUMB}, "
             f"compress_bytes of a JPEG with a resize); a card worker's launches after its share "
             f"{probe}, a CPU worker's {cpu_probe}",
             same == len(reqs) and sum(probe.values()) > 0 and sum(cpu_probe.values()) == 0)

    with CompressService(workers=2, timeout_s=120.0, device="cuda") as svc:
        jpeg_kind, jpeg_args = reqs[0]
        first = svc.submit_jpeg(*jpeg_args).result()
        late = svc.submit_raw(time.sleep, 3.0, timeout=0.3)
        try:
            late.result()
            timed_out = False
        except RequestTimeout:
            timed_out = True
        # two workers, each with a task and one more queued ahead: the fifth
        # request waits in the service's own queue
        blockers = [svc.submit_raw(time.sleep, 0.5) for _ in range(4)]
        queued = svc.submit_raw(time.sleep, 0.1)
        cancelled = svc.cancel(queued)
        try:
            queued.result(timeout=5.0)
            rejected = False
        except (RequestCancelled, RequestTimeout):
            rejected = True
        for b in blockers:
            b.result()
        doomed = svc.submit_raw(_os._exit, 17)
        try:
            doomed.result(timeout=60.0)
            crashed = False
        except WorkerCrashed:
            crashed = True
        again = svc.submit_jpeg(*jpeg_args).result(timeout=120.0)
        respawned = svc.submit_raw(worker_kernel_launches).result(timeout=120.0)
    _verdict(f"service contract on the card: a request past its 0.3 s deadline raises "
             f"RequestTimeout ({timed_out}); a queued request cancelled ({cancelled}) is rejected "
             f"({rejected}); a worker's exit raises WorkerCrashed ({crashed}) and the respawned "
             f"pool serves the JPEG again, byte-equal ({again == first}); a respawned worker's "
             f"launches {respawned}",
             timed_out and cancelled and rejected and crashed and again == first == on_cpu[0])
    return {"card_rps": card_rps, "cpu_rps": cpu_rps}


def check_cli(dev, corpus) -> dict:
    """Phase 3, the CLI: ``cli.main`` with ``--device cuda`` (the default)
    and ``--device cpu`` on a JPEG -> PNG transcode and on a PNG -> JPEG
    one with ``--resize`` and ``--grayscale``, the two outputs byte-equal,
    with the launches of the card's run (``idct_planes`` for the JPEG
    input; ``resize_lanczos3``, ``coeffs`` and ``compact`` for the JPEG
    output). Returns the launches of each card run."""
    import tempfile

    from pixo_tpu_torch import JpegOptions, Subsampling, cli, jpeg
    from pixo_tpu_torch.ops import kernels

    here = os.path.dirname(os.path.abspath(__file__))
    size = corpus.shape[1]
    photo = jpeg.encode(corpus[0], JpegOptions(width=size, height=size, quality=90,
                                               subsampling=Subsampling.S420), device="cpu")
    cases = {
        "jpeg to png": ("in.jpg", photo, [], "out.png", ("idct_planes",)),
        "png to jpeg, --resize 256x192 --grayscale": (
            "in.png", _read(os.path.join(here, "tests", "fixtures", f"corpus_{CORPUS[1]}_512.png")),
            ["--resize", "256x192", "--grayscale", "-q", "80"], "out.jpg",
            ("resize_lanczos3", "coeffs", "compact")),
    }
    wrappers = {"idct_planes": kernels.idct_planes, "resize_lanczos3": kernels.resize_lanczos3,
                "coeffs": kernels.coeffs, "compact": kernels.compact_padded}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, (src, data, flags, dst, expect) in cases.items():
            path = os.path.join(tmp, src)
            with open(path, "wb") as f:
                f.write(data)
            outs = {}
            for device in ("cuda", "cpu"):
                reset_counts()
                rc = cli.main([path, "-o", os.path.join(tmp, f"{device}_{dst}"), "--quiet", *flags,
                               *(["--device", "cpu"] if device == "cpu" else [])])
                outs[device] = (rc, _read(os.path.join(tmp, f"{device}_{dst}")))
                if device == "cuda":
                    out[label] = {k: fn.launches for k, fn in wrappers.items()}
            _verdict(f"cli {label}: --device cuda and --device cpu give {len(outs['cuda'][1])} and "
                     f"{len(outs['cpu'][1])} B, byte-equal; card launches {out[label]}",
                     outs["cuda"] == outs["cpu"] and outs["cuda"][0] == 0
                     and all(out[label][k] >= 1 for k in expect))
    return out


UNFILTER_OFFSETS = (0, 1, 3)  # byte offsets of the filtered rows in their buffer
UNFILTER_STRATEGIES = ("ADAPTIVE", "PAETH", "AVERAGE", "MIN_SUM")  # filter_rows strategies whose rows go back
# The unfilter's critical path: pixel (y, x) needs (y, x - 1), (y - 1, x)
# and (y - 1, x - 1) and nothing else (the bpp bytes of a pixel are
# independent), so its longest chain is ceil(RB / bpp) + H - 1 pixels
# (``unfilter_steps``). A step of it holds at least one dependent integer
# add, the chain of the Sub and Up predictors (out = x + a, out = x + b);
# the Average and Paeth predictors' chains are longer (Paeth's runs through
# its whole select), so 4 SM clocks a step at the 1.98 GHz boost clock is a
# floor for any mix of filters, beside the byte bound.
UNFILTER_STEP_CLOCKS = 4


def unfilter_steps(h: int, rb: int, bpp: int) -> int:
    """The unfilter's critical path in dependent pixel steps."""
    return -(-rb // bpp) + h - 1


def host_unfilter(rows, filters, bpp: int):
    """The host library's serial ``png_unfilter`` of each image of the [B, H,
    RB] rows with their [B, H] filter ids (0-4)."""
    import numpy as np

    from pixo_tpu_torch.native import native_png_unfilter

    return np.stack([native_png_unfilter(np.concatenate([f[:, None].astype(np.uint8), r], 1), bpp)
                     for r, f in zip(rows, filters)])


def filtered_rows(dev, imgs, strategy):
    """PNG rows of the [B, H, W, 3] uint8 ``imgs`` as ``filter_rows`` filters
    them on ``dev`` under ``strategy``: ([B, H, 3W] filtered rows, [B, H]
    int32 filter ids), both contiguous on the card."""
    import numpy as np
    import torch

    from pixo_tpu_torch.ops import kernels

    b, h, w = imgs.shape[:3]
    x = torch.from_numpy(np.ascontiguousarray(imgs).reshape(b, h, 3 * w)).to(dev)
    out = kernels.filter_rows(x, bpp=3, strategy=strategy, small_image=False, sticky_fast=False)
    return out[..., 1:].contiguous(), out[..., 0].to(torch.int32).contiguous()


# Splits that ``check_unfilter_kernel`` forces on every case beside the
# plan's own: (label, unfilter_plan's ctas, warps, ring).
UNFILTER_FORCED = (("one SM an image", 1, None, None), ("2 CTAs", 2, None, None),
                   ("8 CTAs of one warp", 8, 1, None), ("global rings on 3 CTAs", 3, None, "global"))


def unfilter_launcher(lib, rows, ids, bpp: int, plan, out):
    """A launch of csrc/unfilter.cu's C entry under ``plan`` (the wrapper's
    ``unfilter_plan`` or a forced one) on the [B, H, RB] ``rows`` and [B, H]
    int32 ``ids`` into ``out``, its global rings (if any) allocated once
    here: a call that returns the entry's code."""
    import torch

    b, h, rb = rows.shape
    ring = torch.empty(b * plan.scratch, dtype=torch.uint8, device=rows.device) if plan.ring == "global" else None
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        return lib.pixo_unfilter(rows.data_ptr(), ids.data_ptr(), b, h, rb, bpp, plan.ctas, plan.warps,
                                 plan.ring_slots, None if ring is None else ring.data_ptr(), out.data_ptr(),
                                 stream)
    return launch


def check_unfilter_kernel(dev, corpus) -> int:
    """Phase 2, the unfilter kernel (``ops/png_unfilter.py::
    unfilter_device_batch``; no path calls it): every case of
    ``unfilter_edge_cases`` (every bpp 1-8 and filter id, H = 1, RB < bpp, RB
    = 1, ids outside 0-4, heights at and across a band) at byte offsets
    ``UNFILTER_OFFSETS``, bit for bit against its plain version on the card
    and, where every id is 0-4, image by image against the host library's
    ``png_unfilter``, through the wrapper (``unfilter_plan``'s split) and
    under each of ``UNFILTER_FORCED``; then the rows that ``filter_rows``
    filtered from PNG (a)'s 16 images under each of
    ``UNFILTER_STRATEGIES``, which it must also give back. Returns its
    largest absolute error."""
    import numpy as np
    import torch

    from pixo_tpu_torch import FilterStrategy
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.png_unfilter import unfilter_device_batch, unfilter_plain, unfilter_plan

    err, lib = 0, kernels.load()
    for label, rows, filters, bpp in unfilter_edge_cases(np.random.default_rng(41)):
        ids = torch.from_numpy(filters).to(dev)
        plain = unfilter_plain(at_offset(rows, 0, dev), ids, bpp)
        host = host_unfilter(rows, filters, bpp) if ((filters >= 0) & (filters <= 4)).all() else None
        errs, host_bad, forced_bad = [], 0, []
        for offset in UNFILTER_OFFSETS:
            t = at_offset(rows, offset, dev)
            got = unfilter_device_batch(t, ids, bpp=bpp, device=dev)
            errs.append(int((got.int() - plain.int()).abs().max()))
            host_bad += host is not None and not np.array_equal(got.cpu().numpy(), host)
            for name, ctas, warps, ring in UNFILTER_FORCED:
                plan = unfilter_plan(*rows.shape, bpp, ctas=ctas, warps=warps, ring=ring)
                out = torch.empty_like(plain)
                rc = unfilter_launcher(lib, t, ids, bpp, plan, out)()
                if rc:
                    raise Failed(f"unfilter {label} under {name} {plan}: {lib.pixo_cuda_error_string(rc).decode()}")
                if not torch.equal(out, plain):
                    forced_bad.append(f"{name} at offset {offset}")
        err = max(err, *errs)
        _verdict(f"check unfilter {label} ({unfilter_plan(*rows.shape, bpp, kernels._sm_count(dev))[:4]}): "
                 f"max_abs_err vs plain {max(errs)} at byte offsets {UNFILTER_OFFSETS}; offsets differing from "
                 f"the host library's png_unfilter {host_bad if host is not None else 'not held (ids outside 0-4)'}; "
                 f"forced splits differing from plain {forced_bad or 'none'}",
                 max(errs) == 0 and host_bad == 0 and not forced_bad)
    want = corpus.reshape(corpus.shape[0], corpus.shape[1], -1)
    for name in UNFILTER_STRATEGIES:
        rows, ids = filtered_rows(dev, corpus, FilterStrategy[name])
        got = unfilter_device_batch(rows, ids, bpp=3, device=dev)
        e = int((got.int() - unfilter_plain(rows, ids, 3).int()).abs().max())
        err = max(err, e)
        back = got.cpu().numpy()
        host = host_unfilter(rows.cpu().numpy(), ids.cpu().numpy(), 3)
        used = sorted(set(ids.cpu().numpy().ravel().tolist()))
        _verdict(f"check unfilter PNG (a) {tuple(rows.shape)} filtered by filter_rows under {name} (ids "
                 f"{used}): max_abs_err vs plain {e}; images given back {int((back == want).all((1, 2)).sum())}"
                 f"/{len(want)}, equal to the host library's {int((back == host).all((1, 2)).sum())}/{len(want)}",
                 e == 0 and np.array_equal(back, want) and np.array_equal(back, host))
    return err


def time_unfilter(dev, corpus, card: str) -> dict:
    """Phase 4, the unfilter kernel four ways (``time_kernel``) at PNG (a)'s
    device group (8x512x1536: the first 8 images' rows as ``filter_rows``
    filters them under the balanced preset's ADAPTIVE), beside both of its
    bounds: its bytes at the memory rate (``bound_ms``) and its critical
    path, ``unfilter_steps`` dependent steps at ``UNFILTER_STEP_CLOCKS`` a
    step, with the share of that bound that the kernel reaches and its time
    a step in ns and SM clocks (the clock read under load)."""
    import torch

    from pixo_tpu_torch import FilterStrategy
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.png_unfilter import unfilter_device_batch, unfilter_plain, unfilter_plan

    rows, ids = filtered_rows(dev, corpus[:8], FilterStrategy.ADAPTIVE)
    b, h, rb = rows.shape
    plan = unfilter_plan(b, h, rb, 3, kernels._sm_count(dev))
    alone = unfilter_launcher(kernels.load(), rows, ids, 3, plan, torch.empty_like(rows))
    at = f"PNG (a) device group {b}x{h}x{rb}, bpp 3, ADAPTIVE's rows, {plan.ctas} CTAs of {plan.warps} warps an image"
    t = time_kernel("unfilter", at, lambda: unfilter_device_batch(rows, ids, bpp=3, device=dev),
                    lambda: unfilter_plain(rows, ids, 3), alone, card, plain_calls=(1, 1, 1),
                    kernel="unfilter_kernel", b=b, h=h, rb=rb)
    steps = unfilter_steps(h, rb, 3)
    floor = steps * UNFILTER_STEP_CLOCKS / 1.98e9 * 1e3
    mhz = busy_sm_mhz(alone, calls=200)
    ms = t["device_ms"]
    ns = None if ms is None else ms / steps * 1e6
    t["critical_path"] = {"steps": steps, "bound_ms": floor, "share": None if ms is None else floor / ms,
                          "ns_a_step": ns, "clocks_a_step": None if ns is None or mhz is None else ns * mhz / 1e3}
    share = "not measured" if ms is None else f"{100 * floor / ms:.2f}%"
    print(f"kernel unfilter {at}: critical path {steps} dependent pixel steps (ceil(RB / bpp) + H - 1), "
          f"bound {floor:.4f} ms at {UNFILTER_STEP_CLOCKS} SM clocks a step (one add, the Sub and Up "
          f"chain) at 1.98 GHz; the kernel reaches {share} of it, {step_line(ms, steps, mhz)} "
          f"(SM clock read under load) [{card}]")
    return t


def check_png_decode_path(dev, corpus) -> int:
    """Phase 3, the PNG decode: ``decode_png_batch`` of PNG (a)'s 16 files
    (encoded on the card at the balanced preset), every image equal to its
    input; the unfilter kernel's launches in that run: 0, as in the JAX
    package, whose PNG decode reconstructs rows with the host library.
    Returns those launches."""
    import numpy as np

    from pixo_tpu_torch import ColorType, PngOptions, png
    from pixo_tpu_torch.decode import decode_png_batch
    from pixo_tpu_torch.ops import png_unfilter

    h, w = corpus.shape[1:3]
    files = png.encode_batch(corpus, PngOptions.balanced(w, h).replace(color_type=ColorType.RGB), device=dev)
    reset_counts()
    images = decode_png_batch(files, workers=8)
    launches = png_unfilter.unfilter_device_batch.launches
    same = sum(np.array_equal(img.pixels, want) for img, want in zip(images, corpus))
    _verdict(f"main path PNG decode: decode_png_batch of PNG (a)'s {len(files)} files, {same}/{len(files)} "
             f"images equal to their input; unfilter launches {launches} (rows reconstructed by the "
             f"host library)", same == len(files) and launches == 0)
    return launches


DECODE_TIERS = (  # (PIXO_TPU_DECODE_PIXELS, device, the tier that runs)
    (None, "cuda", "device"), ("host", "cuda", "host"), (None, "cpu", "host"))


def check_decode_tiers(dev, cases) -> None:
    """Phase 3, the decode's two pixel tiers: ``decode_jpeg_batch`` of (d1) and
    (d3) under each of ``DECODE_TIERS``, every image held against the host
    library's decodes (``_held_to_host``), ``idct_planes`` launched once
    under the device tier on the card and never under the host tier."""
    from pixo_tpu_torch.decode import decode_jpeg_batch
    from pixo_tpu_torch.ops import kernels

    for key in ("d1", "d3"):
        label, files, _ = cases[key]
        for env, device, tier in DECODE_TIERS:
            with env_var("PIXO_TPU_DECODE_PIXELS", env):
                reset_counts()
                images = decode_jpeg_batch(files, workers=8, device=dev if device == "cuda" else device)
                calls = kernels.idct_planes.launches
            two, fused, nbase = _held_to_host(images, files, False)
            _verdict(f"decode tiers ({key}) {label}: device={device}, PIXO_TPU_DECODE_PIXELS="
                     f"{env or 'unset'} -> the {tier} tier: {two}/{len(files)} images equal to the host "
                     f"two-stage decode, {fused}/{nbase} baseline images to the fused one; idct_planes "
                     f"launches {calls}",
                     two == len(files) and fused == nbase and calls == (tier == "device"))


def playground_jobs(corpus) -> list:
    """(label, body, form) of the playground's card check: a PNG job and two
    JPEG jobs, one with a resize; inputs made by the port on the host."""
    from pixo_tpu_torch import ColorType, JpegOptions, PngOptions, Subsampling, jpeg, png

    img = corpus[1, :200, :240]
    png_src = png.encode(img, PngOptions.fast(240, 200).replace(color_type=ColorType.RGB), device="cpu")
    jpg_src = jpeg.encode(img, JpegOptions(width=240, height=200, quality=90, subsampling=Subsampling.S444),
                          device="cpu")
    return [("png lossless, balanced, from a PNG", png_src,
             {"format": "png", "preset": "1", "lossless": "true", "name": "a.png"}),
            ("jpeg q85 4:2:0 from a PNG", png_src,
             {"format": "jpeg", "preset": "1", "quality": "85", "sub420": "true", "name": "a.png"}),
            ("jpeg q70 from a JPEG, resized to 120x100", jpg_src,
             {"format": "auto", "preset": "0", "quality": "70", "rw": "120", "rh": "100", "name": "b.jpg"})]


def check_playground(dev, corpus) -> dict:
    """Phase 3, the playground's HTTP front on the card
    (``playground.make_handler``, served on 127.0.0.1): through its
    ``CompressService`` of two workers on the card, then inline. ``GET /``
    serves the page and another path 404; each of ``playground_jobs`` comes
    back byte-equal to ``compress_bytes(..., device="cpu")`` with the same
    meta; a body that is no image gives 422. Returns the launches of the
    inline run's jobs."""
    import http.client
    import threading
    from http.server import ThreadingHTTPServer
    from urllib.parse import urlencode

    from pixo_tpu_torch import playground
    from pixo_tpu_torch.ops import kernels

    jobs = playground_jobs(corpus)
    want = [playground.compress_bytes(body, form, device="cpu") for _, body, form in jobs]
    wrappers = {"idct_planes": kernels.idct_planes, "resize_lanczos3": kernels.resize_lanczos3,
                "coeffs": kernels.coeffs, "compact": kernels.compact_padded,
                "filter_rows": kernels.filter_rows}

    def request(port, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        headers = dict(resp.getheaders())
        conn.close()
        return resp.status, headers, data

    launches = {}
    for mode in ("service", "inline"):
        t0 = time.perf_counter()
        with env_var("PIXO_TPU_PLAYGROUND_INLINE", "1" if mode == "inline" else None):
            handler = playground.make_handler(dev)
        started = time.perf_counter() - t0
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        port = srv.server_address[1]
        try:
            page = request(port, "GET", "/")
            missing = request(port, "GET", "/nothing")[0]
            reset_counts()
            same = []
            for (label, body, form), (out, meta) in zip(jobs, want):
                status, headers, got = request(port, "POST", "/compress?" + urlencode(form), body)
                got_meta = json.loads(headers.get("X-Pixo-Result", "{}"))
                got_meta.pop("elapsed_ms", None)
                meta = {k: v for k, v in meta.items() if k != "elapsed_ms"}
                same.append(status == 200 and got == out and got_meta == meta)
            if mode == "inline":
                launches = {k: fn.launches for k, fn in wrappers.items()}
            bad = request(port, "POST", "/compress?format=png&name=x.png", b"no image here")
        finally:
            srv.shutdown()
            srv.server_close()
            handler.close()
        _verdict(f"playground on the card, {mode} (started in {started:.1f} s): GET / {page[0]}, "
                 f"another path {missing}; jobs byte-equal to compress_bytes(device=\"cpu\") with the "
                 f"same meta: {sum(same)}/{len(jobs)} ({', '.join(j[0] for j in jobs)}); a body that is no "
                 f"image {bad[0]} {bad[2].decode()[:60]!r}"
                 + (f"; launches {launches}" if mode == "inline" else ""),
                 page[0] == 200 and b"pixo-tpu" in page[2] and missing == 404 and all(same)
                 and bad[0] == 422 and (mode != "inline" or (launches["coeffs"] >= 2
                                                              and launches["resize_lanczos3"] >= 1
                                                              and launches["idct_planes"] >= 1)))
    return launches


def check_dcn() -> None:
    """Phase 3, two processes over gloo with both ranks on cuda:0: the payload
    of ``tests/test_torch_dcn.py`` (each rank encodes its half of the 8
    gradients on the card; the gathered files equal one process's
    ``jpeg.encode_batch`` of all 8, the all-reduced coefficient digest the
    local one)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "test_torch_dcn.py")
    spec = importlib.util.spec_from_file_location("torch_dcn_payload", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    try:
        outs = mod.run_pair("cuda:0")
        ok, what = True, "; ".join(line for out in outs for line in out.splitlines() if "DCN-OK" in line)
    except AssertionError as e:
        ok, what = False, str(e)
    _verdict(f"two processes over gloo on cuda:0 ({time.perf_counter() - t0:.1f} s): {what}", ok)


def main_path_launchers(kernels, imgs_dev, lum, chrom, mode: str = "420", cap: int = 8):
    """For ``coeffs`` (in ``mode``) and ``compact`` (at ``cap``) on the batch
    ``imgs_dev``: (the wrapper call, the launch alone). The launch alone
    calls the C function with its outputs and tables made beforehand, so it
    times what the card and the CUDA runtime do, without the wrapper's checks
    and allocations. Returns the batch's coefficients and the two pairs."""
    import torch

    b, h, w, c = imgs_dev.shape
    lib = kernels.load()
    stream = torch.cuda.current_stream().cuda_stream
    lum32, chrom32 = kernels._table(lum), kernels._table(chrom)
    zz = kernels.coeffs(imgs_dev, lum, chrom, mode)
    n = zz.shape[1]
    dev = imgs_dev.device
    # laid out as the wrapper lays them out (total and maxcount side by
    # side); written here so that an earlier checkout is timed alike
    outs = [torch.empty(shape, dtype=dt, device=dev) for shape, dt in (
        ((b, n), torch.int16), ((b, n), torch.uint8), ((b, n, cap), torch.uint8),
        ((b, n, cap), torch.int16))]
    outs += torch.empty((2, b), dtype=torch.int32, device=dev).unbind(0)
    zz_out = torch.empty_like(zz)
    ptrs = [t.data_ptr() for t in outs]
    code = {"gray": 0, "444": 1, "420": 2, "422": 3}[mode]  # csrc/coeffs.cu's modes

    def coeffs_alone():
        return lib.pixo_coeffs(imgs_dev.data_ptr(), b, h, w, c, code, lum32.ctypes.data,
                               chrom32.ctypes.data, zz_out.data_ptr(), stream)

    def compact_alone():
        return lib.pixo_compact(zz.data_ptr(), b, n, cap, *ptrs, stream)

    if coeffs_alone() or compact_alone():
        raise Failed("a launch-alone call returned an error")
    torch.cuda.synchronize()
    return zz, {
        "coeffs": (lambda: kernels.coeffs(imgs_dev, lum, chrom, mode), coeffs_alone),
        "compact": (lambda: kernels.compact_padded(zz, cap), compact_alone),
    }


def measure_tree(root: str) -> dict:
    """The same-call comparison's numbers for the checkout at ``root`` (this
    slice or an earlier one): for ``coeffs``, ``compact`` and
    ``count_symbols`` at 16x512x512 q85 4:2:0 (the count also at its first
    image alone), the AAN contract at 100,000 blocks, ``filter_rows`` at PNG
    (a) and (b) and in mode 7 (Bigrams) at (e)'s device group and on noise
    rows of its shape, ``idct_planes`` at decode (d1) and (d3) and ``resize`` and
    ``coeffs`` (4:4:4) at the (t1) chunk, the profiler's device time, the
    launch alone and the call as the path makes it; the device stages, the decode's host
    stage and copy to the card, and the end-to-end stages of phase 4 (JPEG
    encode, standard and balanced, PNG (a) and (b), decode (d1) and (d3));
    ``dct_zz`` and ``trellis_quantize`` at the max cells (m1) and (m2), and
    the max call there beside the host tier on 8 threads (the median of
    THUMB_RUNS); the ``PIXO_TPU_LZ77=device`` route's kernels and its (e)
    stages (``measure_lz77``); ``unfilter`` at PNG (a)'s device group
    (``measure_unfilter``). Every kernel result is first held against its
    plain version."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from pixo_tpu_torch import (
        JpegOptions,
        Subsampling,
        encode_jpeg_batch_sharded,
        encode_png_batch_sharded,
        native,
    )
    from pixo_tpu_torch.decode import decode_jpeg_batch
    from pixo_tpu_torch.decode import jpeg_decoder as jd
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels, png_filters
    from pixo_tpu_torch.ops.sparse_pack import sparsify_blocks_padded_batch
    from pixo_tpu_torch.parallel.pipeline import jpeg_coeffs_sharded

    if not kernels.__file__.startswith(os.path.abspath(root)):
        raise Failed(f"pixo_tpu_torch came from {kernels.__file__}, not from {root}")
    dev = torch.device("cuda")
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:
        for built in [ex.submit(kernels.load), ex.submit(native.load)]:
            built.result()
    for line in kernels.build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "entry function")):
            print(f"ptxas [{root}]: {line.strip()}")
    grad = gradient_batch(BATCH, SIZE)
    quant = QuantizationTables(QUALITY)
    lum, chrom = quant.luminance_table, quant.chrominance_table
    grad_dev = torch.from_numpy(grad).to(dev)
    zz, launchers = main_path_launchers(kernels, grad_dev, lum, chrom)
    if not torch.equal(zz, kernels.coeffs_plain(grad_dev, lum, chrom, "420")):
        raise Failed(f"coeffs of {root} differs from its plain version")
    for g, r in zip(kernels.compact_padded(zz, 8), sparsify_blocks_padded_batch(zz, 8)):
        if not torch.equal(g, r):
            raise Failed(f"compact of {root} differs from its plain version")
    res = {"tree": root, "kernels": {}, "stages": {}}
    for name, (call, alone) in launchers.items():
        res["kernels"][name] = {
            "device_ms": profiler_ms(call, f"{name}_"),  # filter_rows_strip_kernel, coeffs_kernel, ...
            "launch_ms": event_ms(alone),
            "call_ms": event_ms(call),
        }
    opts = JpegOptions(width=SIZE, height=SIZE, quality=QUALITY, subsampling=Subsampling.S420)
    corpus = corpus_batch()
    stages = res["stages"]

    def three_ways(name, kernel, call, alone, plain):
        if not torch.equal(call(), plain()):
            raise Failed(f"{name} of {root} differs from its plain version")
        res["kernels"][name] = {"device_ms": profiler_ms(call, kernel), "launch_ms": event_ms(alone),
                                "call_ms": event_ms(call)}

    blocks = aan_cases(dev, 100_000)[len(AAN_COUNTS)][1]
    dct_out, stream = torch.empty_like(blocks), torch.cuda.current_stream().cuda_stream
    three_ways("dct8x8_aan (100,000 blocks)", "dct8x8_aan_kernel", lambda: kernels.dct8x8_aan(blocks),
               lambda: kernels.load().pixo_dct8x8_aan(blocks.data_ptr(), dct_out.data_ptr(), 100_000, stream),
               lambda: kernels.dct8x8_aan_plain(blocks))
    stages["device_kernels"] = wall_ms(
        lambda: kernels.compact_padded(jpeg_coeffs_sharded(grad_dev, opts, device=dev), 8))
    stages["end_to_end"] = wall_ms(lambda: encode_jpeg_batch_sharded(grad, opts, device=dev))
    for key, (_, popts, imgs) in png_cases(corpus, grad).items():
        px, raw, _, kw = png_group(dev, popts, imgs)
        three_ways(f"filter_rows ({key})", "filter_rows_", lambda: kernels.filter_rows(raw, **kw),
                   filter_rows_alone(raw, kw), lambda: png_filters.filter_rows_plain(raw, **kw))
        stages[f"png_device ({key})"] = wall_ms(lambda: png_device_stage(px, popts, kernels.filter_rows))
        stages[f"png_end_to_end ({key})"] = wall_ms(
            lambda: encode_png_batch_sharded(imgs, popts, device=dev))
    if hasattr(png_filters, "MODE_BIGRAMS"):  # a checkout from before the max preset has no mode 7
        import numpy as np

        _, popts, imgs = png_max_case(corpus)
        _, raw, _, kw = png_group(dev, popts, imgs)
        noise = torch.from_numpy(np.random.default_rng(5).integers(0, 256, tuple(raw.shape), dtype=np.uint8))
        for key, rows in (("e", raw), ("noise rows of (e)'s shape", noise.to(dev))):
            three_ways(f"filter_rows mode 7 ({key})", "filter_rows_", lambda: kernels.filter_rows(rows, **kw),
                       filter_rows_alone(rows, kw), lambda: png_filters.filter_rows_plain(rows, **kw))
    cases = decode_cases(dev, grad, corpus)
    for key in ("d1", "d3"):
        files = cases[key][1]
        run = decode_launchers(dev, files)
        three_ways(f"idct_planes ({key})", "idct_planes_kernel", run["call"], run["alone"],
                   run["plain"])
        stages[f"decode_host_stage ({key})"] = wall_ms(run["host"])
        stages[f"decode_h2d ({key})"] = wall_ms(run["h2d"])
        stages[f"decode_device ({key})"] = wall_ms(
            lambda: jd._upsample_colour(run["call"](), run["batch"], False))
        stages[f"decode_end_to_end ({key})"] = wall_ms(lambda: decode_jpeg_batch(files, device=dev))
    if hasattr(kernels, "count_symbols"):  # a checkout from before the balanced route has none
        from pixo_tpu_torch.ops.huffman_device import count_symbols_plain

        pattern, bopts = COUNT_PATTERNS["420"], opts.replace(optimize_huffman=True)
        if not all(torch.equal(g, r) for g, r in zip(kernels.count_symbols(zz, pattern),
                                                      count_symbols_plain(zz, pattern))):
            raise Failed(f"count_symbols of {root} differs from its plain version")
        three_ways("count_symbols", "count_symbols_", lambda: kernels.count_symbols(zz, pattern)[1],
                   count_alone(kernels, zz, pattern), lambda: count_symbols_plain(zz, pattern)[1])
        one = zz[:1].contiguous()
        three_ways("count_symbols (one image)", "count_symbols_",
                   lambda: kernels.count_symbols(one, pattern)[1], count_alone(kernels, one, pattern),
                   lambda: count_symbols_plain(one, pattern)[1])
        stages["balanced_end_to_end"] = wall_ms(lambda: encode_jpeg_batch_sharded(grad, bopts, device=dev))
    if hasattr(kernels, "resize_lanczos3"):  # a checkout from before the thumbnail path has none
        from pixo_tpu_torch import thumbnail_pipeline
        from pixo_tpu_torch.ops.resize_kernels import _taps_on, resize_lanczos3_batch

        _, files, chunk = thumbnail_cases(dev, cases)["t1"]
        batch = jd._host_stage(files[:chunk], 8, pinned=True)
        pixels, ((members, shape, offset),) = jd._device_tail(batch, False, dev), jd._pixel_groups(batch)
        imgs = pixels[offset:].view(len(members), *shape)
        taps = (*_taps_on(shape[1], THUMB, dev), *_taps_on(shape[0], THUMB, dev))
        call = lambda: resize_lanczos3_batch(imgs, dst_w=THUMB, dst_h=THUMB)  # noqa: E731
        three_ways("resize_lanczos3 (t1 chunk)", "resize_lanczos3_", call, resize_alone(imgs, THUMB)[0],
                   lambda: kernels.resize_lanczos3_plain(imgs, *taps))
        for name in ("horizontal", "vertical"):  # each launch's own device time
            res["kernels"][f"resize_lanczos3 {name} (t1 chunk)"] = {
                "device_ms": profiler_ms(call, f"resize_lanczos3_{name[0]}_"), "launch_ms": None,
                "call_ms": None}
        thumb_q = QuantizationTables(THUMB_QUALITY)  # the chunk's coefficients, as the path takes them
        thumb_lum, thumb_chrom = thumb_q.luminance_table, thumb_q.chrominance_table
        thumbs = call()
        _, chunk_launchers = main_path_launchers(kernels, thumbs, thumb_lum, thumb_chrom, mode="444")
        three_ways("coeffs (t1 chunk)", "coeffs_", chunk_launchers["coeffs"][0], chunk_launchers["coeffs"][1],
                   lambda: kernels.coeffs_plain(thumbs, thumb_lum, thumb_chrom, "444"))
        stages["thumb_end_to_end (t1)"] = wall_stats(lambda: thumbnail_pipeline(
            files, thumb_size=THUMB, quality=THUMB_QUALITY, chunk_size=chunk, device=dev))[0]
    if hasattr(kernels, "trellis_quantize"):  # a checkout from before the max preset has none
        from pixo_tpu_torch import jpeg
        from pixo_tpu_torch.ops.trellis_device import trellis_quantize_batch_plain

        lib = kernels.load()
        if hasattr(lib, "pixo_trellis_ctas_per_sm"):
            print(f"occupancy [{root}]: trellis_quantize {lib.pixo_trellis_ctas_per_sm()} CTAs an SM")
        for key, (_, imgs) in trellis_cells(grad, corpus).items():
            imgs_dev = torch.from_numpy(imgs).to(dev)
            dct, lum, chrom, pattern = cell_trellis_inputs(dev, imgs)
            three_ways(f"dct_zz ({key})", DCT_ZZ_KERNEL,
                       lambda: kernels.dct_zz(imgs_dev, "420"), dct_zz_alone(kernels, imgs_dev),
                       lambda: kernels.dct_zz_plain(imgs_dev, "420"))
            three_ways(f"trellis_quantize ({key})", "trellis_quantize_kernel",
                       lambda: kernels.trellis_quantize(dct, lum, chrom, pattern),
                       trellis_alone(lib, dct, lum, chrom, pattern),
                       lambda: trellis_quantize_batch_plain(dct, lum, chrom, pattern))
            stages[f"max_end_to_end ({key})"] = wall_stats(
                lambda: encode_jpeg_batch_sharded(imgs, max_options(), device=dev))[0]
            stages[f"max_host_library_8_threads ({key})"] = wall_stats(
                lambda: jpeg.encode_batch(imgs, max_options(), device="cpu"))[0]
    if hasattr(kernels, "dither_fs"):  # a checkout from before the lossy path has none
        from pixo_tpu_torch.png import quantize as q

        _, popts, imgs = lossy_cases(corpus, grad)["q1"]
        batch = q.quantize_host_stage(imgs, 256, True)
        pal, lut, _ = q.quantize_device_stage(batch, True, dev)
        for name, (call, plain, alone, _) in quantize_launchers(dev, batch, pal, lut).items():
            three_ways(f"{name} (q1)", f"{name}_", call, alone, plain)
        stages["png_lossy_end_to_end (q1)"] = wall_stats(
            lambda: encode_png_batch_sharded(imgs, popts, device=dev), LOSSY_RUNS)[0]
    if hasattr(png_filters, "MODE_BIGRAMS"):  # a checkout from before the LZ77 route has none
        measure_lz77(res, dev, corpus)
    measure_unfilter(res, dev, corpus)
    return res


def measure_unfilter(res: dict, dev, corpus) -> None:
    """``measure_tree``'s numbers of the unfilter kernel at PNG (a)'s device
    group (``time_unfilter``'s rows), held first to its plain version: the
    wrapper's call, and its launch alone through the checkout's own C entry
    (a thread a row and a CTA an image before ``unfilter_plan``; the plan's
    split after)."""
    import importlib.util

    import torch

    if importlib.util.find_spec("pixo_tpu_torch.ops.png_unfilter") is None:
        return
    from pixo_tpu_torch import FilterStrategy
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops import png_unfilter as pu

    rows, ids = filtered_rows(dev, corpus[:8], FilterStrategy.ADAPTIVE)
    b, h, rb = rows.shape
    lib, out = kernels.load(), torch.empty_like(rows)
    if hasattr(pu, "unfilter_plan"):
        alone = unfilter_launcher(lib, rows, ids, 3, pu.unfilter_plan(b, h, rb, 3, kernels._sm_count(dev)), out)
    else:
        stream = torch.cuda.current_stream().cuda_stream
        alone = lambda: lib.pixo_unfilter(rows.data_ptr(), ids.data_ptr(), b, h, rb, 3,  # noqa: E731
                                          out.data_ptr(), stream)
    call = lambda: pu.unfilter_device_batch(rows, ids, bpp=3, device=dev)  # noqa: E731
    if not torch.equal(call(), pu.unfilter_plain(rows, ids, 3)):
        raise Failed(f"unfilter of {res['tree']} differs from its plain version")
    res["kernels"]["unfilter (a)"] = {"device_ms": profiler_ms(call, "unfilter_kernel"),
                                      "launch_ms": event_ms(alone), "call_ms": event_ms(call)}


def measure_lz77(res: dict, dev, corpus) -> None:
    """``measure_tree``'s numbers of the ``PIXO_TPU_LZ77=device`` route:
    ``chain_candidates`` (k = 16) at one of (e)'s streams and at 16 MiB of
    values 0-3, with its rows' kernel and its scans alone (the profiler's
    device time), ``adler32`` at 16 MiB, each held against its plain version
    first; the (e) call's DEFLATE on 8 threads and end to end under the
    route and beside it without (the median of ``MAX_PNG_RUNS``)."""
    import importlib.util

    import numpy as np
    import torch

    if importlib.util.find_spec("pixo_tpu_torch.ops.lz77_assist") is None:
        return
    from pixo_tpu_torch import encode_png_batch_sharded
    from pixo_tpu_torch.compress import checksums
    from pixo_tpu_torch.compress.deflate import LZ77_ASSIST_STEPS
    from pixo_tpu_torch.ops import lz77_assist as lz
    from pixo_tpu_torch.parallel.pipeline import png_frame

    names = [kn for kernels_of, _, _ in LZ77_DESIGNS.values() for kn in kernels_of]
    every, rows = tuple(dict.fromkeys(names)), tuple(r for _, r, _ in LZ77_DESIGNS.values())
    scans = ("exclusive_scan_kernel", "bin_scan_kernel")
    k, streams = LZ77_ASSIST_STEPS, png_max_streams(dev, corpus)
    inputs = {"e stream 0": torch.from_numpy(np.ascontiguousarray(streams[0]).reshape(-1).copy()).to(dev),
              "16 MiB": torch.from_numpy(np.random.default_rng(31).integers(0, 4, 1 << 24, dtype=np.uint8)).to(dev)}
    for key, t in inputs.items():
        got, ref = lz.chain_candidates(t, k=k), lz.chain_candidates_plain(t, k)
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
            raise Failed(f"chain_candidates ({key}) differs from its plain version")
        del got, ref
        call = lambda: lz.chain_candidates(t, k=k)  # noqa: E731
        res["kernels"][f"chain_candidates ({key})"] = {
            "device_ms": profiler_ms(call, every), "launch_ms": event_ms(chain_alone(t, k)), "call_ms": event_ms(call)}
        for part, kn in (("rows' kernel", rows), ("scans", scans)):
            res["kernels"][f"chain_candidates {part} ({key})"] = {
                "device_ms": profiler_ms(call, kn), "launch_ms": None, "call_ms": None}
        torch.cuda.empty_cache()
    big = inputs["16 MiB"]
    if checksums.adler32_device(big) != checksums.adler32_plain(big):
        raise Failed("adler32 (16 MiB) differs from its plain version")
    call = lambda: checksums.adler32_device(big)  # noqa: E731
    res["kernels"]["adler32 (16 MiB)"] = {
        "device_ms": profiler_ms(call, ("adler_segments_kernel", "adler_combine_kernel", "adler32_kernel")),
        "launch_ms": event_ms(adler_alone(big)), "call_ms": event_ms(call)}
    _, opts, imgs = png_max_case(corpus)
    ct = png_group(dev, opts, imgs)[2]
    for on in (False, True):
        suffix = "_lz77_device" if on else ""
        with env_var("PIXO_TPU_LZ77", "device" if on else None):
            res["stages"][f"png_max_deflate{suffix} (e)"] = wall_stats(
                lambda: _pool(lambda f: png_frame(f, ct, opts, dev), streams), MAX_PNG_RUNS)[0]
            res["stages"][f"png_max_end_to_end{suffix} (e)"] = wall_stats(
                lambda: encode_png_batch_sharded(imgs, opts, device=dev), MAX_PNG_RUNS)[0]


def same_call_comparison(roots) -> int:
    """Runs ``measure_tree`` for each of ``roots`` in turn, each in a process
    of its own (e.g. parent, change, change, parent), and prints each run's
    numbers side by side. Exit code 0 when every run passed."""
    runs = []
    for root in roots:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure", root],
                              capture_output=True, text=True, timeout=900)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            print(f"compare: the run of {root} failed ({proc.returncode})", file=sys.stderr)
            return 1
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
    print("compare, in run order: " + ", ".join(r["tree"] for r in runs))
    def every(part):  # the names of any run, in first-seen order: a tree may lack a kernel
        return list(dict.fromkeys(name for r in runs for name in r[part]))

    for name in every("kernels"):
        for metric in ("device_ms", "launch_ms", "call_ms"):
            print(f"compare kernel {name} {metric}: " + ", ".join(
                fmt(r["kernels"][name][metric]) if name in r["kernels"] else "absent"
                for r in runs) + " ms")
    for stage in every("stages"):
        print(f"compare stage {stage}: " + ", ".join(
            fmt(r["stages"][stage]) if stage in r["stages"] else "absent" for r in runs) + " ms")
    return 0


# Parts of csrc/coeffs.cu that ``coeffs_parts`` takes out, one at a time and
# all together: (name, [(source text, replacement)]). A part's time is what
# the kernel saves without it; the results are wrong, only timed.
COEFF_PARTS = {
    "division": [("__fdiv_rn(v[k], tq[k])", "__fmul_rn(v[k], tq[k])")],
    "quantizer": [("roundf(__fdiv_rn(v[k], tq[k]))", "v[k]")],
    "dct": [("    aan_1d<1>(v);\n", "\n")],
    "colour conversion": [("        const Ycc a = ycc(s + xa), b = ycc(s + xb);",
                           "        const Ycc a = {xa, xa, xa}, b = {xb, xb, xb};")],
    "staging copies": [("        cp_async16(dst, reinterpret_cast<const void*>(g));", "        ;")],
}
COEFF_PARTS["all of them"] = [r for k in ("quantizer", "dct", "colour conversion", "staging copies")
                              for r in COEFF_PARTS[k]]

# Parts of the dct_zz kernel that ``dct_zz_parts`` takes out, by design: the
# coefficient kernel's f32 variant (``coeffs_kernel<MODE, true>``, the
# template's store loop) or the kernel of its own (``dct_zz_kernel<MODE>``,
# one bulk store a tile), so that ``--coeffs-parts dct_zz ../parent .``
# takes both apart in one call. Only ``pixo_dct_zz`` is timed, so an edit
# of a device function both kernels share is harmless. "the loads alone"
# keeps the staging and its waits and skips the rest of each tile. ``DCT_ZZ_GRID`` holds each design's line that sizes the
# grid, which ``dct_zz_parts`` sets to 1 to 5 CTAs an SM.
_AAN_PASS = ("    aan_1d<1>(v);\n", "\n")
_ZZ_CONVERT = ("    convert_words<MODE>(sm + lay.raw + stage * stage_bytes, rowoffs + stage * T::kRows, rp, c, last, luma,\n"
               "                        luma + T::kRows * kPlanePitch);\n", "    (void)last;\n    (void)luma;\n")
_ZZ_GRID_LINE = "    if (raw) per_sm = per_sm < zz_plan_ctas<MODE>() ? per_sm : zz_plan_ctas<MODE>();\n"
_STAGING = ("        cp_async16(dst, reinterpret_cast<const void*>(g));", "        ;")
DCT_ZZ_PARTS = {
    "coefficient kernel's f32 variant": {
        "the stores": [(
            "      dst[k] = src[(k >> kShift) * kPitchWords + (k & ((1 << kShift) - 1))];",
            "      {\n        const int4 x = src[(k >> kShift) * kPitchWords + (k & ((1 << kShift) - 1))];\n"
            "        if (x.x == 0x7FFFFFF1 && x.y == 0x7FFFFFF3) dst[k] = x;\n      }")],
        "the staging copies": [_STAGING],
        "the conversion": [(
            "    convert_tile<MODE>(sm + lay.raw + buf * T::kRows * rp, rowoffs + buf * T::kRows, rp, c, last,\n"
            "                       luma, chroma);\n", "    (void)last;\n")],
        "the AAN passes": [_AAN_PASS],
        "the loads alone": [("    const int64_t x0 = p.mx0 * T::kMcuW;\n",
                             "    if (n_tiles) continue;\n    const int64_t x0 = p.mx0 * T::kMcuW;\n")],
    },
    "kernel of its own": {
        "the stores' bytes (a copy of 16 bytes a tile)": [(
            "      bulk_store(out + first_block * 64, ot, p.n_mcus * T::kBpm * 64 * 4);",
            "      bulk_store(out + first_block * 64, ot, 16);")],
        "the staging copies": [("    if (mid_hi > mid_lo) {\n", "    if (false) {\n")],
        "the conversion": [_ZZ_CONVERT],
        "the AAN passes": [_AAN_PASS],
        "the loads alone": [_ZZ_CONVERT, ("    // the passes of tile i\n", "    if (n_tiles == 0) {\n"),
                            ("    // the conversion of tile i + 1\n", "    }\n")],
        # the levers one by one; each keeps the result bit-equal
        "the proxy fence": [('    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");  // the tile, to the bulk copy\n',
                             "")],
        "three input stages": [("constexpr int kZzStages = 2;", "constexpr int kZzStages = 3;")],
        "the aligned words (every pixel by two loads)": [(
            "    if (c == 3 && (off & 3) == 0 && x + 3 <= last) {", "    if (false) {")],
    },
}
DCT_ZZ_GRID = {"coefficient kernel's f32 variant": ("    resident[dev][c] = sms * per_sm;\n",
                                                     "    resident[dev][c] = sms * {k};\n"),
               "kernel of its own": (_ZZ_GRID_LINE, "    if (raw) per_sm = {k};\n")}
# the parts of a design that leave its result bit-equal, held to the plain version
DCT_ZZ_EXACT = ("three input stages", "the aligned words (every pixel by two loads)")


def coeffs_parts(card: str) -> int:
    """Where the coefficient kernel's time goes: builds csrc/coeffs.cu as it
    is and with each of ``COEFF_PARTS`` taken out, all at once, and times
    each at 16x512x512 q85 4:2:0 (CUDA events over 50 launches of the C
    function, median of 5), the full build also held to the plain version."""
    import ctypes

    import torch

    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.utils.build import BUILD_DIR, build_shared_library

    src = open(os.path.join(kernels.CSRC, "coeffs.cu")).read()
    variants = {"as it is": src}
    for name, edits in COEFF_PARTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise Failed(f"coeffs parts: {name!r} no longer matches csrc/coeffs.cu")
            text = text.replace(old, new)
        variants[name] = text
    os.makedirs(BUILD_DIR, exist_ok=True)

    def build(i):
        key, text = list(variants.items())[i]
        path = os.path.join(BUILD_DIR, f"coeffs_part_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        nvcc = kernels._nvcc()
        return key, build_shared_library(f"coeffs_part_{i}", [nvcc, *kernels.NVCC_FLAGS, *VARIANT_FLAGS],
                                         [path, os.path.join(kernels.CSRC, "aan.cuh")], timeout=900,
                                         link=[nvcc, *kernels._ARCH, "-shared"]).path

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(variants)) as ex:
        libs = dict(ex.map(build, range(len(variants))))
    dev = torch.device("cuda")
    quant = QuantizationTables(QUALITY)
    lum, chrom = kernels._table(quant.luminance_table), kernels._table(quant.chrominance_table)
    grad = torch.from_numpy(gradient_batch(BATCH, SIZE)).to(dev)
    ref = kernels.coeffs_plain(grad, lum, chrom, "420")
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for key, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.pixo_coeffs.argtypes = [ctypes.c_void_p, *[ctypes.c_int64] * 3, *[ctypes.c_int32] * 2,
                                    *[ctypes.c_void_p] * 4]
        out = torch.empty_like(ref)
        args = (grad.data_ptr(), BATCH, SIZE, SIZE, 3, 2, lum.ctypes.data, chrom.ctypes.data,
                out.data_ptr(), stream)
        if lib.pixo_coeffs(*args):
            raise Failed(f"coeffs parts: the launch without {key!r} failed")
        times[key] = event_ms(lambda: lib.pixo_coeffs(*args), calls=50)
        if key == "as it is" and not torch.equal(out, ref):
            raise Failed("coeffs parts: the kernel as it is differs from its plain version")
    full = times.pop("as it is")
    print(f"coeffs parts 16x512x512 q85 4:2:0: as it is {full * 1e3:.1f} us; without "
          + "; ".join(f"{k} {t * 1e3:.1f} us (saves {(full - t) * 1e3:.1f})" for k, t in times.items())
          + f" [{card}]")
    return 0


def dct_zz_parts(card: str, roots) -> int:
    """Where the ``dct_zz`` kernel's time goes: for the csrc/coeffs.cu of each
    checkout in ``roots`` (this one where none is named), its launch (the C
    function ``pixo_dct_zz``) at the max cells (m1) and (m2) as it is, with
    each of its design's ``DCT_ZZ_PARTS`` taken out, and on grids of 1 to 5
    CTAs an SM (all built at once), as the profiler's device time and the
    launch alone (CUDA events). The kernel as it is and on every grid must
    equal the plain version bit for bit. Exit code 1 on a difference or a
    failed launch."""
    import ctypes

    import torch

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.blockify import num_blocks

    dev = torch.device("cuda")
    cells = {key: torch.from_numpy(imgs).to(dev)
             for key, (_, imgs) in trellis_cells(gradient_batch(BATCH, SIZE), corpus_batch()).items()}
    want = {key: kernels.dct_zz_plain(x, "420") for key, x in cells.items()}
    bound = {key: kernel_bound("dct_zz", b=x.shape[0], h=SIZE, w=SIZE, c=3, mode="420")[0]
             for key, x in cells.items()}
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    stream = torch.cuda.current_stream().cuda_stream
    fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
    for idx, root in enumerate(roots or [os.path.dirname(os.path.abspath(__file__))]):
        source = os.path.join(os.path.abspath(root), "pixo_tpu_torch", "csrc", "coeffs.cu")
        text = open(source).read()
        design = next((d for d, parts in DCT_ZZ_PARTS.items()
                       if all(old in text for edits in parts.values() for old, _ in edits)
                       and DCT_ZZ_GRID[d][0] in text), None)
        if design is None:
            print(f"dct_zz parts: {source} is of no design that DCT_ZZ_PARTS knows", file=sys.stderr)
            return 1
        line, sized = DCT_ZZ_GRID[design]
        grids = {f"a grid of {k} CTAs an SM": [(line, sized.format(k=k))] for k in range(1, 6)}
        libs = variant_libs(source, {**DCT_ZZ_PARTS[design], **grids}, f"dct_zz_part_{idx}")
        print(f"dct_zz parts of {root}: the {design} design; bound (m1) {bound['m1']:.4f} ms, "
              f"(m2) {bound['m2']:.4f} ms [{card}]")
        failed = False
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            lib.pixo_dct_zz.restype = ctypes.c_int
            lib.pixo_dct_zz.argtypes = [vp, i64, i64, i64, i32, i32, vp, vp]
            line = []
            for key, x in cells.items():
                b = x.shape[0]
                out = torch.empty((b, num_blocks(SIZE, SIZE, "420"), 64), dtype=torch.float32, device=dev)
                alone = lambda: lib.pixo_dct_zz(x.data_ptr(), b, SIZE, SIZE, 3, 2,  # noqa: E731
                                                out.data_ptr(), stream)
                rc = alone()
                if rc:
                    print(f"dct_zz parts: ({key}) of {root} {name}: the launch failed: "
                          f"{kernels.load().pixo_cuda_error_string(rc).decode()}", file=sys.stderr)
                    failed = True
                    break
                torch.cuda.synchronize()
                if (name == "as it is" or name in grids or name in DCT_ZZ_EXACT) and not torch.equal(
                        out.view(torch.int32), want[key].view(torch.int32)):
                    print(f"dct_zz parts: ({key}) of {root} {name} differs from the plain version",
                          file=sys.stderr)
                    return 1
                device = profiler_ms(alone, ("coeffs_kernel", "dct_zz_kernel"))
                share = "" if device is None else f" ({bound[key] / device:.1%} of the bound)"
                line.append(f"({key}) device {fmt(device)}{share}, launch alone {fmt(event_ms(alone))}")
            print(f"dct_zz parts of {root}: {name}: " + "; ".join(line) + f" [{card}]")
    return int(failed)


def pair_collisions(raw, bpp: int) -> dict:
    """How mode 7's marks meet in shared memory on rows ``raw`` [B, H, RB]:
    over the strip kernel's mark instructions (lane l of a step takes word
    32s + l of a candidate, instruction j the pair 4k + j of word k), the
    mean of the most lanes that carry one key, and of the most that hit one
    bitmap word under the kernel's layout (word key >> 5) and with the
    bank from the second byte (word key & 2047, one of ``BIGRAM_VARIANTS``),
    before and after the merge that skips a pair whose key equals the
    pair's before it (but for lane 0's first pair of a step). Counted on
    the host from the rows alone."""
    import numpy as np

    from pixo_tpu_torch.ops import png_filters

    cands = png_filters._candidates(raw.cpu(), bpp).numpy().astype(np.int64)
    keys = cands[..., :-1] * 256 + cands[..., 1:]
    n = keys.shape[-1]
    words = (n + 3) // 4
    slots = -np.arange(1, 1 + ((words + 31) // 32) * 128)  # padding and skipped pairs: a key of its own each
    padded = np.broadcast_to(slots, keys.shape[:-1] + slots.shape).copy()
    padded[..., :n] = keys
    skip = np.zeros(padded.shape, bool)
    skip[..., 1:n] = keys[..., 1:] == keys[..., :-1]
    skip[..., ::128] = False  # lane 0's first pair of a step always marks
    runs = np.where(skip, np.broadcast_to(slots, padded.shape), padded)  # pairs the merge skips
    out = {}
    for merged, v in (("", padded), (" after the merge", runs)):
        inst = np.moveaxis(v.reshape(*keys.shape[:-1], -1, 32, 4), -1, -2).reshape(-1, 32)

        def most_alike(v):  # the longest run of equal values in each sorted row
            v = np.sort(v, axis=1)
            run = best = np.zeros(len(v))
            for i in range(1, 32):
                run = (run + 1) * (v[:, i] == v[:, i - 1])
                best = np.maximum(best, run)
            return float((best + 1).mean())

        out[f"one key{merged}"] = most_alike(inst)
        out[f"one word (key >> 5){merged}"] = most_alike(np.where(inst >= 0, inst >> 5, inst))
        out[f"one word (key & 2047){merged}"] = most_alike(np.where(inst >= 0, inst & 2047, inst))
    return out


# Parts of mode 7 in csrc/filter_bank.cu (the strip kernel's count_pairs)
# that ``filter_parts`` takes out, one at a time: (name, [(source text,
# replacement)]). A part's time is what the kernel saves without it; the
# results are wrong, only timed. The candidate computation leaves the raw
# word (two loads) for every candidate.
BIGRAM_PARTS = {
    "the candidate computation": [
        ("    uint32_t x, a, b, c;\n    load_words<1 << F, PREV, kEdge>(xs, as, bs, cs, min(k, last), r.bpp, x, a, b, c);\n"
         "    return filter_word<F>(x, a, b, c);", "    return xs[min(k, last)];")],
    "the merge": [("      const bool run = key[j] == (j > 0 ? key[j - 1] : left) && (j > 0 || lane > 0);",
                   "      const bool run = false;")],
    "the marks": [("(bit & ~atomicOr(map + (on ? pair_word(key[j]) : spare_word(lane)), bit))",
                   "(bit & ~(on ? pair_word(key[j]) : spare_word(lane)))")],
    "the clearing": [("  for (int i = lane; i < kBigramBytes / 16; i += 32) map4[i] = make_uint4(0u, 0u, 0u, 0u);\n",
                      "  (void)map4;\n")],
}
# Other designs of the same parts, each built and held to the plain version.
BIGRAM_VARIANTS = {
    "the bank from the second byte (word key & 2047, bit key >> 11)": [
        ("uint32_t pair_word(uint32_t key) { return key >> 5; }", "uint32_t pair_word(uint32_t key) { return key & 2047u; }"),
        ("uint32_t pair_bit(uint32_t key) { return __funnelshift_l(0u, 1u, key); }",
         "uint32_t pair_bit(uint32_t key) { return 1u << (key >> 11); }"),
        ("uint32_t spare_word(int lane) { return 1024u + lane; }", "uint32_t spare_word(int lane) { return 128u + lane; }")],
    "two steps an iteration": [("#pragma unroll 1\n  for (; k0 + 32 <= (pairs >> 2); k0 += 32)",
                                "#pragma unroll 2\n  for (; k0 + 32 <= (pairs >> 2); k0 += 32)")],
    "a test of the bit before each mark": [
        ("      const bool on = (kWhole || j < m) && !run;",
         "      const bool on = (kWhole || j < m) && !run && !(map[pair_word(key[j])] & pair_bit(key[j]));")],
    "a branch around each mark": [
        ("      n += (bit & ~atomicOr(map + (on ? pair_word(key[j]) : spare_word(lane)), bit)) ? 1 : 0;",
         "      if (on) n += (bit & ~atomicOr(map + pair_word(key[j]), bit)) ? 1 : 0;")],
}
SM_SHARED_BYTES = 233_472  # an SM's shared memory on the H100 (228 KB), 1 KB of it reserved a CTA


def bigram_strip_smem(strip: int, rb: int) -> int:
    """csrc/filter_bank.cu's strip_smem under mode 7: the strip's rows, its
    output rows and a bitmap a row."""
    from pixo_tpu_torch.ops import kernels

    return (kernels._filter_region((strip + 1) * rb) + kernels._filter_region(strip * (rb + 1))
            + strip * kernels.FILTER_BIGRAM_BYTES)


def filter_parts(card: str) -> int:
    """Where the fused filter kernel's time goes: its device time (the
    profiler's) on the rows of PNG batches (a) and (b) under each strategy.
    None is the kernel's skeleton (the copy in, a sweep that moves the words,
    the copy out); a fixed filter adds that filter's arithmetic to the one
    sweep; the adaptive rules add their scoring sweeps. Bigrams (mode 7)
    adds its five counting sweeps; it is timed also on noise rows of the
    same shape, whose pairs rarely meet in one bitmap word
    (``pair_collisions`` counts how often they do), and, launched alone
    from libraries of csrc/filter_bank.cu built at once, as it is, with each
    of ``BIGRAM_PARTS`` taken out and as each of ``BIGRAM_VARIANTS``, and as
    it is on strips of 1 to 8 rows (its plan's strip is 8 at these rows;
    fewer rows a strip fit more CTAs an SM). (a)'s rows are (e)'s device
    group. Each result as it is or of a variant is first held against the
    plain version."""
    import ctypes

    import numpy as np
    import torch

    from pixo_tpu_torch import FilterStrategy
    from pixo_tpu_torch.ops import kernels, png_filters

    libs = variant_libs("filter_bank.cu", {**BIGRAM_PARTS, **BIGRAM_VARIANTS}, "bigram_part")
    log = kernels.build_log.splitlines()
    for i, line in enumerate(log):
        if "entry function" in line and "filter_rows_strip_kernel" in line:
            print(f"ptxas: {line.strip()} " + " ".join(x.strip() for x in log[i + 1:i + 4]
                                                        if "registers" in x or "spill" in x))
    dev = torch.device("cuda")
    grad = gradient_batch(BATCH, SIZE)
    stream = torch.cuda.current_stream().cuda_stream
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    fmt = lambda ms: "not measured" if ms is None else f"{ms * 1e3:.1f} us"  # noqa: E731
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.pixo_filter_rows.restype = ctypes.c_int
        lib.pixo_filter_rows.argtypes = [vp, i64, i64, i64, i32, i32, i32, i32, i32, vp, vp]
        loaded[name] = lib
    for key, (label, opts, imgs) in png_cases(corpus_batch(), grad).items():
        _, raw, _, kw = png_group(dev, opts, imgs)
        noise = torch.from_numpy(np.random.default_rng(5).integers(0, 256, tuple(raw.shape), dtype=np.uint8)).to(dev)
        times = []
        for strategy, rows, name in [(s, raw, s.name) for s in FilterStrategy] + [
                (FilterStrategy.BIGRAMS, noise, "BIGRAMS on noise rows")]:
            kws = dict(kw, strategy=strategy)
            if not torch.equal(kernels.filter_rows(rows, **kws), png_filters.filter_rows_plain(rows, **kws)):
                raise Failed(f"filter parts: {name} differs from its plain version")
            times.append(f"{name} {fmt(profiler_ms(lambda: kernels.filter_rows(rows, **kws), 'filter_rows_'))}")
        b, h, rb = raw.shape
        plan = kernels.filter_rows_plan(h, rb, False, True)
        print(f"filter parts ({key}) {b}x{h}x{rb}, strips of {kernels.filter_rows_plan(h, rb, False)} "
              f"(Bigrams {plan}): {'; '.join(times)} [{card}]")
        for rows, name in ((raw, "the rows"), (noise, "noise rows")):
            kws = dict(kw, strategy=FilterStrategy.BIGRAMS)
            want = kernels.filter_rows(rows, **kws)
            out = torch.empty_like(want)

            def alone(lib, strip):
                return lambda: lib.pixo_filter_rows(rows.data_ptr(), b, h, rb, kw["bpp"], 7, 0, 0, strip,
                                                    out.data_ptr(), stream)

            parts = {}
            for part, lib in loaded.items():
                call = alone(lib, plan)
                rc = call()
                if rc:
                    raise Failed(f"filter parts: Bigrams without or as {part!r} failed to launch: "
                                 f"{kernels.load().pixo_cuda_error_string(rc).decode()}")
                torch.cuda.synchronize()
                if part not in BIGRAM_PARTS and not torch.equal(out, want):
                    raise Failed(f"filter parts: Bigrams {part!r} differs from the plain version")
                parts[part] = profiler_ms(call, "filter_rows_strip_kernel")
            base = parts.pop("as it is")
            print(f"filter parts ({key}) Bigrams on {name}, launched alone: as it is {fmt(base)}; without "
                  + "; ".join(f"{p} {fmt(parts[p])}" for p in BIGRAM_PARTS) + "; as "
                  + "; ".join(f"{p} {fmt(parts[p])}" for p in BIGRAM_VARIANTS) + f" [{card}]")
            strips = []
            for strip in range(1, kernels.FILTER_STRIP_ROWS + 1):
                smem = bigram_strip_smem(strip, rb)
                call = alone(loaded["as it is"], strip)
                if smem > kernels.FILTER_SMEM_BUDGET or call():
                    continue
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise Failed(f"filter parts: Bigrams on strips of {strip} differs from the plain version")
                ctas = min(SM_SHARED_BYTES // (smem + 1024), 2048 // (32 * strip), 32)
                strips.append(f"{strip} rows ({smem} B, {ctas} CTAs, {ctas * strip} warps an SM) "
                              f"{fmt(profiler_ms(call, 'filter_rows_strip_kernel'))}")
            print(f"filter parts ({key}) Bigrams on {name} by strip: {'; '.join(strips)} [{card}]")
            print(f"filter parts ({key}) Bigrams' marks on {name}, the most lanes of an instruction in the "
                  "mean: " + ", ".join(f"on {k} {v:.2f}" for k, v in pair_collisions(rows, kw["bpp"]).items()))
    return 0


# Parts of csrc/resize.cu that ``resize_parts`` takes out, one at a time:
# (name, [(source text, replacement)]). A part's time is what the pass saves
# without it; the results are wrong, only timed.
RESIZE_PARTS = {
    "the staging copies": [("        cp_async16(d, a);", "        ;")],
    "the slot layout": [("          for (int c = 0; c < C; ++c) word |= static_cast<uint32_t>(px[c]) << (8 * c);",
                         "          word = static_cast<uint32_t>(px - raw);")],
    "the taps' arithmetic": [
        ("          for (int u = 0; u < 4; ++u) tap_slot<C>(acc, a[u], b[u], wv[u]);",
         "          for (int u = 0; u < 4; ++u) acc[0][0] += wv[u] + __uint_as_float("
         "a[u].x ^ a[u].y ^ a[u].z ^ a[u].w ^ b[u].x ^ b[u].y ^ b[u].z ^ b[u].w);")],
    "the half conversion": [
        ("  return __low2float(*reinterpret_cast<const __half2*>(&pair));", "  return __uint_as_float(pair);"),
        ("  return __high2float(*reinterpret_cast<const __half2*>(&pair));",
         "  return __uint_as_float(pair >> 16);")],
    "the slot reads": [("            a[u] = pa[at];\n            b[u] = pb[at];",
                        "            a[u] = make_uint4(at, i, u, j);\n            b[u] = a[u];")],
    "vertical: the weight loads": [("    const float4 w4 = __ldg(wr + i / 4);",
                                    "    const float4 w4 = make_float4(i, i + 1, i + 2, i + 3);")],
    "vertical: the source loads": [
        ("      const uint4 g = __ldg(reinterpret_cast<const uint4*>(p));",
         "      const uint4 g = make_uint4(static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p)), 1, 2, 3);"),
        ("      w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));",
         "      w[0] = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));")],
    "vertical: the taps' arithmetic": [
        ("        acc[4 * m] = tap(acc[4 * m], byte_f32<0>(word), wv[u]);\n        if (V >= 4) {",
         "        acc[4 * m] += wv[u] + __uint_as_float(word);\n        if (false) {")],
    "vertical: the byte conversion": [
        ("  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | B)), 8388608.0f);",
         "  return __uint_as_float(word << (8 * B));")],
}


# Parts of the dither kernel (csrc/quantize.cu) that ``dither_parts`` takes
# out, one at a time and all together: (name, [(source text, replacement)]).
# A part's time is what the kernel saves without it; the results are wrong,
# only timed.
DITHER_PARTS = {
    "the LUT load": [("int idx = __ldg(tab + (((a[0] >> 2) << 12) | ((a[1] >> 2) << 6) | (a[2] >> 2)));",
                      "int idx = (a[0] ^ a[1] ^ a[2]) & 1;")],
    "the ring waits": [
        ("      while ((v = ring_in.get(rs)) == kRingFree) {\n      }", "      v = ring_in.get(rs);"),
        ("        while ((above = ring_in.get(rs)) == kRingFree) {\n        }", "        above = ring_in.get(rs);"),
        ("          while (next == kRingFree) next = ring_in.get(rs);\n", ""),
        ("            while (ring_out.get(far) != kRingFree) {\n            }", "            (void)far;")],
    "the pixel loads": [
        ("  if (kWords) return __ldg(reinterpret_cast<const uint32_t*>(q));",
         "  if (kWords) return 0xFF000000u | (x & 255) * 0x010101u;"),
        ("  return __ldg(q) | (__ldg(q + 1) << 8) | (__ldg(q + 2) << 16) | "
         "(static_cast<uint32_t>(__ldg(q + 3)) << 24);",
         "  return 0xFF000000u | (x & 255) * 0x010101u;")],
}
DITHER_PARTS["all three"] = [r for edits in list(DITHER_PARTS.values()) for r in edits]


# A variant library is loaded beside the kernel library and the other
# variants: without this, g++ makes each static variable of a template or
# inline function (a launcher's cache of CTA slots) a GNU unique symbol, one
# object in the whole process, so every variant would take the first one's
# cached grid (and skip its own shared-memory attribute).
VARIANT_FLAGS = ("-Xcompiler", "-fno-gnu-unique")


def variant_libs(source: str, parts: dict, prefix: str, common=()) -> dict:
    """Builds csrc/``source`` (or the file at the absolute path ``source``)
    as it is and with each of ``parts`` taken out, one library each, all at
    once, beside the kernel library and the host library: {part name or "as
    it is": library path}. ``common``: edits made to every one of them, "as
    it is" too (leaving out what none of them times)."""
    from pixo_tpu_torch import native
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.utils.build import BUILD_DIR, build_shared_library

    src = open(os.path.join(kernels.CSRC, source)).read()
    for old, new in common:
        if old not in src:
            raise Failed(f"{prefix}: a common edit no longer matches csrc/{source}")
        src = src.replace(old, new)
    variants = {"as it is": src}
    for name, edits in parts.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise Failed(f"{prefix}: {name!r} no longer matches csrc/{source}")
            text = text.replace(old, new)
        variants[name] = text
    os.makedirs(BUILD_DIR, exist_ok=True)

    def build(i):
        key, text = list(variants.items())[i]
        path = os.path.join(BUILD_DIR, f"{prefix}_{i}.cu")
        with open(path, "w") as f:
            f.write(text)
        nvcc = kernels._nvcc()
        return key, build_shared_library(f"{prefix}_{i}", [nvcc, *kernels.NVCC_FLAGS, *VARIANT_FLAGS], [path],
                                         timeout=900, link=[nvcc, *kernels._ARCH, "-shared"]).path

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(variants) + 2) as ex:
        loads = [ex.submit(kernels.load), ex.submit(native.load)]
        libs = dict(ex.map(build, range(len(variants))))
        for done in loads:
            done.result()
    return libs


def dither_parts(card: str) -> int:
    """The dither kernel alone at (q1) and (q2): the profiler's device time
    of its launch (the C function) as it is and with each of
    ``DITHER_PARTS`` taken out (all built at once), each as ns and SM clocks
    a step of the plan's critical path, the clock read under load. The
    kernel as it is must equal the wrapper's result, which phase 2 holds to
    the plain version. Exit code 1 on a difference or a failed launch."""
    import ctypes

    import numpy as np
    import torch

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.png import quantize as q

    libs = variant_libs("quantize.cu", DITHER_PARTS, "dither_part")
    dev = torch.device("cuda")
    grad, corpus = gradient_batch(BATCH, SIZE), corpus_batch()
    stream = torch.cuda.current_stream().cuda_stream
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    for key, (label, opts, imgs) in lossy_cases(corpus, grad).items():
        batch = q.quantize_host_stage(imgs, min(opts.quantization.max_colors, 256), True)
        pal, lut, idx = q.quantize_device_stage(batch, True, dev)
        rgba = torch.from_numpy(batch.rgba).to(dev)
        kv = torch.from_numpy(np.ascontiguousarray(batch.k)).to(dev)
        b, h, w = rgba.shape[:3]
        plan = kernels.dither_plan(h, w)
        out = torch.empty((b, h, w), dtype=torch.uint8, device=dev)
        times, mhz = {}, None
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            lib.pixo_dither_fs.restype = ctypes.c_int
            lib.pixo_dither_fs.argtypes = [vp, i64, i64, i64, vp, i32, vp, vp, i32, i32, vp, vp, vp]

            def alone(lib=lib):
                return lib.pixo_dither_fs(rgba.data_ptr(), b, h, w, pal.data_ptr(), pal.shape[1],
                                          kv.data_ptr(), lut.data_ptr(), plan.warps, plan.ring_slots,
                                          None, out.data_ptr(), stream)

            rc = alone()
            if rc:
                err = kernels.load().pixo_cuda_error_string(rc).decode()
                print(f"dither parts: ({key}), the launch without {name!r} failed: {err}", file=sys.stderr)
                return 1
            if name == "as it is":
                torch.cuda.synchronize()
                if not torch.equal(out, idx):
                    print(f"dither parts: ({key}) differs from the wrapper's result", file=sys.stderr)
                    return 1
                mhz = busy_sm_mhz(alone)
            times[name] = profiler_ms(alone, "dither_fs_")
        base = times.pop("as it is")
        print(f"dither parts ({key}) {label} {b}x{h}x{w}, {plan.warps} warps, {plan.steps} steps: "
              f"as it is {base:.4f} ms ({step_line(base, plan.steps, mhz)}); without "
              + "; ".join(f"{k} {t:.4f} ms ({step_line(t, plan.steps, mhz)})" for k, t in times.items())
              + f" [{card}]")
    return 0


# Parts of the unfilter kernel (csrc/unfilter.cu) that ``unfilter_parts``
# takes out, one at a time, and the designs it was measured against
# ("(design) ..."): (name, [(source text, replacement)]). A part's time is
# what the kernel saves without it; the results are wrong, only timed.
# Without the ring's hand-off a warp neither waits for the warp before it
# nor fills the ring of the one after; without the hand-off's waits it
# still loads and fills the slots.
_UNFILTER_ROOM = ("        while (static_cast<int>(ring.read_room() - (out_base + static_cast<uint32_t>(need))) < 0) {\n"
                  "        }\n", "")  # the writer's wait for room
_UNFILTER_ONE_CTA = ("  const int64_t smem = unfilter_smem<BPP>(warps, ring_slots, ring != nullptr);",
                     "  const int64_t smem = unfilter_smem<BPP>(warps, ring_slots, ring != nullptr) + 120 * 1024;")
UNFILTER_PARTS = {
    "the shuffle": [("            recv = __shfl_up_sync(0xFFFFFFFFu, w, 1);", "            recv = w;")],
    "the ring's hand-off": [
        ("        if (reads) take(ring, ring_slots, in_base + static_cast<uint32_t>(s0 + t0), pixels - s0 - t0, above);\n",
         ""),
        ("          if (on && lane == 31 && writes) ring.put(ring_slots, out_base + x, v);\n", ""),
        _UNFILTER_ROOM],
    "the hand-off's waits": [("    if (ok) break;", "    break;"), _UNFILTER_ROOM],
    "the row's copies": [("      in.send_through(s0 + (kAhead + 1) * kChunk, lane);\n", ""),
                         ("    for (int c = 0; c < kAhead; c++) in.send_through((c + 1) * kChunk, lane);\n", "")],
    "the pixel reads": [("      for (int i = 0; i < kChunk; i++) raws[i] = in.pixel(qin + i * BPP);",
                         "      for (int i = 0; i < kChunk; i++) raws[i] = static_cast<P>(qin + i);")],
    "the predictor": [("            w = step4(m, raw, own, b, up);", "            w = raw ^ own ^ b ^ up;")],
    "the stores": [("          if (on) wr.put(stage + i * BPP, v);\n", ""),
                   ("      if (row_ok) wr.flush(s0 - lane, pixels);\n", "")],
    "(design) chunks of 32 steps": [("constexpr int kChunk = 16; ", "constexpr int kChunk = 32; ")],
    "(design) a take of 16 steps": [("constexpr int kTake = 8; ", "constexpr int kTake = 16;")],
    "(design) a take of 4 steps": [("constexpr int kTake = 8; ", "constexpr int kTake = 4; ")],
    "(design) one CTA an SM": [_UNFILTER_ONE_CTA],
    "(design) the predictor a byte at a time": [("  return add4(raw, predict4(m, a, b, c));", """  uint32_t r = 0;
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int aj = (a >> j) & 255, bj = (b >> j) & 255, cj = (c >> j) & 255;
    const int p = aj + bj - cj, pa = abs(p - aj), pb = abs(p - bj), pc = abs(p - cj);
    const int paeth = (pa <= pb) & (pa <= pc) ? aj : pb <= pc ? bj : cj;
    const int pred = (aj & m.sub) | (bj & m.up) | (((aj + bj) >> 1) & m.avg) | (paeth & m.paeth);
    r |= static_cast<uint32_t>((((raw >> j) & 255) + pred) & 255) << j;
  }
  return r;""")],
}
UNFILTER_SPLITS = (1, 2, 4, 8)  # CTAs an image that ``unfilter_parts`` times (1: one SM, 16 warps)
# Every variant keeps only the bpp 3 instances (PNG (a)'s): the C entry's
# other cases go, which cuts each build to an eighth.
UNFILTER_BPP3_ONLY = [(f"    case {k}: return static_cast<int>(launch_unfilter<{k}>(rows, filters, b, h, w, ctas, warps, "
                       f"ring_slots, g, out, s));\n", "") for k in (1, 2, 4, 5, 6, 7)] + [
    ("    default: return static_cast<int>(launch_unfilter<8>(rows, filters, b, h, w, ctas, warps, ring_slots, g, "
     "out, s));", "    default: return static_cast<int>(cudaErrorInvalidValue);")]


def unfilter_parts(card: str) -> int:
    """The unfilter kernel alone at PNG (a)'s device group (``time_unfilter``'s
    rows): the profiler's device time of its launch (the C function) under
    ``unfilter_plan``'s split as it is, without each of ``UNFILTER_PARTS``
    and as each design it was measured against (all built at once, with
    only the bpp 3 instances); then as it is and without the hand-off's
    waits on the first 32 to 512 rows (a group more, a hand-off more); then
    as it is on one SM an image and on each cluster split of
    ``UNFILTER_SPLITS`` (the image's 16 warps over that many CTAs), with the
    global rings and with rings of 512 slots. Each time as ns and SM clocks a
    step of the function's critical path (``unfilter_steps``), the clock
    read under load, and as the share of its two bounds (the bytes; the
    path at ``UNFILTER_STEP_CLOCKS`` a step), printed as it is measured. The
    kernel as it is must equal the wrapper's result, which phase 2 holds to
    the plain version and the host library, under every split. Exit code 1
    on a difference or a failed launch."""
    import ctypes

    import torch

    from pixo_tpu_torch import FilterStrategy
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.png_unfilter import unfilter_device_batch, unfilter_plan

    libs = variant_libs("unfilter.cu", UNFILTER_PARTS, "unfilter_part", UNFILTER_BPP3_ONLY)
    dev = torch.device("cuda")
    rows, ids = filtered_rows(dev, corpus_batch()[:8], FilterStrategy.ADAPTIVE)
    b, h, rb = rows.shape
    want = unfilter_device_batch(rows, ids, bpp=3, device=dev)
    out = torch.empty_like(rows)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    steps = unfilter_steps(h, rb, 3)
    floor = steps * UNFILTER_STEP_CLOCKS / 1.98e9 * 1e3
    byte_ms = kernel_bound("unfilter", b=b, h=h, rb=rb)[0]
    plan = unfilter_plan(b, h, rb, 3, kernels._sm_count(dev))
    times, mhz, loaded = {}, None, {}
    fmt = lambda t: ("not measured" if t is None  # noqa: E731
                     else f"{t:.4f} ms ({step_line(t, steps, mhz)}, {100 * floor / t:.2f}% of the path's bound, "
                          f"{100 * byte_ms / t:.2f}% of the bytes')")

    def run(name, launch):
        rc = launch()
        if rc:
            print(f"unfilter parts: {name} failed: {kernels.load().pixo_cuda_error_string(rc).decode()}",
                  file=sys.stderr)
            return False
        return True

    for name, path in libs.items():
        lib = loaded[name] = ctypes.CDLL(path)
        lib.pixo_unfilter.restype = ctypes.c_int
        lib.pixo_unfilter.argtypes = [vp, vp, i64, i64, i64, i32, i32, i32, i32, vp, vp, vp]
        alone = unfilter_launcher(lib, rows, ids, 3, plan, out)
        if not run(f"the launch without {name!r}", alone):
            return 1
        if name == "as it is":
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                print("unfilter parts: the kernel as it is differs from the wrapper's result", file=sys.stderr)
                return 1
            mhz = busy_sm_mhz(alone, calls=200)
        times[name] = profiler_ms(alone, "unfilter_kernel")
        print(f"unfilter parts at PNG (a)'s device group {b}x{h}x{rb}, bpp 3, {steps} steps of the critical "
              f"path, bound {floor:.4f} ms, bytes {byte_ms:.4f} ms; plan {tuple(plan)}: "
              + ("as it is" if name == "as it is" else f"without {name}") + f" {fmt(times[name])} [{card}]")
    for hh in (32, 64, 128, 256, 512):  # a group more: a hand-off more
        part = rows[:, :hh].contiguous(), ids[:, :hh].contiguous()
        split = unfilter_plan(b, hh, rb, 3, kernels._sm_count(dev))
        line = []
        for name in ("as it is", "the hand-off's waits"):
            sub = torch.empty_like(part[0])
            line.append(fmt(profiler_ms(unfilter_launcher(loaded[name], *part, 3, split, sub), "unfilter_kernel")))
        print(f"unfilter parts height {hh} ({tuple(split)[:2]}): as it is {line[0]}; without the waits {line[1]}")
    forced = [(f"{ctas} CTAs an image", dict(ctas=ctas, warps=16 if ctas == 1 else None)) for ctas in UNFILTER_SPLITS]
    forced.append((f"global rings, {plan.ctas} CTAs an image", dict(ctas=plan.ctas, ring="global")))
    forced.append(("rings of 512 slots", dict(ctas=plan.ctas)))
    for name, kw in forced:
        split = unfilter_plan(b, h, rb, 3, **kw)
        if name == "rings of 512 slots":
            split = split._replace(ring_slots=512, smem=None)
        alone = unfilter_launcher(loaded["as it is"], rows, ids, 3, split, out)
        out.zero_()
        if not run(name, alone):
            return 1
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            print(f"unfilter parts: {name} {tuple(split)} differs from the wrapper's result", file=sys.stderr)
            return 1
        print(f"unfilter parts split: {name}, {split.ctas} x {split.warps} warps, {split.ring} rings of "
              f"{split.ring_slots} slots: {fmt(profiler_ms(alone, 'unfilter_kernel'))} [{card}]")
    return 0


# Parts of the k-means kernel (csrc/quantize.cu) that ``kmeans_parts`` takes
# out, one at a time: (name, [(source text, replacement)]). A part's time is
# what the kernel saves without it; the results are wrong, only timed.
KMEANS_PARTS = {
    "the argmin": [("    const int idx = nearest(r, g, bl, al, s_pal, kv);",
                    "    const int idx = min(r, kv - 1);")],
    "the atomics": [("    add_sums<kNarrow>(sums, idx, r, g, bl, al, w);",
                     "    if (w == 0xFFFFFFFFu) sums[idx] = r;")],
    "the update": [("  if (!s_last) return;", "  return;")],
    "the second launch": [("  for (int it = 0; it < kKmeansIterations; ++it) {",
                           "  for (int it = 0; it < 1; ++it) {")],
}


def kmeans_parts(card: str) -> int:
    """The k-means kernel alone at (q1) and (q2): the profiler's device time
    of a call's launches (the C function; two launches, one an iteration)
    as it is and with each of ``KMEANS_PARTS`` taken out (all built at
    once), beside the bound and the plan's chunks. The kernel as it is must
    equal the wrapper's result, which phase 2 holds to the plain version.
    Exit code 1 on a difference or a failed launch."""
    import ctypes

    import numpy as np
    import torch

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.png import quantize as q

    libs = variant_libs("quantize.cu", KMEANS_PARTS, "kmeans_part")
    dev = torch.device("cuda")
    grad, corpus = gradient_batch(BATCH, SIZE), corpus_batch()
    stream = torch.cuda.current_stream().cuda_stream
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    for key, (label, opts, imgs) in lossy_cases(corpus, grad).items():
        batch = q.quantize_host_stage(imgs, min(opts.quantization.max_colors, 256), True)
        km = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (batch.palettes, batch.colors, batch.weights, batch.k)]
        counts = tuple(int(n) for n in batch.counts)
        want = kernels.kmeans_refine(*km, counts)
        plan = kernels.kmeans_plan(counts, kernels._sm_count(dev))
        chunks = torch.from_numpy(plan.chunks).to(dev)
        b, k, m = km[0].shape[0], km[0].shape[1], km[1].shape[1]
        bound, by = kernel_bound("kmeans_refine", **kmeans_work(batch))
        times = {}
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            lib.pixo_kmeans_refine.restype = ctypes.c_int
            lib.pixo_kmeans_refine.argtypes = [vp, i64, i32, vp, vp, vp, i64, vp, i64, vp, vp, vp, vp]
            scratch = torch.zeros(b * k * 5 + b, dtype=torch.int64, device=dev)
            out = torch.empty_like(km[0])

            def alone(lib=lib, scratch=scratch, out=out):
                return lib.pixo_kmeans_refine(km[0].data_ptr(), b, k, km[3].data_ptr(), km[1].data_ptr(),
                                              km[2].data_ptr(), m, chunks.data_ptr(), chunks.shape[0],
                                              scratch.data_ptr(), scratch.data_ptr() + 8 * b * k * 5,
                                              out.data_ptr(), stream)

            rc = alone()
            if rc:
                err = kernels.load().pixo_cuda_error_string(rc).decode()
                print(f"kmeans parts: ({key}), the launch without {name!r} failed: {err}", file=sys.stderr)
                return 1
            if name == "as it is":
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    print(f"kmeans parts: ({key}) differs from the wrapper's result", file=sys.stderr)
                    return 1
            times[name] = profiler_ms(alone, "kmeans_refine_")
        base = times.pop("as it is")
        fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
        print(f"kmeans parts ({key}) {label}: {b} palettes of {k}, {int(batch.counts.sum())} real colours "
              f"in {len(plan.chunks)} chunks of at most {plan.per_chunk}; as it is {fmt(base)} "
              f"(bound {bound:.4f} ms, {by}); without " + "; ".join(
                  f"{n} {fmt(t)}" for n, t in times.items()) + f" [{card}]")
    return 0


# Parts of the trellis kernel (csrc/trellis.cu) that ``trellis_parts`` takes
# out, one at a time and the first four together, by design: {design: {part
# name: [(source text, replacement)]}}. The first design whose texts are all
# in the source is applied, so a parent checkout's kernel is taken apart as
# its own design allows: the merge by counting (the kernel as it is) or the
# first design (an 11 x 10 rank and an 8 x 11 selection). A part's time is
# what the kernel saves without it; the results are wrong, only timed, but
# for the last three parts of the merge by counting: without the packing of
# DP blocks a thread runs its own block, without the grid sized to the card
# a CTA takes 128 consecutive blocks, without the warp's skips every step
# takes every slot and the children's count.
TRELLIS_PARTS = {
    "merge by counting": {
        "the nonzero minima": [
            ("    c[p] = __fadd_rn(__fadd_rn(cost[p], lds_f32(rate + 4 * run[p])), ld);",
             "    c[p] = p == 0 ? __fadd_rn(__fadd_rn(cost[0], lds_f32(rate + 4 * run[0])), ld) : inf();")],
        "the merge (counting and placement)": [
            ("    if (need_count) {", "    if (false) {"),
            ("      ra = rank_nonzero(zc, rz, ca);", "      ra = 0;"),
            ("      rb = rank_nonzero(zc, rz, cb);", "      rb = 0;"),
            ("      rc = rank_nonzero(zc, rz, cc);", "      rc = 0;"),
            ("""#pragma unroll
    for (int p = 0; p < kStates; ++p) {
      sts_u2(slot + min(rz[p], kStates) * kSlotBytes, __float_as_uint(zc[p]), zrun[p] << 8 | p);
    }
    sts_u2(slot + min(ra, kStates) * kSlotBytes, __float_as_uint(ca), ma);
    sts_u2(slot + min(rb, kStates) * kSlotBytes, __float_as_uint(cb), mb);
    sts_u2(slot + min(rc, kStates) * kSlotBytes, __float_as_uint(cc), mc);
    uint32_t meta[kStates];
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      const uint2 e = lds_u2(slot + i * kSlotBytes);
      cost[i] = __uint_as_float(e.x);
      run[i] = e.y >> 8;
      meta[i] = e.y;
    }""", """    uint32_t meta[kStates];
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      cost[i] = i == 0 ? ca : i == 1 ? cb : i == 2 ? cc : zc[i];
      run[i] = zrun[i];
      meta[i] = i == 0 ? ma : i == 1 ? mb : i == 2 ? mc : i;
    }""")],
        "the history store": [("    hist[zz - 1] = make_uint2(__byte_perm(",
                               "    if (meta[0] == 1) hist[zz - 1] = make_uint2(__byte_perm(")],
        "the division": [("    const float fq_next = __fdiv_rn(x[at], q[at]);",
                          "    const float fq_next = __fmul_rn(x[at], q[at]);")],
        "the packing of DP blocks": [
            ("  if (tid >= ndp) return;\n  const unsigned lanes = ndp - warp * 32 >= 32 ? 0xFFFFFFFFu : "
             "(1u << (ndp - warp * 32)) - 1;", "  if (!dp) return;\n  const unsigned lanes = ballot;"),
            ("  const int r = s_rows[tid];", "  const int r = tid;")],
        "the grid sized to the card": [
            ("  const int64_t first = blockIdx.x, stride = gridDim.x;",
             "  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads, stride = 1;"),
            ("  const int per_cta = static_cast<int>((n + slots - 1) / slots < kThreads ? (n + slots - 1) / slots : kThreads);",
             "  const int per_cta = kThreads;")],
        "the warp's skips": [
            ("    const bool need_a = __any_sync(lanes, has_fl || has_ce), need_count = __any_sync(lanes, unsorted);",
             "    const bool need_a = true, need_count = true;"),
            ("    const bool need_b = __any_sync(lanes, has_fl && has_ce), need_c = __any_sync(lanes, afq > 1.5f);",
             "    const bool need_b = true, need_c = true;")],
    },
    "rank and selection": {
        "the nonzero minima": [
            ("        for (int p = 0; p < kStates; ++p) {\n          const float rate = cat < 16",
             "        for (int p = 0; p < 1; ++p) {\n          const float rate = cat < 16")],
        "the merge (rank and placement)": [("""      int rank[kEntries];
#pragma unroll
      for (int e = 0; e < kEntries; ++e) {
        int r = 0;
#pragma unroll
        for (int f = 0; f < kEntries; ++f) {
          if (f != e) r += ec[f] < ec[e] || (ec[f] == ec[e] && eo[f] < eo[e]);
        }
        rank[e] = finite(ec[e]) ? r : kEntries;
      }
      uint64_t h = 0;
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        float c = inf;
        int r = 0, code = 0;
#pragma unroll
        for (int e = 0; e < kEntries; ++e) {
          if (rank[e] == i) {
            c = ec[e];
            r = erun[e];
            code = ecode[e];
          }
        }
        cost[i] = c;
        run[i] = r;
        h |= static_cast<uint64_t>(code) << (6 * i);
      }""", """      uint64_t h = 0;
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        const int e = i < kNz ? kStates + i : i;
        cost[i] = ec[e];
        run[i] = erun[e];
        h |= static_cast<uint64_t>(ecode[e]) << (6 * i);
      }""")],
        "the history store": [("      hist[zz - 1] = h;", "      if (h == 1) hist[zz - 1] = h;")],
        "the division": [("      candidates(__fdiv_rn(coef, qq), v, ok);",
                          "      candidates(__fmul_rn(coef, qq), v, ok);")],
    },
}
for _parts in TRELLIS_PARTS.values():
    _parts["the first four"] = [r for edits in list(_parts.values())[:4] for r in edits]


def trellis_parts(card: str, roots) -> int:
    """Where the trellis kernel's time goes: for the csrc/trellis.cu of each
    checkout in ``roots`` (this one where none is named), its launch (the C
    function) at (m1) and (m2) as it is and with each of ``TRELLIS_PARTS``
    taken out, as its design allows (all built at once), as the profiler's
    device time and SM clocks a DP step. The kernel as it is must equal the
    wrapper's result, which phase 2 holds to the plain version and the host
    library. Exit code 1 on a difference or a failed launch."""
    import ctypes

    import torch

    from pixo_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    grad, corpus = gradient_batch(BATCH, SIZE), corpus_batch()
    inputs = {key: cell_trellis_inputs(dev, imgs) for key, (_, imgs) in trellis_cells(grad, corpus).items()}
    for n, root in enumerate(roots or [os.path.dirname(os.path.abspath(__file__))]):
        source = os.path.join(os.path.abspath(root), "pixo_tpu_torch", "csrc", "trellis.cu")
        text = open(source).read()
        design = next((d for d, parts in TRELLIS_PARTS.items()
                       if all(old in text for edits in parts.values() for old, _ in edits)), None)
        if design is None:
            print(f"trellis parts: {source} is of no design that TRELLIS_PARTS knows", file=sys.stderr)
            return 1
        libs = variant_libs(source, TRELLIS_PARTS[design], f"trellis_part_{n}")
        lib = ctypes.CDLL(libs["as it is"])
        occupancy = lib.pixo_trellis_ctas_per_sm() if hasattr(lib, "pixo_trellis_ctas_per_sm") else None
        print(f"trellis parts of {root}: the {design} design, CTAs an SM {occupancy}")
        for key, (dct, lum, chrom, pattern) in inputs.items():
            want = kernels.trellis_quantize(dct, lum, chrom, pattern)
            dp = dp_blocks(dct, lum, chrom, pattern)
            bound, by = kernel_bound("trellis_quantize", n=dct.shape[0], dp=dp)
            times, mhz = {}, None
            for name, path in libs.items():
                lib = ctypes.CDLL(path)
                lib.pixo_trellis_quantize.restype = ctypes.c_int
                lib.pixo_trellis_quantize.argtypes = kernels.load().pixo_trellis_quantize.argtypes
                alone = trellis_alone(lib, dct, lum, chrom, pattern)
                if name == "as it is":
                    torch.cuda.synchronize()
                    if not torch.equal(alone.out, want):
                        print(f"trellis parts: ({key}) of {root} differs from the wrapper's result",
                              file=sys.stderr)
                        return 1
                    mhz = busy_sm_mhz(alone)
                times[name] = profiler_ms(alone, "trellis_quantize_kernel")
            base = times.pop("as it is")
            fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms ({step_line(t, 63, mhz)})"  # noqa: E731
            print(f"trellis parts ({key}) of {root}: {dct.shape[0]} blocks, {dp} through the DP, bound "
                  f"{bound:.4f} ms ({by}); as it is {fmt(base)}; without "
                  + "; ".join(f"{k} {fmt(t)}" for k, t in times.items()) + f" [{card}]")
    return 0


# Parts of csrc/huffman.cu that ``count_parts`` takes out, by design: the
# one of PR 12 (a CTA of 128 threads takes 128 blocks of one image, all its
# loads at once, into one shared table; a memset first) and the card-sized
# grid (a CTA walks its share in passes of 128 blocks, a step of 16 a warp
# in four rounds, a lane's first two nonzeros of a chunk counted in
# straight-line code; a memset first). A part's time is what the kernel
# saves without it; the results are wrong, only timed, but for "the two
# straight-line nonzeros", whose kernel counts right.
# "The loads alone" keeps the loads and drops everything after them; "the
# memset alone" keeps only the memset.
COUNT_PARTS = {
    "128-block CTAs": {
        "the global flush": [(
            "    if (s_hist[i] != 0) atomicAdd(out + i, static_cast<unsigned long long>(s_hist[i]));",
            "    if (s_hist[i] == 0x7FFFFFFF) out[i] = 0;")],
        "the shared adds": [("      if (run >= 16) atomicAdd(&ac[0xF0], run >> 4);  // ZRL splits\n"
                             "      atomicAdd(&ac[((run & 15) << 4) | bit_length(v)], 1);\n",
                             "      (void)v;\n      (void)run;\n")],
        "the predictor loads": [(
            "      const int pred = prev >= 0 ? __ldg(image + static_cast<int64_t>(prev) * 64) : 0;",
            "      const int pred = prev;")],
        "the loads alone": [("  __syncthreads();  // s_hist is zeroed\n", """  __syncthreads();  // s_hist is zeroed
  {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < kCountPasses; ++k) x ^= words[k][0] ^ words[k][1] ^ words[k][2] ^ words[k][3];
    if (x == 0x9E3779B9u) hist[tid] = x;
    return;
  }
""")],
        "the memset alone": [("""  if ((reinterpret_cast<uintptr_t>(zz) & 15) == 0)
    count_symbols_kernel<true><<<grid, kCountThreads, 0, s>>>(zz, static_cast<int>(n), lay, out);
  else
    count_symbols_kernel<false><<<grid, kCountThreads, 0, s>>>(zz, static_cast<int>(n), lay, out);
""", "  (void)grid;\n  (void)out;\n")],
    },
    "card-sized grid": {
        "the global flush": [("      if (s != 0) atomicAdd(out + i, static_cast<unsigned long long>(s));",
                              "      if (s == 0x7FFFFFFF) out[i] = 0;")],
        "the AC walk": [
            ("      count_ac<true>(mask, last[r], w[r], c, ac);  // a lane's first two nonzeros\n"
             "      count_ac<true>(mask, last[r], w[r], c, ac);\n      rest[r] = mask;\n", "      rest[r] = 0;\n")],
        "the two straight-line nonzeros (every nonzero in the loop)": [
            ("      count_ac<true>(mask, last[r], w[r], c, ac);  // a lane's first two nonzeros\n"
             "      count_ac<true>(mask, last[r], w[r], c, ac);\n", "")],
        "the DC adds": [("    if (valid && cat < kDcBins) atomicAdd(&row[cls * kDcBins + cat], 1);",
                         "    if (valid && cat == 99) row[0] = 1;")],
        "the predictor loads": [("        if (pj >= 0) pred = __ldg(image + static_cast<int64_t>(pj) * 64);",
                                 "        pred = pj;")],
        "the loads alone": [("      count(w, dc, pred, (lay.chroma >> slot) & 1, len);\n", """      uint32_t x = dc ^ pred;
#pragma unroll
      for (int r = 0; r < kRounds; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) x ^= w[r][e];
      if (x == 0x9E3779B9u) hist[tid] = x;
"""), ("    if (image_end || prow + plen == end) flush(pimg);\n", "")],
        "the memset alone": [("""  if ((reinterpret_cast<uintptr_t>(zz) & 15) == 0)
    count_symbols_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(zz, plan, lay, out);
  else
    count_symbols_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(zz, plan, lay, out);
""", "  (void)plan;\n  (void)out;\n")],
    },
}


def count_parts(card: str, roots) -> int:
    """Where the count kernel's time goes: for the csrc/huffman.cu of each
    checkout in ``roots`` (this one where none is named), its launch (the C
    function) at (b1), the balanced route's 16 gradient images, as it is
    and with each of ``COUNT_PARTS`` taken out, as its design has them (all
    built at once), as the profiler's device time (the memset's own where
    the design has one) and the launch alone (CUDA events); and as it is at
    one image. The kernel as it is (and each part that keeps its result)
    must equal the wrapper's result, which phase 2 holds to the plain
    version and the host library. Exit code 1 on a difference or a failed
    launch."""
    import ctypes

    import torch

    from pixo_tpu_torch.jpeg import encoder as jenc
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.parallel.pipeline import jpeg_coeffs_sharded

    dev = torch.device("cuda")
    opts = balanced_options()
    _, pattern = jenc._pattern(opts)
    zz = jpeg_coeffs_sharded(torch.from_numpy(gradient_batch(BATCH, SIZE)).to(dev), opts, device=dev)
    cells = {"b1": zz, "one image": zz[:1].contiguous()}
    bound = {key: kernel_bound("count_symbols", b=z.shape[0], n=z.shape[1]) for key, z in cells.items()}
    want = {key: torch.cat([h.reshape(z.shape[0], -1) for h in kernels.count_symbols(z, pattern)], 1)
            for key, z in cells.items()}
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
    for idx, root in enumerate(roots or [os.path.dirname(os.path.abspath(__file__))]):
        source = os.path.join(os.path.abspath(root), "pixo_tpu_torch", "csrc", "huffman.cu")
        text = open(source).read()
        design = next((d for d, parts in COUNT_PARTS.items()
                       if all(old in text for edits in parts.values() for old, _ in edits)), None)
        if design is None:
            print(f"count parts: {source} is of no design that COUNT_PARTS knows", file=sys.stderr)
            return 1
        planned = design != "128-block CTAs"
        libs = variant_libs(source, COUNT_PARTS[design], f"count_part_{idx}")
        if idx == 0:  # the kernel library's build: the count kernel's registers, stack and spills
            block = kernels.build_log.split("Compiling entry function")
            for part in block[1:]:
                if "count_symbols_kernel" in part.splitlines()[0]:
                    print("count parts: ptxas " + " | ".join(x.strip() for x in part.splitlines()
                                                             if x.strip() and "Compiling" not in x)[:400])
        times, loaded = {}, {}
        for name, path in libs.items():
            lib = loaded[name] = ctypes.CDLL(path)
            lib.pixo_count_symbols.restype = ctypes.c_int
            lib.pixo_count_symbols.argtypes = ([vp, i64, i64, vp, i32, i32, i64, i64, vp, vp] if planned
                                               else [vp, i64, i64, vp, i32, i32, vp, vp])
            for key in (("b1", "one image") if name == "as it is" else ("b1",)):
                alone = count_alone(kernels, cells[key], pattern, lib, planned)
                if name in ("as it is", "the two straight-line nonzeros (every nonzero in the loop)"):
                    torch.cuda.synchronize()
                    if not torch.equal(alone.hist, want[key]):
                        print(f"count parts: ({key}) of {root} {name} differs from the wrapper's result",
                              file=sys.stderr)
                        return 1
                device = profiler_ms(alone, "count_symbols_kernel") if name != "the memset alone" else None
                memset = profiler_ms(alone, "Memset")
                times[(name, key)] = (device, memset, event_ms(alone))
        lib = loaded["as it is"]
        occupancy = lib.pixo_count_ctas_per_sm() if hasattr(lib, "pixo_count_ctas_per_sm") else None
        print(f"count parts of {root}: the {design} design, CTAs an SM {occupancy}; (b1) 16x512x512 q85 4:2:0, bound "
              f"{bound['b1'][0]:.4f} ms, one image {bound['one image'][0]:.4f} ms [{card}]")
        if planned:  # the grid at 1 to 4 CTAs an SM
            for per_sm in range(1, 5):
                for key, z in cells.items():
                    plan = kernels.count_plan(z.shape[0], z.shape[1], kernels._sm_count(dev) * per_sm)
                    alone = count_alone(kernels, z, pattern, lib, True, plan)
                    print(f"count parts ({key}) of {root}: as it is on a grid of {per_sm} CTAs an SM, "
                          f"{plan[0]} CTAs of {plan[1]} blocks: device "
                          f"{fmt(profiler_ms(alone, 'count_symbols_kernel'))} [{card}]")
        for (label, key), (device, memset, launch) in times.items():
            print(f"count parts ({key}) of {root}: {label}: device {fmt(device)}, memset {fmt(memset)}, "
                  f"launch alone {fmt(launch)} [{card}]")
    return 0


# The designs of chain_candidates (csrc/lz77.cu) that ``lz77_parts`` knows:
# {design: (its kernels in launch order, its rows' kernel, {part name:
# [(source text, replacement)]})}. The first design whose texts are all in
# the source is applied, so a parent checkout's kernel is taken apart as its
# own design allows. A part's time is what the rows' kernel saves without
# it; the results are wrong, only timed. "The lengths" writes every length
# as 0; "the table stores" writes no row and keeps a checksum of it live.
LZ77_DESIGNS = {
    "a thread a sorted index": (
        ("hash4_kernel", "digit_hist_kernel", "exclusive_scan_kernel", "digit_scatter_kernel", "chain_kernel"),
        "chain_kernel",
        {"the lengths": [("        lens[row * k + kk] = match_len(d, n, p, c, kMaxMatch);",
                          "        lens[row * k + kk] = 0;")],
         "the table stores": [("""      for (; kk < k && i - 1 - kk >= 0 && skey[i - 1 - kk] == key; kk++) {
        const int32_t c = spos[i - 1 - kk];
        cand[row * k + kk] = c;
        lens[row * k + kk] = match_len(d, n, p, c, kMaxMatch);
      }
    }
    for (; kk < k; kk++) {
      cand[row * k + kk] = -1;
      lens[row * k + kk] = 0;
    }
""", """      int32_t live = 0;
      for (; kk < k && i - 1 - kk >= 0 && skey[i - 1 - kk] == key; kk++) {
        const int32_t c = spos[i - 1 - kk];
        live += c ^ match_len(d, n, p, c, kMaxMatch);
      }
      if (live == 0x7fffffff) cand[row * k] = live;
    }
""")]}),
    "lane groups": (
        LZ77_KERNELS, "chain_rows_kernel",
        {"the lengths": [(
            "          len = cand_len(d, n, p, c, s_win[at - lo], s_win[i - lo], s_run[at - lo], s_run[i - lo]);",
            "          len = 0;")],
         "the runs and windows (lengths from global memory)": [(
             "          len = cand_len(d, n, p, c, s_win[at - lo], s_win[i - lo], s_run[at - lo], s_run[i - lo]);",
             "          len = chain_len(d, n, p, c, kMaxMatch);")],
         "the table stores": [
             ("  const int lane = threadIdx.x & (group - 1);",
              "  int32_t live = 0;\n  const int lane = threadIdx.x & (group - 1);"),
             ("      __stcs(crow + j, c);\n      __stcs(lrow + j, len);", "      live += c ^ len;"),
             ("  if (blockIdx.x == gridDim.x - 1)\n", "  if (live == 0x7fffffff) cand[0] = live;\n"
                                                    "  if (blockIdx.x == gridDim.x - 1)\n")]}),
}


def lz77_design(text: str):
    """The name of the first of ``LZ77_DESIGNS`` whose edits all match the
    source ``text``, or None."""
    return next((name for name, (_, _, parts) in LZ77_DESIGNS.items()
                 if all(old in text for edits in parts.values() for old, _ in edits)), None)


def lz77_parts(card: str, roots) -> int:
    """Where ``chain_candidates``' time goes: for the csrc/lz77.cu of each
    checkout in ``roots`` (this one where none is named), its launch (the C
    function, k = 16) at one of (e)'s streams and at 16 MiB of values 0-3:
    the profiler's device time of each of its kernels as it is, and of its
    rows' kernel without each part of ``LZ77_DESIGNS`` (all built at once);
    first, each input's candidates, those of length 16 or more and of 258,
    and its share of zero bytes.
    The launch as it is must equal the wrapper's result, which phase 2 holds
    to the plain version. Exit code 1 on a difference or a failed launch."""
    import ctypes

    import numpy as np
    import torch

    from pixo_tpu_torch.compress.deflate import LZ77_ASSIST_STEPS
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops import lz77_assist as lz

    dev, k = torch.device("cuda"), LZ77_ASSIST_STEPS
    kernels.load()
    streams = png_max_streams(dev, corpus_batch())
    inputs = {"(e) stream 0": torch.from_numpy(np.ascontiguousarray(streams[0]).reshape(-1).copy()).to(dev),
              "16 MiB of values 0-3": torch.from_numpy(
                  np.random.default_rng(31).integers(0, 4, 1 << 24, dtype=np.uint8)).to(dev)}
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    stream = torch.cuda.current_stream().cuda_stream
    fmt = lambda t: "not measured" if t is None else f"{t:.4f} ms"  # noqa: E731
    for at, t in inputs.items():  # what the lengths face
        cand, lens = lz.chain_candidates(t, k=k)
        print(f"lz77 parts {at}: {int((cand >= 0).sum())} candidates, {int((lens >= 16).sum())} of length 16 "
              f"or more, {int((lens == 258).sum())} of 258; zero bytes {float((t == 0).float().mean()):.1%} [{card}]")
        del cand, lens
    for idx, root in enumerate(roots or [os.path.dirname(os.path.abspath(__file__))]):
        source = os.path.join(os.path.abspath(root), "pixo_tpu_torch", "csrc", "lz77.cu")
        design = lz77_design(open(source).read())
        if design is None:
            print(f"lz77 parts: {source} is of no design that LZ77_DESIGNS knows", file=sys.stderr)
            return 1
        names, rows, parts = LZ77_DESIGNS[design]
        libs = variant_libs(source, parts, f"lz77_part_{idx}")
        for at, t in inputs.items():
            want = lz.chain_candidates(t, k=k)
            n = t.numel()
            times, split = {}, {}
            for name, path in libs.items():
                lib = ctypes.CDLL(path)
                lib.pixo_chain_workspace.restype = i64
                lib.pixo_chain_workspace.argtypes = [i64]
                lib.pixo_chain_candidates.restype = ctypes.c_int
                lib.pixo_chain_candidates.argtypes = [vp, i64, i32, vp, vp, vp, vp]
                cand = torch.empty((n, k), dtype=torch.int32, device=dev)
                lens = torch.empty_like(cand)
                work = torch.empty(lib.pixo_chain_workspace(n), dtype=torch.int32, device=dev)

                def alone(lib=lib, cand=cand, lens=lens, work=work):
                    return lib.pixo_chain_candidates(t.data_ptr(), n, k, work.data_ptr(), cand.data_ptr(),
                                                     lens.data_ptr(), stream)

                rc = alone()
                if rc:
                    err = kernels.load().pixo_cuda_error_string(rc).decode()
                    print(f"lz77 parts: {at} of {root}, the launch without {name!r} failed: {err}",
                          file=sys.stderr)
                    return 1
                if name == "as it is":
                    torch.cuda.synchronize()
                    if not (torch.equal(cand, want[0]) and torch.equal(lens, want[1])):
                        print(f"lz77 parts: {at} of {root} differs from the wrapper's result", file=sys.stderr)
                        return 1
                    split = {kn: profiler_ms(alone, kn) for kn in names}
                    split["the call"] = profiler_ms(alone, names)
                times[name] = profiler_ms(alone, rows)
                del cand, lens, work
                torch.cuda.empty_cache()
            bound, by = kernel_bound("chain_candidates", n=n, k=k)
            base = times.pop("as it is")
            print(f"lz77 parts {at} ({n} B, k={k}) of {root}, the {design} design: bound {bound:.4f} ms ({by}); "
                  "as it is, by kernel (profiler, ms a call): "
                  + ", ".join(f"{kn} {fmt(ms)}" for kn, ms in split.items()) + f" [{card}]")
            print(f"lz77 parts {at} of {root}: the rows' kernel {rows} as it is {fmt(base)}; without "
                  + "; ".join(f"{p} {fmt(ms)}" for p, ms in times.items()) + f" [{card}]")
            del want
            torch.cuda.empty_cache()
    return 0


def _resize_lib(path: str):
    import ctypes

    lib = ctypes.CDLL(path)
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.pixo_resize_lanczos3.argtypes = [vp, i64, i64, i64, i32, vp, vp, i32, i64, vp, vp, i32,
                                         i64, vp, vp, i32, i32, i32, vp]
    return lib


def resize_parts(card: str) -> int:
    """The resize kernel alone: ``check_resize_kernel`` (every case of
    ``resize_cases`` at offsets 0, 1, 3 and 15 against the plain version and
    the host library, each with its route), then the profiler's device time
    of each pass at (t1)'s chunk (64x256x256x3 -> 128x128) and at the large
    image (1x1812x3220x3 -> 128x128) beside its bound, for csrc/resize.cu as
    it is and with each of ``RESIZE_PARTS`` taken out (all built at once;
    the C function alone). Exit code 1 on any byte difference."""
    import numpy as np
    import torch

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.resize_kernels import _taps_on

    libs = variant_libs("resize.cu", RESIZE_PARTS, "resize_part")
    kernel = ""
    for line in kernels.build_log.splitlines():
        if "entry function" in line:
            kernel = line.split("'")[1]
        elif "resize" in kernel and any(k in line for k in ("registers", "spill")):
            print(f"ptxas {kernel}: {line.strip()}")
    dev = torch.device("cuda")
    try:
        check_resize_kernel(dev)
    except Failed as e:
        print(f"resize parts: FAILED: {e}", file=sys.stderr)
        return 1
    rng = np.random.default_rng(11)
    for label, shape in (("(t1) chunk", (T1_CHUNK, T1_SIZE, T1_SIZE, 3)),
                         ("large image", (1, 1812, 3220, 3))):
        imgs = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        taps = (*_taps_on(shape[2], THUMB, dev), *_taps_on(shape[1], THUMB, dev))
        plan = kernels.resize_plan(*shape, THUMB, THUMB, taps[1].shape[1], taps[3].shape[1])
        parts = {}
        for key, path in libs.items():
            alone, work, out = resize_alone(imgs, THUMB, _resize_lib(path))
            rc = alone()
            if rc:
                err = kernels.load().pixo_cuda_error_string(rc).decode()
                print(f"resize parts: {label}, the launch without {key!r} failed: {err}", file=sys.stderr)
                return 1
            if key == "as it is":
                torch.cuda.synchronize()
                if not torch.equal(out, kernels.resize_lanczos3_plain(imgs, *taps)):
                    print(f"resize parts: {label} differs from its plain version", file=sys.stderr)
                    return 1
            parts[key] = [profiler_ms(alone, f"resize_lanczos3_{p}_") for p in "hv"]
        at = f"{label} {'x'.join(map(str, shape))} -> {THUMB}x{THUMB}, {work['kx']} and {work['ky']} taps"
        (h, v) = parts.pop("as it is")
        bh, _ = kernel_bound("resize_lanczos3", passes="horizontal", **work)
        bv, _ = kernel_bound("resize_lanczos3", passes="vertical", **work)
        if label == "(t1) chunk":  # the horizontal pass under each tile it could take
            tiles = []
            for cols, quads in ((128, 2), (128, 1), (64, 4), (64, 2), (32, 8)):
                tile = kernels.resize_tile(shape[2], shape[3], THUMB, taps[1].shape[1], cols, quads,
                                           plan.vertical)
                alone, _, out = resize_alone(imgs, THUMB, _resize_lib(libs["as it is"]), tile)
                if alone() or not torch.equal(out, kernels.resize_lanczos3_plain(imgs, *taps)):
                    print(f"resize parts: the tile {cols}x{quads} failed or differs", file=sys.stderr)
                    return 1
                ms = profiler_ms(alone, "resize_lanczos3_h_")
                tiles.append(f"{cols} columns x {4 * quads} rows {ms * 1e3:.2f} us")
            print(f"resize tiles {label}, horizontal: {'; '.join(tiles)} [{card}]")
        print(f"resize parts {at} ({plan}): horizontal {h * 1e3:.2f} us (bound {bh * 1e3:.2f}), "
              f"vertical {v * 1e3:.2f} us (bound {bv * 1e3:.2f}), both {(h + v) * 1e3:.2f} us; without "
              + "; ".join(f"{k} {ph * 1e3:.2f} + {pv * 1e3:.2f} us" for k, (ph, pv) in parts.items())
              + f" [{card}]")
    return 0


def pack_workers(card: str) -> int:
    """What the host pack stage (``_pack_hosted``, then the marker frame)
    takes on 1, 2, 4 and 8 threads, for the JPEG encode's 16x512x512 q85
    4:2:0 batch and for one thumbnail chunk of 64 128x128 q85 4:4:4 images:
    one library call an image, whose Python set-up holds the interpreter
    lock, so more threads help only where the call itself is long. Then the
    whole thumbnail call on 256 such JPEGs under ``host_workers`` 1 to 8."""
    import numpy as np
    import torch

    from pixo_tpu_torch import (
        ColorType,
        JpegOptions,
        Subsampling,
        encode_jpeg_batch_sharded,
        thumbnail_pipeline,
    )
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.ops.blockify import scan_layout
    from pixo_tpu_torch.ops.resize_kernels import resize_lanczos3_batch
    from pixo_tpu_torch.parallel.pipeline import (
        _assemble_jpeg,
        _fetch_compacted,
        _pack_hosted,
        jpeg_coeffs_sharded,
    )
    from pixo_tpu_torch.utils.synthetic import synth_gradient

    dev = torch.device("cuda")
    base = synth_gradient(T1_SIZE, T1_SIZE, 3)
    rolled = np.stack([np.roll(base, int(s), axis=1)
                       for s in np.random.default_rng(0).integers(0, 64, T1_CHUNK)])
    thumbs = resize_lanczos3_batch(torch.from_numpy(rolled).to(dev), dst_w=THUMB, dst_h=THUMB)
    batches = {
        f"JPEG encode {BATCH}x{SIZE}x{SIZE} q{QUALITY} 4:2:0": (
            gradient_batch(BATCH, SIZE),
            JpegOptions(width=SIZE, height=SIZE, quality=QUALITY, subsampling=Subsampling.S420)),
        f"thumbnail chunk {T1_CHUNK}x{THUMB}x{THUMB} q{THUMB_QUALITY} 4:4:4": (
            thumbs, JpegOptions(width=THUMB, height=THUMB, quality=THUMB_QUALITY,
                                color_type=ColorType.RGB)),
    }
    for label, (imgs, opts) in batches.items():
        quant = QuantizationTables(opts.quality)
        _, _, pattern = scan_layout(opts.width, opts.height, "rgb", opts.subsampling.value)
        zz = jpeg_coeffs_sharded(imgs, opts, device=dev)
        state = _fetch_compacted(zz, kernels.compact_padded(zz, 8))
        times = []
        for workers in (1, 2, 4, 8):
            med, least, most = wall_stats(
                lambda: [_assemble_jpeg(s, opts, quant) for s in _pack_hosted(state, opts, pattern, workers)],
                runs=WARM_RUNS)
            times.append(f"{workers} threads {med:.4f} ms ({least:.4f} to {most:.4f})")
        print(f"pack workers {label}: " + "; ".join(times) + f" (median, least to most of "
              f"{WARM_RUNS} warm runs) [{card}]")
    # the whole thumbnail call under host_workers, which sets the threads of
    # the decode's library calls and of the pack alike
    files = encode_jpeg_batch_sharded(np.concatenate([rolled] * 4),
                                      JpegOptions.fast(T1_SIZE, T1_SIZE, 90), device=dev)
    times = []
    for workers in (1, 2, 4, 8):
        med, least, most = wall_stats(lambda: thumbnail_pipeline(
            files, thumb_size=THUMB, quality=THUMB_QUALITY, host_workers=workers,
            chunk_size=T1_CHUNK, device=dev))
        times.append(f"{workers} {med:.4f} ms ({least:.4f} to {most:.4f})")
    print(f"pack workers thumbnail_pipeline {len(files)} JPEGs {T1_SIZE}x{T1_SIZE} in chunks of "
          f"{T1_CHUNK}, by host_workers: " + "; ".join(times) + f" (median, least to most of "
          f"{THUMB_RUNS} warm runs) [{card}]")
    return 0


HOST_BUILD_ROUNDS = 6  # rounds of --host-build, each a process of either build, in alternating order


def host_stage_calls(dev) -> dict:
    """Phase 4's host stages as phase 4 sets them up, each with its warm runs:
    {stage: (call, runs)}. The JPEG encode's padded pack on 8 threads, with
    the standard tables and the balanced route's (``host_pack``,
    ``balanced_host_pack``), the progressive scans of (p1) on 8 threads
    (``progressive_host``), the DEFLATE and framing of PNG (a), (b) and (e)
    on 8 threads (``png_deflate``, ``png_max_deflate``) and the decode's
    host stage at (d1) and (d3) (``decode_host_entropy``). Every input is
    made on the card as the path makes it."""
    import torch

    from pixo_tpu_torch import JpegOptions, Subsampling
    from pixo_tpu_torch.jpeg import encoder as jenc
    from pixo_tpu_torch.jpeg.tables import QuantizationTables
    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.parallel.pipeline import _fetch_compacted, _pack_hosted, jpeg_coeffs_sharded, png_frame

    grad, corpus = gradient_batch(BATCH, SIZE), corpus_batch()
    grad_dev, corpus_dev = torch.from_numpy(grad).to(dev), torch.from_numpy(corpus).to(dev)
    calls = {}
    for name, opts in (("host_pack", JpegOptions(width=SIZE, height=SIZE, quality=QUALITY,
                                                 subsampling=Subsampling.S420)),
                       ("balanced_host_pack", balanced_options())):
        _, pattern = jenc._pattern(opts)
        zz = jpeg_coeffs_sharded(grad_dev, opts, device=dev)
        state = _fetch_compacted(zz, kernels.compact_padded(zz, 8))
        tables = None
        if opts.optimize_huffman:
            dc, ac = (h.cpu().numpy() for h in kernels.count_symbols(zz, pattern))
            tables = [jenc.tables_from_counts(dc[i], ac[i], opts) for i in range(BATCH)].__getitem__
        calls[name] = ((lambda state=state, opts=opts, pattern=pattern, tables=tables:
                        _pack_hosted(state, opts, pattern, 8, tables)), WARM_RUNS)
    popts = balanced_options(progressive=True)
    _, pattern = jenc._pattern(popts)
    quant = QuantizationTables(QUALITY)
    zz_host = jpeg_coeffs_sharded(corpus_dev, popts, device=dev).cpu().numpy()
    calls["progressive_host (p1)"] = (lambda: _pool(lambda z: jenc._emit_with_sa_fallback(
        z, None, popts, quant, pattern, zz_host.shape[1]), zz_host), THUMB_RUNS)
    for key, (_, opts, imgs) in {**png_cases(corpus, grad), "e": png_max_case(corpus)}.items():
        _, raw, ct, kw = png_group(dev, opts, imgs)
        filtered = kernels.filter_rows(raw, **kw).cpu().numpy()
        name = "png_max_deflate" if key == "e" else "png_deflate"
        calls[f"{name} ({key})"] = ((lambda filtered=filtered, ct=ct, opts=opts:
                                     _pool(lambda f: png_frame(f, ct, opts), filtered)),
                                    MAX_PNG_RUNS if key == "e" else WARM_RUNS)
    cases = decode_cases(dev, grad, corpus)
    for key in ("d1", "d3"):
        calls[f"decode_host_entropy ({key})"] = (decode_launchers(dev, cases[key][1])["host"], WARM_RUNS)
    return calls


def host_stages() -> dict:
    """``--host-stages``, one process of ``--host-build``: the library it
    loaded and the median ms of each of ``host_stage_calls``."""
    import torch

    from pixo_tpu_torch import native

    native.load()
    with env_var("PIXO_TPU_LZ77", None):
        times = {name: wall_stats(call, runs)[0]
                 for name, (call, runs) in host_stage_calls(torch.device("cuda")).items()}
    return {"library": os.path.basename(native.library_path), "profile_guided": native.profile_guided,
            "ms": times}


def host_stages_paired() -> dict:
    """``--host-stages paired``, the last process of ``--host-build``: both
    builds loaded in one process, each stage of ``host_stage_calls`` called
    under either library in turns (pgo, plain, plain, pgo, ...; one untimed
    call after each switch), its runs' times in pairs. {stage: {"pgo": ms
    list, "plain": ms list}}."""
    import torch

    from pixo_tpu_torch import native

    libs = {"pgo": native._open(native._build(True).path), "plain": native._open(native._build(False).path)}
    native._lib = libs["plain"]
    out = {}
    with env_var("PIXO_TPU_LZ77", None):
        for name, (call, runs) in host_stage_calls(torch.device("cuda")).items():
            out[name] = {"pgo": [], "plain": []}
            for i in range(runs):
                for kind in (("pgo", "plain") if i % 2 == 0 else ("plain", "pgo")):
                    native._lib = libs[kind]
                    call()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    call()
                    torch.cuda.synchronize()
                    out[name][kind].append((time.perf_counter() - t0) * 1e3)
    return out


def host_build(card: str) -> int:
    """``--host-build``: phase 4's host stages (``host_stage_calls``) under
    the host library's two builds, the default (profile-guided) and the one
    ``PIXO_TPU_NO_PGO=1`` gives (plain), in HOST_BUILD_ROUNDS rounds of one
    process each, the order alternating (pgo, plain, plain, pgo, ...). Both
    libraries and the kernels are built first, each build step printed. For
    each stage and build: the median, least and most of the rounds' medians;
    the ratio of the medians. Then both libraries in one process, in turns
    (``host_stages_paired``): each build's median, least and most, and the
    pairs' ratios. Output bytes are the same under both builds
    (``tests/test_torch_pgo.py``)."""
    from pixo_tpu_torch import native
    from pixo_tpu_torch.ops import kernels

    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as ex:
        builds = {"pgo": ex.submit(native._build, True), "plain": ex.submit(native._build, False)}
        ex.submit(kernels.load).result()
        for kind, built in builds.items():
            steps = ", ".join(f"{k} {v:.1f} s" for k, v in built.result().steps.items()) or "already built"
            print(f"host build {kind}: {os.path.basename(built.result().path)}: {steps} [{card}]")
    here = os.path.dirname(os.path.abspath(__file__))
    runs = {"pgo": [], "plain": []}
    for r in range(HOST_BUILD_ROUNDS):
        for kind in (("pgo", "plain") if r % 2 == 0 else ("plain", "pgo")):
            env = {k: v for k, v in os.environ.items() if k != "PIXO_TPU_NO_PGO"}
            if kind == "plain":
                env["PIXO_TPU_NO_PGO"] = "1"
            proc = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"), "--host-stages"],
                                  cwd=here, env=env, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                print(f"chip_smoke: FAILED: --host-stages under the {kind} build:\n{proc.stderr[-4000:]}",
                      file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            if res["profile_guided"] != (kind == "pgo") or res["library"] != os.path.basename(
                    builds[kind].result().path):
                print(f"chip_smoke: FAILED: the {kind} round loaded {res}", file=sys.stderr)
                return 1
            runs[kind].append(res["ms"])
            print(f"host build round {r} {kind}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in res["ms"].items()))
    for stage in runs["pgo"][0]:
        line = []
        meds = {}
        for kind in ("pgo", "plain"):
            xs = [ms[stage] for ms in runs[kind]]
            meds[kind] = _median(xs)
            line.append(f"{kind} median {meds[kind]:.4f} ms ({min(xs):.4f} to {max(xs):.4f})")
        print(f"host build stage {stage}: " + "; ".join(line) + f"; pgo / plain {meds['pgo'] / meds['plain']:.4f} "
              f"(medians of {HOST_BUILD_ROUNDS} processes each) [{card}]")
    proc = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"), "--host-stages", "paired"],
                          cwd=here, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        print(f"chip_smoke: FAILED: --host-stages paired:\n{proc.stderr[-4000:]}", file=sys.stderr)
        return 1
    for stage, times in json.loads(proc.stdout.strip().splitlines()[-1]).items():
        ratios = [a / b for a, b in zip(times["pgo"], times["plain"])]
        wins = sum(r < 1 for r in ratios)
        print(f"host build paired {stage}: pgo median {_median(times['pgo']):.4f} ms "
              f"({min(times['pgo']):.4f} to {max(times['pgo']):.4f}); plain median "
              f"{_median(times['plain']):.4f} ms ({min(times['plain']):.4f} to {max(times['plain']):.4f}); "
              f"pgo / plain, median of the pairs {_median(ratios):.4f} ({min(ratios):.4f} to "
              f"{max(ratios):.4f}), pgo faster in {wins} of {len(ratios)} pairs (one process, the two "
              f"libraries in turns) [{card}]")
    return 0


def sass_loops(kernel: str) -> int:
    """The machine code of the kernels whose name holds ``kernel``, from
    ``cuobjdump -sass`` on the library built from the checkout: each kernel's
    instruction count and, for every loop (a backward branch over 12 to
    2,000 instructions), its length and its counts of shared-memory loads and
    stores and of the byte-SIMD VABSDIFF4 (with ``.ACC``: a score's sum). An
    instruction-rate floor is these counts times the trips the shapes give."""
    import re

    from pixo_tpu_torch.ops import kernels
    from pixo_tpu_torch.utils.build import BUILD_DIR

    kernels.load()
    lib = max((os.path.join(BUILD_DIR, f) for f in os.listdir(BUILD_DIR)
               if f.startswith("libpixo_kernels-") and f.endswith(".so")), key=os.path.getmtime)
    tool = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for part in text.split("Function : ")[1:]:
        name = part.split()[0]
        if kernel not in name:
            continue
        ins = [(int(m.group(1), 16), m.group(2)) for m in
               re.finditer(r"^\s+/\*([0-9a-f]{4,6})\*/\s+(.*?);", part, re.M)]
        index = {a: k for k, (a, _) in enumerate(ins)}
        print(f"sass {name}: {len(ins)} instructions")
        for k, (a, t) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", t)
            target = int(m.group(1), 16) if m else a
            if target < a and target in index and 12 <= k - index[target] + 1 <= 2000:
                # a predicated instruction starts with its predicate, "@P0 LDS ..."
                body = [x.split(" ", 1)[-1] if x.startswith("@") else x
                        for _, x in ins[index[target]: k + 1]]
                counts = ", ".join(
                    f"{label} {sum(x.startswith(prefix) for x in body)}" for label, prefix in (
                        ("LDS", "LDS"), ("STS", "STS"), ("LDG", "LDG"), ("STG", "STG"),
                        ("VABSDIFF4", "VABSDIFF4.U8 "), ("VABSDIFF4.ACC", "VABSDIFF4.U8.ACC"),
                        ("SHFL", "SHFL"), ("FMUL", "FMUL"), ("FADD", "FADD"), ("PRMT", "PRMT"),
                        ("ISETP", "ISETP"), ("BRA", "BRA"), ("ATOMS", "ATOMS"), ("POPC", "POPC")))
                print(f"sass   loop at {target:#x}: {len(body)} instructions, {counts}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs only on the card",
              file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure_tree(sys.argv[2])))
        return 0
    if sys.argv[1:2] == ["--host-stages"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        print(json.dumps(host_stages_paired() if sys.argv[2:3] == ["paired"] else host_stages()))
        return 0
    if sys.argv[1:2] == ["--sass"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return sass_loops(sys.argv[2])
    if sys.argv[1:2] in (["--compare"], ["--coeffs-parts"], ["--filter-parts"], ["--resize-parts"],
                         ["--dither-parts"], ["--kmeans-parts"], ["--trellis-parts"], ["--count-parts"],
                         ["--lz77-parts"], ["--pack-workers"], ["--unfilter-parts"], ["--host-build"]):
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
        print(card)
        if sys.argv[1] == "--compare":
            return same_call_comparison(sys.argv[2:])
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        if sys.argv[1] == "--trellis-parts":
            return trellis_parts(card, sys.argv[2:])
        if sys.argv[1] == "--count-parts":
            return count_parts(card, sys.argv[2:])
        if sys.argv[1] == "--lz77-parts":
            return lz77_parts(card, sys.argv[2:])
        if sys.argv[1:3] == ["--coeffs-parts", "dct_zz"]:
            return dct_zz_parts(card, sys.argv[3:])
        return {"--coeffs-parts": coeffs_parts, "--filter-parts": filter_parts,
                "--resize-parts": resize_parts, "--dither-parts": dither_parts,
                "--kmeans-parts": kmeans_parts, "--unfilter-parts": unfilter_parts,
                "--pack-workers": pack_workers, "--host-build": host_build}[sys.argv[1]](card)
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
    print_clocks("at the start")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    with concurrent.futures.ThreadPoolExecutor(max_workers=2) as ex:  # both builds at once
        for built in [ex.submit(kernels.load), ex.submit(native.load)]:
            built.result()
    print(f"build: cuda kernels {kernels.build_seconds:.1f} s, host library "
          f"{os.path.relpath(native.SOURCE, os.path.dirname(os.path.abspath(__file__)))} "
          f"{'profile-guided' if native.profile_guided else 'plain (PIXO_TPU_NO_PGO)'} "
          f"{os.path.basename(native.library_path)}: "
          + (", ".join(f"{k} {v:.1f} s" for k, v in native.build_seconds.items()) or "already built"))
    for line in kernels.build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "entry function")):
            print(f"ptxas: {line.strip()}")

    grad = gradient_batch(BATCH, SIZE)
    noise = np.random.default_rng(1).integers(0, 256, (4, 517, 389, 3), dtype=np.uint8)
    corpus = corpus_batch()
    try:
        errs = check_kernels(dev, grad, noise, 100_000)
        errs["count_symbols"] = check_count_kernel(dev, main_count_cases(dev, grad, corpus, noise))
        cells = trellis_cells(grad, corpus)
        errs.update(check_trellis_kernels(dev, grad, noise, cells))
        errs.update(check_png_kernels(dev, corpus))
        streams = png_max_streams(dev, corpus)
        errs.update(check_lz77_kernels(dev, streams))
        errs["unfilter"] = check_unfilter_kernel(dev, corpus)
        cases = decode_cases(dev, grad, corpus)
        errs.update(check_decode_kernels(dev, cases, 100_000))
        errs.update(check_resize_kernel(dev))
        tcases = thumbnail_cases(dev, cases)
        thumb_errs = check_thumbnail_kernels(dev, tcases)
        errs.update(check_quantize_kernels(dev, corpus, grad))
        launches = check_main_path(dev, grad)
        launches["count_symbols"] = check_jpeg_routes(dev, grad, corpus)["count_symbols"]
        max_launches = check_trellis_path(dev, cells, corpus)
        launches.update({k: max_launches["m1"][k] for k in ("dct_zz", "trellis_quantize")})
        launches.update(check_png_main_path(dev, corpus, grad))
        max_png_launches = check_png_max_path(dev, corpus)
        lz77_launches = check_lz77_route(dev, corpus, streams)
        check_png_options(dev, corpus)
        launches.update(check_decode_main_path(dev, cases))
        check_decode_tiers(dev, cases)
        unfilter_launches = check_png_decode_path(dev, corpus)
        thumb_launches = check_thumbnail_path(dev, tcases)
        lossy_launches = check_lossy_main_path(dev, corpus, grad)
        stream_launches = check_stream_path(dev, grad)
        cli_launches = check_cli(dev, corpus)
        service_rps = check_service(dev, grad, corpus, card)
        playground_launches = check_playground(dev, corpus)
        check_dcn()
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    missing = ([k for k, n in launches.items() if n < 1]
               + [f"{k} (thumbnail path)" for k, n in thumb_launches.items() if n < 1]
               + [f"{k} ({cell})" for cell, counts in lossy_launches.items()
                  for k, n in counts.items() if n < 1]
               + [f"{k} (max cell {cell})" for cell, counts in max_launches.items()
                  for k in ("dct_zz", "trellis_quantize") if counts[k] < 1]
               + [f"{k} (png max cell e)" for k, n in max_png_launches.items() if n < 1]
               + (["chain_candidates (png max cell e under PIXO_TPU_LZ77=device)"]
                  if lz77_launches["chain_candidates"] < 1 else [])
               + [f"{k} (stream)" for k, n in stream_launches.items() if n < 1])
    if missing:
        print(f"chip_smoke: FAILED: the main path launched no {missing} kernel", file=sys.stderr)
        return 1
    launches["resize_lanczos3"] = thumb_launches["resize_lanczos3"]
    launches.update(lz77_launches)  # adler32's: 0 where no path calls it, as in the JAX package
    launches["unfilter"] = unfilter_launches  # 0: the PNG decode unfilters on the host, as the JAX package
    launches.update(lossy_launches["q1"])
    k_ms = time_everything(dev, grad, 100_000, card)
    k_ms.update(time_png(dev, corpus, grad, card))
    k_ms["e"] = {"filter_rows": time_png_max(dev, corpus, card)}
    k_ms.update(time_lz77(dev, streams, card))
    k_ms.update(time_decode(dev, cases, card, 100_000))
    try:
        k_ms.update(time_jpeg_routes(dev, grad, corpus, card))
        k_ms.update(time_trellis(dev, cells, card))
        resize_ms, thumb_ms = time_thumbnail(dev, tcases, card)
        k_ms.update(resize_ms)
        k_ms.update(time_lossy(dev, corpus, grad, card))
        print_clocks("after the lossy timings")
        stream_ms = time_stream(dev, grad, card)
        k_ms["unfilter"] = time_unfilter(dev, corpus, card)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # dct8x8_aan, filter_bank and idct8x8_int (the TPU kernels' own
    # contracts) are on no main path: their checks and times have lines of
    # their own above. Each path's run in phase 3 is one call of its entry
    # point, so its launches are the launches per call; the resize kernel's
    # are those of the thumbnail call (t1), 16 chunks of one shape group. A
    # kernel that the thumbnail path shares with another path also has that
    # path's record under "thumbnail_path": its launches in the call (t1),
    # its error against the plain version on that path's tensors, and its
    # times and bound at one chunk's shapes. The quantization kernels'
    # launches and times are those of the lossy cell (q1); (q2)'s are under
    # "q2". The max route's kernels (dct_zz, trellis_quantize) have the
    # launches and times of cell (m1); (m2)'s are under "m2". filter_rows
    # has those of PNG (a); mode 7's (Bigrams, the PNG max preset) in cell
    # (e) are under "e". chain_candidates has the launches of the (e) call
    # under PIXO_TPU_LZ77=device and the times at one (e) stream; its times
    # at 16 MiB are under "16 MiB". adler32 is on no path (0 launches), as
    # adler32_jnp in the JAX package; nor is unfilter (its launches are those
    # of the PNG decode's run, 0, as unfilter_device_batch's in the JAX
    # package), whose times are at PNG (a)'s device group, with its critical
    # path's bound beside the byte bound under "critical_path".
    sources = {"coeffs": ("pixo_tpu_torch/csrc/coeffs.cu", "pixo_tpu/ops/pallas_kernels.py:169"),
               "dct_zz": ("pixo_tpu_torch/csrc/coeffs.cu", "pixo_tpu/ops/pallas_kernels.py:169"),
               "trellis_quantize": ("pixo_tpu_torch/csrc/trellis.cu", "pixo_tpu/ops/trellis_device.py:179"),
               "compact": ("pixo_tpu_torch/csrc/compact.cu", "pixo_tpu/ops/sparse_pack.py:117"),
               "count_symbols": ("pixo_tpu_torch/csrc/huffman.cu", "pixo_tpu/ops/huffman_device.py:73"),
               "filter_rows": ("pixo_tpu_torch/csrc/filter_bank.cu",
                               "pixo_tpu/ops/pallas_kernels.py:57"),
               "idct_planes": ("pixo_tpu_torch/csrc/idct.cu", "pixo_tpu/ops/pallas_kernels.py:187"),
               "resize_lanczos3": ("pixo_tpu_torch/csrc/resize.cu",
                                   "pixo_tpu/ops/resize_kernels.py:154"),
               "kmeans_refine": ("pixo_tpu_torch/csrc/quantize.cu", "pixo_tpu/ops/quantize_device.py:67"),
               "palette_lut": ("pixo_tpu_torch/csrc/quantize.cu", "pixo_tpu/ops/quantize_device.py:118"),
               "dither_fs": ("pixo_tpu_torch/csrc/quantize.cu", "pixo_tpu/ops/quantize_device.py:138"),
               "chain_candidates": ("pixo_tpu_torch/csrc/lz77.cu", "pixo_tpu/ops/lz77_assist.py:85"),
               "adler32": ("pixo_tpu_torch/csrc/adler32.cu", "pixo_tpu/compress/checksums.py:89"),
               "unfilter": ("pixo_tpu_torch/csrc/unfilter.cu", "pixo_tpu/ops/png_unfilter.py:29")}
    print(json.dumps({"stream": stream_ms, "service": service_rps, "cli_launches": cli_launches,
                      "playground_launches": playground_launches}))
    timed = ("at", "ms", "plain_ms", "device_ms", "launch_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], "launches_per_call": launches[name],
         "max_abs_err": errs[name], **{k: k_ms[name][k] for k in timed},
         **({"thumbnail_path": {"launches": thumb_launches[name], "max_abs_err": thumb_errs[name],
                                "shapes": thumb_ms[name]}} if name in thumb_ms else {}),
         **({"q2": {"launches": lossy_launches["q2"][name], **{k: k_ms["q2"][name][k] for k in timed}}}
            if name in LOSSY_KERNELS else {}),
         **({"m2": {"launches": max_launches["m2"][name], **{k: k_ms["m2"][name][k] for k in timed}}}
            if name in ("dct_zz", "trellis_quantize") else {}),
         **({"e": {"launches": max_png_launches[name], **{k: k_ms["e"][name][k] for k in timed}}}
            if name in max_png_launches else {}),
         **({"16 MiB": {k: k_ms[name]["16 MiB"][k] for k in timed}} if "16 MiB" in k_ms[name] else {}),
         **({"critical_path": k_ms[name]["critical_path"]} if "critical_path" in k_ms[name] else {}),
         **({"stream": {"launches": stream_launches[name]}} if name in stream_launches else {})}
        for name, (src, replaces) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
