"""Batched JPEG and PNG encode, the JPEG streams, batched decode and the
thumbnail pipeline.

Counterpart of the JAX package's ``parallel/pipeline.py``, for the device
named by ``device=``, or, where a function takes ``mesh=``
(``parallel/mesh.py``), for each device of the mesh on its contiguous shard
of the batch (a mesh and an explicit ``device`` together raise):

- ``jpeg_coeffs_sharded``: the whole batch's zigzag coefficients in one
  device call (``jpeg/encoder.py::_device_coeffs_batch``).
- ``encode_jpeg_batch_sharded``: three stages, which the streams reuse:
  ``_device_stage`` (the pixels up through pinned memory, the kernels
  launched without waiting, an event after the last), ``_fetch`` (the
  copies back into pinned buffers on a copy stream that waits on that
  event) and ``_pack_shard`` (host packing on a thread pool). By route:
  - the baseline encode with the standard tables: device compaction
    (``ops/kernels.py::compact_padded``), one copy of the compacted streams
    to the host, and native entropy packing on a thread pool (ctypes
    releases the GIL, so the threads pack in parallel), then the marker
    frame;
  - optimized or optimal Huffman (the balanced preset): the symbol
    histograms of every image on the still-resident coefficients
    (``ops/kernels.py::count_symbols``, one launch a batch), then the same
    compaction and copy, the histograms with the streams; on the pool each
    image's tables (``jpeg/encoder.py::tables_from_counts``), its pack with
    them and its frame;
  - progressive (with or without successive approximation): one dense copy
    of the coefficients to the host, then each image's
    ``jpeg/encoder.py::_emit_with_sa_fallback`` on the pool, as the
    reference's general path does;
  - progressive with the trellis (the ``max`` preset): no quantized
    coefficients; the unquantized zigzag DCT of the batch
    (``ops/kernels.py::dct_zz``, one launch), then the trellis once for the
    batch (``trellis_coeffs_sharded``): on a card the trellis kernel
    (``trellis_quantize``, one launch, one copy of the int16 back); with
    ``device="cpu"`` the host library's DP on the pool's threads; then the
    progressive scans per image on the pool.
- ``encode_png_batch_sharded``: the batch goes to the device once; the
  reduction analysis, each group's layout transform and the fused filter
  kernel (``ops/kernels.py::filter_rows``, Bigrams too: the ``max`` preset)
  run there; one copy per group brings the filtered rows back, and native
  DEFLATE (the optimal parse under ``max``) and chunk framing run on a
  thread pool. Images whose layout depends on their content (palette,
  sub-8-bit gray) take the per-image ``png.encode`` on the same pool, and so
  do interlaced and 16-bit batches, image by image. With quantization
  (FORCE or AUTO), the images to quantize go through
  ``png/quantize.py::quantize_batch`` (histograms and median cut on the host;
  k-means, LUT and dither for the whole batch on the device), then
  ``encode_indexed`` on the pool; the others take ``png.encode`` there.
- ``encode_png_row_sharded``: one image whose filter stage is one
  ``filter_rows`` launch on its rows; on one device a row split exchanges
  no halo, so the JAX package's sharded dispatch is that launch.

- ``decode_jpeg_batch`` and ``decode_png_batch``: the aliases of
  ``decode.decode_jpeg_batch`` and ``decode.decode_png_batch`` under the
  reference's ``host_workers`` keyword.
- ``thumbnail_pipeline``: decode -> Lanczos3 resize -> baseline JPEG
  re-encode, chunk by chunk. A chunk's JPEG inputs are decoded as one batch
  whose pixels stay on the device (``decode.jpeg_decoder._device_tail``); PNG
  and PNM inputs decode on host threads and go up in one copy a shape group;
  each shape group is resized there (``ops/kernels.py::resize_lanczos3``)
  into its rows of the chunk's thumbnails, which feed ``coeffs`` and
  ``compact_padded`` directly: between the decode and the compaction no pixel
  crosses to the host, only the compacted streams of the thumbnails do. It
  is the one-device form of the reference's fused thumbnail dispatch
  (``_fused_thumb_jit``).

- ``encode_jpeg_stream`` and ``encode_jpeg_stream_overlapped``: the batch
  encode over an iterable of batches, batch i + 1's device stage in flight
  while batch i is fetched and packed (double-buffered on the calling
  thread), or each stage on a thread of its own with ``depth`` batches
  between them and per-stage intervals in ``stats`` (overlapped).

Every JPEG and PNG encode option is ported.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import functools
import time
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..cli import load_image
from ..color import ColorType
from ..decode import decode_jpeg_batch as _decode_jpeg_batch
from ..decode import decode_png_batch as _decode_png_batch
from ..decode import JpegImage, PngImage
from ..decode import jpeg_decoder as jdec
from ..jpeg import encoder as jenc
from ..jpeg import markers
from ..jpeg.tables import HuffmanTables, QuantizationTables
from ..native import native_pack_scan, native_pack_scan_padded, native_trellis_quantize
from ..options import JpegOptions, PngOptions, QuantizationMode
from ..ops.blockify import scan_layout
from ..ops.kernels import (compact_padded, count_symbols, dct_zz, filter_rows, trellis_quantize,
                           upload_pinned)
from ..ops.resize_kernels import resize_lanczos3_batch
from ..ops.reduce_analysis import analyze_png_batch, transform_png_group
from ..ops.sparse_pack import PADDED_CAP_PER_BLOCK, PADDED_CAP_TIERS
from ..png import chunks as pchunks
from ..png import encoder as penc
from ..png.quantize import quantize_batch
from .mesh import DEFAULT_DEVICE, Mesh, placement


def _color_sub(options: JpegOptions):
    color = "gray" if options.color_type == ColorType.GRAY else "rgb"
    return color, options.subsampling.value


def _to_device(imgs, device) -> torch.Tensor:
    """``imgs`` (numpy array or tensor) on ``device``, contiguous. From the
    host to a card the copy goes through pinned memory on the current stream
    and does not wait (``upload_pinned``); a tensor already on ``device``
    stays where it is."""
    dev = torch.device(device)
    if torch.is_tensor(imgs):
        if imgs.device.type != "cpu" or dev.type != "cuda":
            return imgs.to(dev).contiguous()
        imgs = imgs.numpy()
    if dev.type != "cuda":
        return torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
    return upload_pinned(imgs, dev)


def _coeffs(x: torch.Tensor, options: JpegOptions) -> torch.Tensor:
    """[B, nblocks, 64] int16 zigzag coefficients of the batch ``x`` on its
    device."""
    quant = QuantizationTables(options.quality)
    color, sub = _color_sub(options)
    return jenc._device_coeffs_batch(x, quant.luminance_table, quant.chrominance_table,
                                     color=color, subsampling=sub)


def jpeg_coeffs_sharded(imgs, options: JpegOptions, *, mesh: Optional[Mesh] = None,
                        device=DEFAULT_DEVICE) -> torch.Tensor:
    """[B, H, W, C] (or [B, H, W] gray) uint8 numpy array or tensor ->
    [B, nblocks, 64] int16 zigzag coefficients on ``device``; with ``mesh``,
    each contiguous shard on its device, gathered on the mesh's first one."""
    shards = [_coeffs(_to_device(imgs[lo:hi], dev), options)
              for dev, lo, hi in placement(mesh, device, len(imgs))]
    if mesh is None:
        return shards[0]
    return torch.cat([s.to(mesh.devices[0]) for s in shards])


def _use_sparse_fast_path(options: JpegOptions) -> bool:
    """True for the baseline standard-table encode (``trellis_quant`` does
    not change a baseline encode's bytes: its scan never reads the trellis)."""
    return not (options.optimize_huffman or options.optimal_huffman or options.progressive)


def _trellis_device(x: torch.Tensor, options: JpegOptions, host_workers: int) -> torch.Tensor:
    """[B, nblocks, 64] int16 trellis-quantized zigzag coefficients of the
    batch ``x``, where ``x`` lies: the unquantized DCT in one call, then the
    trellis of the whole batch once, on a card the trellis kernel, on the CPU
    the host library's DP on ``host_workers`` threads."""
    quant = QuantizationTables(options.quality)
    n_blocks, pattern = jenc._pattern(options)
    dct = dct_zz(x, jenc._mode(options))
    b = dct.shape[0]
    flat = dct.reshape(b * n_blocks, 64)
    tables = jenc.zigzag_tables(quant)
    if flat.device.type == "cpu":
        zz = torch.from_numpy(native_trellis_quantize(flat.numpy(), pattern, *tables,
                                                      nthreads=host_workers))
    else:
        zz = trellis_quantize(flat, *tables, pattern)
    return zz.reshape(b, n_blocks, 64)


def trellis_coeffs_sharded(imgs, options: JpegOptions, *, device="cuda",
                           host_workers: int = 8) -> np.ndarray:
    """[B, H, W, C] (or [B, H, W] gray) uint8 -> [B, nblocks, 64] int16
    trellis-quantized zigzag coefficients on the host: the unquantized DCT on
    ``device`` in one call, then the trellis of the whole batch once, where
    the DCT lies: on a card the trellis kernel and one copy of its result;
    on the CPU the host library's DP on ``host_workers`` threads."""
    zz = _trellis_device(_to_device(imgs, device), options, host_workers)
    return _fetch(_Shard(zz, None, None, _recorded(zz)))[0][1]


class _Shard(NamedTuple):
    """One shard of a batch after its device stage (``_device_stage``)."""

    zz: torch.Tensor  # [b, nblocks, 64] int16: the quantized (or trellis) coefficients
    compacted: Optional[tuple]  # compact_padded's six outputs; None on the progressive routes
    counts: Optional[tuple]  # count_symbols' (dc, ac) histograms; None for the standard tables
    done: Optional[torch.cuda.Event]  # recorded after the shard's last launch; None on the CPU


def _recorded(t: torch.Tensor) -> Optional[torch.cuda.Event]:
    """An event recorded now on the current stream of ``t``'s card (the
    stream the wrappers launched on); None for a tensor off the card."""
    if t.device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return done


def _device_stage(imgs, options: JpegOptions, device, host_workers: int) -> _Shard:
    """The device stage of one shard, by route, launched without waiting:
    the pixels up, then the standard tables' ``coeffs`` + ``compact``, the
    optimized or optimal tables' ``coeffs`` + ``count_symbols`` +
    ``compact``, progressive's ``coeffs`` alone, or the max preset's
    ``dct_zz`` + ``trellis_quantize``."""
    x = _to_device(imgs, device)
    counts = compacted = None
    if options.progressive:
        # the progressive pass reads only the trellis' coefficients where it runs
        zz = _trellis_device(x, options, host_workers) if options.trellis_quant else _coeffs(x, options)
    else:
        zz = _coeffs(x, options)
        if not _use_sparse_fast_path(options):
            counts = count_symbols(zz, jenc._pattern(options)[1], options.restart_interval)
        compacted = compact_padded(zz, PADDED_CAP_PER_BLOCK)
    return _Shard(zz, compacted, counts, _recorded(zz))


def _landed(tensors, stream) -> list:
    """Copies of the card's ``tensors`` into pinned host buffers, made on
    ``stream`` (which waits for the shard already), then one wait for them
    all: numpy arrays that share the pinned memory."""
    host = []
    for t in tensors:
        t.record_stream(stream)  # the allocator keeps t until the copy has run
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    stream.synchronize()
    return [h.numpy() for h in host]


def _fetch(shard: _Shard, stream=None):
    """d2h stage of one shard: (state, hist), ``state`` ("padded", dc,
    counts, poss, vals) or ("dense", zz) and ``hist`` the (dc, ac)
    histograms or None, as numpy arrays, for ``_pack_shard``.

    On a card every copy runs on ``stream`` (a copy stream of the shard's
    card; a new one when None), which first waits on the shard's
    event, so a later batch's work on the compute stream is not waited for.
    The maxcount, the four compacted arrays and the histograms go to pinned
    buffers in one group with one wait. Where a block holds more nonzeros
    than the cap, the still-resident coefficients are compacted again at the
    smallest tier that holds the measured maxcount, on ``stream``, and copied
    again; above the top tier the dense coefficients come back instead."""
    if shard.done is None:
        state = (("dense", shard.zz.cpu().numpy()) if shard.compacted is None
                 else _fetch_compacted(shard.zz, shard.compacted))
        return state, None if shard.counts is None else tuple(h.cpu().numpy() for h in shard.counts)
    zz = shard.zz
    stream = stream or torch.cuda.Stream(zz.device)
    with torch.cuda.stream(stream):
        stream.wait_event(shard.done)
        zz.record_stream(stream)
        if shard.compacted is None:
            return ("dense", _landed([zz], stream)[0]), None
        dc, counts, poss, vals, _total, maxcount = shard.compacted
        maxc, *arrays = _landed([maxcount, dc, counts, poss, vals, *(shard.counts or ())], stream)
        state, hist = ("padded", *arrays[:4]), (tuple(arrays[4:]) or None)
        cap, maxc = poss.shape[2], int(maxc.max())
        if maxc > cap:
            tier = next((t for t in PADDED_CAP_TIERS if t > cap and maxc <= t), None)
            if tier is None:
                state = ("dense", _landed([zz], stream)[0])
            else:
                state = ("padded", *_landed(compact_padded(zz, tier)[:4], stream))
    return state, hist


def _fetch_compacted(zz_dev: torch.Tensor, compacted):
    """d2h stage of a compaction launched on the current stream: the
    compacted streams (or, above the top cap tier, the dense coefficients)
    on the host, escalating the cap as ``_fetch`` does. Returns ("padded",
    dc, counts, poss, vals) or ("dense", zz) as numpy arrays, for
    ``_pack_hosted``."""
    if zz_dev.device.type == "cuda":
        return _fetch(_Shard(zz_dev, compacted, None, _recorded(zz_dev)))[0]
    dc, counts, poss, vals, _total, maxcount = compacted
    cap = poss.shape[2]
    maxc = int(maxcount.max())
    if maxc > cap:
        tier = next((t for t in PADDED_CAP_TIERS if t > cap and maxc <= t), None)
        if tier is None:
            return ("dense", zz_dev.cpu().numpy())
        dc, counts, poss, vals, _total, maxcount = compact_padded(zz_dev, tier)
    return ("padded", dc.cpu().numpy(), counts.cpu().numpy(), poss.cpu().numpy(), vals.cpu().numpy())


@contextlib.contextmanager
def _pool_of(pool):
    """``pool`` itself where it is an executor, else a pool of ``pool``
    threads for the block."""
    if isinstance(pool, concurrent.futures.Executor):
        yield pool
    else:
        with concurrent.futures.ThreadPoolExecutor(max_workers=pool) as ex:
            yield ex


def _pack_hosted(state, options: JpegOptions, pattern, pool, tables=None) -> List[bytes]:
    """Pack stage: entropy-pack the host-resident streams of every image on
    ``pool`` (an executor, or a number of threads for a pool of this call's
    own). Pure host work, no device waits. ``tables``: None for the standard
    tables, else a function of the image index that returns its tables,
    called in that image's task."""
    if state[0] == "dense":
        zz = state[1]

        def pack_one(i: int) -> bytes:
            huff = HuffmanTables.default() if tables is None else tables(i)
            return native_pack_scan(zz[i], pattern, huff, options.restart_interval)

        n = zz.shape[0]
    else:
        _, dc, counts, poss, vals = state

        def pack_one(i: int) -> bytes:
            return native_pack_scan_padded(
                dc[i], counts[i], poss[i], vals[i], pattern,
                HuffmanTables.default() if tables is None else tables(i), options.restart_interval,
            )

        n = dc.shape[0]
    with _pool_of(pool) as ex:
        return list(ex.map(pack_one, range(n)))


def _assemble_jpeg(scan: bytes, options: JpegOptions, quant: QuantizationTables,
                   huff: Optional[HuffmanTables] = None) -> bytes:
    """Wrap a baseline entropy scan in the JPEG marker frame, with the
    tables ``huff`` it was packed with (the standard ones by default)."""
    out = bytearray()
    markers.write_soi(out)
    markers.write_app0(out)
    markers.write_dqt(out, quant)
    markers.write_sof(
        out, markers.SOF0, options.width, options.height,
        options.color_type, options.subsampling,
    )
    markers.write_dht(out, HuffmanTables.default() if huff is None else huff)
    if options.restart_interval is not None:
        markers.write_dri(out, options.restart_interval)
    markers.write_sos(out, options.color_type)
    out += scan
    markers.write_eoi(out)
    return bytes(out)


def _pack_shard(host, options: JpegOptions, pool) -> List[bytes]:
    """Host stage of one shard from ``_fetch``'s (state, hist): the files of
    its images, in order, packed on the executor ``pool``. Progressive: each image's
    scans (``_emit_with_sa_fallback``); the standard tables: the padded or
    dense pack and the frame; optimized or optimal tables: each image's
    tables from its histograms in its own task, its pack with them and its
    frame."""
    state, hist = host
    quant = QuantizationTables(options.quality)
    n_blocks, pattern = jenc._pattern(options)
    if options.progressive:
        zz = state[1]
        return list(pool.map(lambda i: jenc._emit_with_sa_fallback(
            zz[i], None, options, quant, pattern, n_blocks), range(zz.shape[0])))
    if hist is None:
        return [_assemble_jpeg(s, options, quant) for s in _pack_hosted(state, options, pattern, pool)]
    dc, ac = hist
    # each image's tables are built in its pack task (Python, under the GIL)
    # and kept for its frame
    tables = functools.lru_cache(maxsize=None)(lambda i: jenc.tables_from_counts(dc[i], ac[i], options))
    scans = _pack_hosted(state, options, pattern, pool, tables)
    return [_assemble_jpeg(s, options, quant, tables(i)) for i, s in enumerate(scans)]


def _validate_batch(imgs, options: JpegOptions) -> None:
    jenc._validate(options, imgs[0].numel() if torch.is_tensor(imgs) else imgs[0].size)


def _dispatch(imgs, options: JpegOptions, mesh, device, host_workers: int) -> List[_Shard]:
    """The device stage of every shard of one batch (``placement``)."""
    return [_device_stage(imgs[lo:hi], options, dev, host_workers)
            for dev, lo, hi in placement(mesh, device, len(imgs))]


class _CopyStreams(dict):
    """A copy stream per card, made at its first use."""

    def __missing__(self, device: torch.device):
        self[device] = stream = torch.cuda.Stream(device)
        return stream


def _fetch_all(shards: List[_Shard], streams: _CopyStreams) -> list:
    return [_fetch(s, None if s.done is None else streams[s.zz.device]) for s in shards]


def _pack_all(hosts: list, options: JpegOptions, pool) -> List[bytes]:
    return [f for host in hosts for f in _pack_shard(host, options, pool)]


def encode_jpeg_batch_sharded(
    imgs, options: JpegOptions, *, mesh: Optional[Mesh] = None, device=DEFAULT_DEVICE,
    host_workers: int = 8,
) -> List[bytes]:
    """Encode a batch of same-shape images ([B, H, W, 3] RGB or [B, H, W]
    gray uint8, numpy or tensor) to JPEG bytes, computing on ``device``
    ("cpu" or a CUDA device), or on each device of ``mesh`` for its
    contiguous shard, and entropy-coding on the host with ``host_workers``
    threads.

    Byte-identical, image by image, to the JAX package's ``jpeg.encode``."""
    if len(imgs) == 0:
        return []
    _validate_batch(imgs, options)
    shards = _dispatch(imgs, options, mesh, device, host_workers)
    with concurrent.futures.ThreadPoolExecutor(max_workers=host_workers) as pool:
        return _pack_all(_fetch_all(shards, _CopyStreams()), options, pool)


def encode_jpeg_stream(batches, options: JpegOptions, *, mesh: Optional[Mesh] = None,
                       device=DEFAULT_DEVICE, host_workers: int = 8):
    """Double-buffered encode of an iterable of batches (each as
    ``encode_jpeg_batch_sharded`` takes it): while the host fetches and packs
    batch i, the card already runs batch i + 1, whose pixels went up through
    pinned memory and whose kernels were launched without waiting; batch
    i's copies back run on a copy stream that waits only on batch i's event.
    One pool of ``host_workers`` threads packs every batch. Yields each
    batch's list of files, in input order, each byte-equal to
    ``encode_jpeg_batch_sharded``'s."""
    streams = _CopyStreams()
    prev = None
    with concurrent.futures.ThreadPoolExecutor(max_workers=host_workers) as pool:
        for imgs in batches:
            if len(imgs):
                _validate_batch(imgs, options)
            nxt = _dispatch(imgs, options, mesh, device, host_workers) if len(imgs) else []
            if prev is not None:
                yield _pack_all(_fetch_all(prev, streams), options, pool)
            prev = nxt
        if prev is not None:
            yield _pack_all(_fetch_all(prev, streams), options, pool)


def encode_jpeg_stream_overlapped(batches, options: JpegOptions, *, mesh: Optional[Mesh] = None,
                                  device=DEFAULT_DEVICE, host_workers: int = 8, depth: int = 2,
                                  stats: Optional[dict] = None):
    """Three-stage overlapped encode of an iterable of batches, every stage in
    flight at once:

    - **device** (the calling thread): batch i + 2's pixels up through pinned
      memory and its kernels, launched on the current stream without waiting,
      then an event;
    - **copy** (a thread of its own, ``_fetch``): batch i + 1's copies back on
      a copy stream that waits on that batch's event alone (the cap
      escalation's second compaction runs there too); the only stage that
      waits on the card;
    - **pack** (a coordinator thread and a pool of ``host_workers``
      threads): batch i's files from host-resident arrays.

    Up to ``depth`` batches may queue between consecutive stages. Yields
    each batch's list of files, in input order, each byte-equal to
    ``encode_jpeg_batch_sharded``'s.

    ``stats``, when given, receives ``dispatch_t`` (the wall-clock start of
    each batch's device stage), ``copy_iv`` and ``pack_iv`` (each batch's
    (start, end) in its stage), in ``time.perf_counter`` seconds: busy sums
    past the wall clock show the stages in flight together."""
    dispatch_t: List[float] = []
    copy_iv: List[tuple] = []
    pack_iv: List[tuple] = []
    streams = _CopyStreams()

    def fetch(shards):
        t0 = time.perf_counter()
        hosts = _fetch_all(shards, streams)
        copy_iv.append((t0, time.perf_counter()))
        return hosts

    def pack(copy_fut, pool) -> List[bytes]:
        hosts = copy_fut.result()
        t0 = time.perf_counter()
        outs = _pack_all(hosts, options, pool)
        pack_iv.append((t0, time.perf_counter()))
        return outs

    copy_futs: collections.deque = collections.deque()
    pack_futs: collections.deque = collections.deque()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="d2h") as copy_ex, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="pack-coord") as coord_ex, \
            concurrent.futures.ThreadPoolExecutor(max_workers=host_workers, thread_name_prefix="pack") as pool:

        def drain(force: bool):
            while copy_futs and (force or len(copy_futs) > depth or copy_futs[0].done()):
                pack_futs.append(coord_ex.submit(pack, copy_futs.popleft(), pool))
            while pack_futs and (force or len(pack_futs) > depth or pack_futs[0].done()):
                yield pack_futs.popleft().result()

        for imgs in batches:
            dispatch_t.append(time.perf_counter())
            if len(imgs):
                _validate_batch(imgs, options)
            shards = _dispatch(imgs, options, mesh, device, host_workers) if len(imgs) else []
            copy_futs.append(copy_ex.submit(fetch, shards))
            yield from drain(False)
        yield from drain(True)

    if stats is not None:
        stats["dispatch_t"] = dispatch_t
        stats["copy_iv"] = copy_iv
        stats["pack_iv"] = pack_iv


def _png_route_batch(px: torch.Tensor, options: PngOptions):
    """Route each image to a fused-batch group or the per-image path.

    ``px`` is the batch as [B, N, bpp] uint8 on its device. Mirrors the
    decision order of ``png/reduce.py::maybe_reduce_color_type`` (pixo
    ``src/png/mod.rs:683-836``): palette screen first, then gray/opacity
    reductions. Returns (groups, fallback_idx): groups maps (mode,
    out_color_type) -> host index array; an image is grouped only when the
    device predicates prove the per-image encoder would take exactly that
    layout (so grouped bytes == per-image bytes).
    """
    b = px.shape[0]
    ct = options.color_type
    idx = np.arange(b)

    if ct in (ColorType.GRAY, ColorType.GRAY_ALPHA):
        return {("pass", ct): idx}, idx[:0]
    if not (options.reduce_color_type or options.reduce_palette):
        return {("pass", ct): idx}, idx[:0]

    all_gray, all_opaque, palette_possible = analyze_png_batch(px)
    fallback = palette_possible.copy() if options.reduce_palette else np.zeros(b, bool)

    groups = {}
    if ct == ColorType.RGB:
        if options.reduce_color_type:
            fallback |= all_gray
        keep = idx[~fallback]
        if keep.size:
            groups[("pass", ct)] = keep
        return groups, idx[fallback]

    # RGBA
    if options.reduce_color_type:
        fallback |= all_opaque & all_gray  # gray path: sub-8-bit packing
        strip = ~fallback & all_opaque
        ga = ~fallback & ~all_opaque & all_gray
        plain = ~fallback & ~all_opaque & ~all_gray
        if strip.any():
            groups[("strip", ColorType.RGB)] = idx[strip]
        if ga.any():
            groups[("ga", ColorType.GRAY_ALPHA)] = idx[ga]
        if plain.any():
            groups[("pass", ct)] = idx[plain]
    else:
        keep = idx[~fallback]
        if keep.size:
            groups[("pass", ct)] = keep
    return groups, idx[fallback]


def png_group_rows(px: torch.Tensor, gidx: np.ndarray, mode: str, out_ct: ColorType,
                   options: PngOptions) -> torch.Tensor:
    """Layout stage of one group: the images ``gidx`` of the [B, N, bpp]
    batch ``px``, in the group's layout -> [Bg, H, RB] uint8 raw rows on
    ``px``'s device."""
    opt_alpha = options.optimize_alpha and out_ct in (ColorType.RGBA, ColorType.GRAY_ALPHA)
    sel = px if len(gidx) == px.shape[0] else px[torch.as_tensor(gidx, device=px.device)]
    payload = sel if mode == "pass" and not opt_alpha else transform_png_group(sel, mode, opt_alpha)
    return payload.reshape(len(gidx), options.height, options.width * out_ct.bytes_per_pixel)


def png_filter_kwargs(out_ct: ColorType, options: PngOptions) -> dict:
    """The filter stage's arguments for a group of color type ``out_ct``."""
    w, h = options.width, options.height
    return dict(bpp=out_ct.bytes_per_pixel, strategy=options.filter_strategy,
                small_image=w * h <= 4096, sticky_fast=h <= 32)


def png_frame(filtered: np.ndarray, out_ct: ColorType, options: PngOptions, device="cuda") -> bytes:
    """Host stage of one grouped image: DEFLATE its filtered rows and frame
    the file (signature, IHDR, IDAT, IEND); the optimal DEFLATE's
    ``PIXO_TPU_LZ77=device`` route runs on ``device``."""
    out = bytearray()
    out += pchunks.PNG_SIGNATURE
    pchunks.write_ihdr(out, options.width, options.height, 8, out_ct.png_color_type)
    return penc._finish(out, filtered, options, device)


def encode_png_batch_sharded(
    imgs, options: PngOptions, *, device="cuda", host_workers: int = 8
) -> List[bytes]:
    """Encode a batch of same-shape images ([B, H, W, C] uint8, numpy or
    tensor; C the bytes per pixel of ``options.color_type``; at 16-bit
    numpy uint16 or big-endian bytes) to PNG bytes, computing on ``device``
    ("cpu" or a CUDA device) and compressing on the host with
    ``host_workers`` threads.

    Byte-identical, image by image, to the JAX package's
    ``encode_png_batch_sharded`` and ``png.encode``. Interlaced and 16-bit
    batches take the per-image ``png.encode`` on the pool (Adam7 filters by
    pass, and 16-bit has no 8-bit reductions to group by). With
    ``options.quantization.mode`` FORCE or AUTO, each image's decision is
    made on the host (FORCE: every RGB or RGBA image; AUTO: those that
    ``should_quantize_auto`` accepts), the images to quantize go through one
    ``quantize_batch`` on ``device`` and ``encode_indexed`` on the pool, and
    the others through the per-image ``png.encode`` there."""
    b = len(imgs)
    if b == 0:
        return []
    if options.interlace or options.bit_depth != 8:
        host = imgs.cpu().numpy() if torch.is_tensor(imgs) else imgs
        with concurrent.futures.ThreadPoolExecutor(max_workers=host_workers) as ex:
            return list(ex.map(lambda img: penc.encode(img, options, device=device), host))
    if imgs.dtype not in (np.uint8, torch.uint8):
        raise TypeError(f"imgs must be uint8, got {imgs.dtype}")
    bpp = options.color_type.bytes_per_pixel
    penc._validate(options, imgs[0].numel() if torch.is_tensor(imgs) else imgs[0].size)
    if options.quantization.mode != QuantizationMode.OFF:
        return _encode_png_lossy(imgs, options, device, host_workers)
    px = _to_device(imgs, device).reshape(b, -1, bpp)
    groups, fallback_idx = _png_route_batch(px, options)

    def fallback_encode(i: int) -> bytes:
        img = imgs[i].cpu().numpy() if torch.is_tensor(imgs) else imgs[i]
        return penc.encode(img, options, device=device)

    results: List[bytes] = [b""] * b
    with concurrent.futures.ThreadPoolExecutor(max_workers=host_workers) as ex:
        futures = {i: ex.submit(fallback_encode, i) for i in fallback_idx}
        for (mode, out_ct), gidx in groups.items():
            raw = png_group_rows(px, gidx, mode, out_ct, options)
            filtered = filter_rows(raw, **png_filter_kwargs(out_ct, options)).cpu().numpy()
            for i, filt in zip(gidx, filtered):
                futures[i] = ex.submit(png_frame, filt, out_ct, options, device)
        for i, fut in futures.items():
            results[i] = fut.result()
    return results


def _encode_png_lossy(imgs, options: PngOptions, device, host_workers: int) -> List[bytes]:
    """The quantization branch of ``encode_png_batch_sharded`` (the
    reference's ``pipeline.py:405-460``)."""
    host = imgs.cpu().numpy() if torch.is_tensor(imgs) else np.ascontiguousarray(imgs)
    b, w, h = len(host), options.width, options.height
    bpp = options.color_type.bytes_per_pixel
    px = host.reshape(b, h, w, bpp)
    quant_ids = [i for i in range(b) if penc.quantize_decision(px[i].reshape(-1, bpp), options)]
    quantized = (quantize_batch(px[quant_ids], penc.max_colors(options),
                                options.quantization.dithering, device=device)
                 if quant_ids else [])
    with concurrent.futures.ThreadPoolExecutor(max_workers=host_workers) as ex:
        futures = {i: ex.submit(penc.encode, px[i], options, device=device)
                   for i in sorted(set(range(b)) - set(quant_ids))}
        for i, (palette, indices) in zip(quant_ids, quantized):
            futures[i] = ex.submit(penc.encode_quantized, palette, indices, options, device=device)
        return [futures[i].result() for i in range(b)]


def encode_png_row_sharded(img, options: PngOptions, *, device="cuda") -> bytes:
    """Encode one image with its filter stage on ``device``: the image's rows
    as a batch of one through ``filter_rows`` (one launch), the rest of
    ``png.encode`` (reductions, DEFLATE, framing) on the host, so the bytes
    equal ``png.encode``'s. The JAX package shards the rows over a mesh and
    XLA exchanges each shard's row above; on one device there is no halo.
    Interlaced output filters by Adam7 pass and takes the ordinary path."""
    if options.interlace:
        return penc.encode(img, options, device=device)

    def row_filter(payload, w: int, h: int, row_bytes: int, bpp: int, strategy) -> bytes:
        rows = torch.from_numpy(np.frombuffer(payload, np.uint8).reshape(1, h, row_bytes).copy())
        out = filter_rows(rows.to(device), bpp=bpp, strategy=strategy, small_image=w * h <= 4096,
                          sticky_fast=h <= 32)
        return out.cpu().numpy().tobytes()

    return penc.encode(img, options, filter_fn=row_filter, device=device)


def decode_jpeg_batch(encoded: Sequence[bytes], host_workers: int = 8, *,
                      device="cuda") -> List[JpegImage]:
    """Batched JPEG decode on ``device``: the alias of
    ``pixo_tpu_torch.decode.decode_jpeg_batch`` (which also takes
    ``fancy_upsampling``), kept for the reference's ``host_workers``
    keyword."""
    return _decode_jpeg_batch(encoded, workers=host_workers, device=device)


def decode_png_batch(encoded: Sequence[bytes], host_workers: int = 8) -> List[PngImage]:
    """Threaded batched PNG decode on the host: the alias of
    ``pixo_tpu_torch.decode.decode_png_batch`` (which also takes
    ``keep_bit_depth``), kept for the reference's ``host_workers`` keyword."""
    return _decode_png_batch(encoded, workers=host_workers)


def _to_rgb(px: torch.Tensor) -> torch.Tensor:
    """[..., C] pixels -> [..., 3] on the same device: alpha dropped, gray
    (with or without alpha) repeated."""
    c = px.shape[-1]
    if c == 4:
        return px[..., :3].contiguous()
    if c in (1, 2):
        return px[..., :1].expand(*px.shape[:-1], 3).contiguous()
    return px


def _thumb_decode(files: Sequence[bytes], loaded: Sequence, host_workers: int, dev: torch.device):
    """Host decode stage of one chunk. ``loaded[k]`` is the future of
    ``load_image(files[k])`` for an input that is no JPEG, else None. The
    chunk's JPEG files go through the batch decoder's host stages together.
    Returns (the JPEGs' host batch or None, their positions in the chunk,
    [(position, pixels)] of the other inputs); raises the error of the first
    input, in order, that fails, as decoding one by one would."""
    jpegs = [k for k, fut in enumerate(loaded) if fut is None]
    batch, failures = None, {}
    if jpegs:
        try:
            batch = jdec._host_stage([files[k] for k in jpegs], host_workers,
                                     pinned=dev.type == "cuda")
        except Exception as e:  # noqa: BLE001 - raised again below, in input order
            failures[jpegs[getattr(e, "file_index", 0)]] = e
    others = []
    for k, fut in enumerate(loaded):
        if fut is None:
            continue
        if fut.exception() is not None:
            failures[k] = fut.exception()
        else:
            others.append((k, fut.result()[0]))
    if failures:
        raise failures[min(failures)]
    return batch, jpegs, others


def _thumb_resize(batch, jpegs, others, thumb_size: int, dev: torch.device) -> torch.Tensor:
    """Device stage of one chunk up to the thumbnails: the JPEGs' pixel tail
    (their pixels stay on ``dev``), one copy up for each shape group of the
    other inputs, then per shape group ``_to_rgb`` and the Lanczos3 resize
    into the group's rows of one [n, T, T, 3] uint8 tensor on ``dev``. A
    group that is ``thumb_size`` square already goes through the resize too,
    as in the reference: its pass at scale 1 is what the bytes are held to."""
    groups = []  # (positions in the chunk, [m, H, W, C] pixels on dev)
    if batch is not None:
        pixels = jdec._device_tail(batch, False, dev)
        for members, shape, first in jdec._pixel_groups(batch):
            h, w = shape[:2]
            block = pixels[first: first + len(members) * int(np.prod(shape))]
            groups.append(([jpegs[i] for i in members], block.view(len(members), h, w, -1)))
    by_shape: dict = {}
    for k, px in others:
        by_shape.setdefault(px.shape, []).append((k, px))
    for items in by_shape.values():
        stacked = torch.from_numpy(np.stack([px for _, px in items]))
        groups.append(([k for k, _ in items], stacked.to(dev)))

    n = len(jpegs) + len(others)
    resized = [(rows, resize_lanczos3_batch(_to_rgb(px), dst_w=thumb_size, dst_h=thumb_size))
               for rows, px in groups]
    if len(resized) == 1 and resized[0][0] == list(range(n)):
        return resized[0][1]  # one group in input order: its output is the chunk's
    thumbs = torch.empty((n, thumb_size, thumb_size, 3), dtype=torch.uint8, device=dev)
    for rows, out in resized:
        thumbs[torch.as_tensor(rows, device=dev)] = out
    return thumbs


def thumbnail_pipeline(
    encoded: Sequence[bytes],
    thumb_size: int = 128,
    quality: int = 85,
    host_workers: int = 8,
    chunk_size: int = 64,
    *,
    device="cuda",
    stats: Optional[dict] = None,
) -> List[bytes]:
    """Overlapped decode -> resize -> re-encode (BASELINE.json config #5):
    each input (JPEG, PNG, PPM or PGM bytes) becomes a ``thumb_size`` square
    baseline JPEG at ``quality`` (4:4:4, standard tables), computing on
    ``device`` ("cpu" or a CUDA device). Byte-identical, input by input, to
    the JAX package's ``thumbnail_pipeline``.

    Stage 1 (host): PNG and PNM inputs of the whole call are queued on
    ``host_workers`` threads up front; each chunk's JPEG inputs go through
    the batch decoder's host stages when the chunk's turn comes. Stage 2
    (device): the chunk's pixel tail, resize, coefficients and compaction
    (``_thumb_resize``, then exactly the calls of
    ``encode_jpeg_batch_sharded``). Stage 3 (host threads): the copy of the
    compacted streams and the entropy packing of chunk i run on a thread of
    their own while chunk i + 1 decodes.

    ``stats``, when given, accumulates per-stage wall seconds
    (decode_wait_s, device_s, pack_s). The first input, in order, that fails
    to decode raises its error."""
    dev = torch.device(device)
    jopts = JpegOptions(width=thumb_size, height=thumb_size, quality=quality,
                        color_type=ColorType.RGB)
    quant = QuantizationTables(quality)
    color, sub = _color_sub(jopts)
    _, _, pattern = scan_layout(thumb_size, thumb_size, color, sub)
    n = len(encoded)
    results: List[bytes] = [b""] * n
    timings = {"decode_wait_s": 0.0, "device_s": 0.0, "pack_s": 0.0}

    def device_stage(lo: int, hi: int, loaded):
        t0 = time.perf_counter()
        decoded = _thumb_decode(encoded[lo:hi], loaded[lo:hi], host_workers, dev)
        t1 = time.perf_counter()
        timings["decode_wait_s"] += t1 - t0
        thumbs = _thumb_resize(*decoded, thumb_size, dev)
        zz = jenc._device_coeffs_batch(thumbs, quant.luminance_table, quant.chrominance_table,
                                       color=color, subsampling=sub)
        compacted = compact_padded(zz, PADDED_CAP_PER_BLOCK)
        timings["device_s"] += time.perf_counter() - t1
        return lo, hi, _Shard(zz, compacted, None, _recorded(zz))

    streams = _CopyStreams()

    def pack_stage(state) -> None:
        lo, hi, shard = state
        t0 = time.perf_counter()
        host, _ = _fetch(shard, None if shard.done is None else streams[shard.zz.device])
        scans = _pack_hosted(host, jopts, pattern, host_workers)
        results[lo:hi] = [_assemble_jpeg(s, jopts, quant) for s in scans]
        timings["pack_s"] += time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(max_workers=host_workers) as dec_ex, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as pack_ex:
        # PNG, PPM and PGM inputs (and inputs of no known format, whose error
        # waits for its turn) decode on the host, as load_image decodes them
        loaded = [None if data[:2] == b"\xff\xd8" else dec_ex.submit(load_image, data, device="cpu")
                  for data in encoded]
        packing = None
        for lo in range(0, n, chunk_size):
            cur = device_stage(lo, min(lo + chunk_size, n), loaded)
            if packing is not None:
                packing.result()
            packing = pack_ex.submit(pack_stage, cur)
        if packing is not None:
            packing.result()

    if stats is not None:
        stats.update(timings)
    return results
