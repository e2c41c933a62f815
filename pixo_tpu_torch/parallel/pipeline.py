"""Batched baseline JPEG encode on one device.

Counterpart of the JAX package's ``parallel/pipeline.py``, for one device
named by ``device=`` instead of a mesh:

- ``jpeg_coeffs_sharded``: the whole batch's zigzag coefficients in one
  device call (``jpeg/encoder.py::_device_coeffs_batch``).
- ``encode_jpeg_batch_sharded``: device coefficients, device compaction
  (``ops/kernels.py::compact_padded``), one copy of the compacted streams to
  the host, and native entropy packing on a thread pool (ctypes releases the
  GIL, so the threads pack in parallel), then the marker frame.

Only the baseline path with the standard Huffman tables is ported. The
stream pipelines, PNG batches, decode batches and the thumbnail pipeline
are not (ROADMAP queue 1 items 7, 8, 10 and 12).
"""

from __future__ import annotations

import concurrent.futures
from typing import List

import numpy as np
import torch

from ..color import ColorType
from ..jpeg import encoder as jenc
from ..jpeg import markers
from ..jpeg.tables import HuffmanTables, QuantizationTables
from ..native import native_pack_scan_batch, native_pack_scan_padded
from ..options import JpegOptions
from ..ops.blockify import scan_layout
from ..ops.kernels import compact_padded
from ..ops.sparse_pack import PADDED_CAP_PER_BLOCK, PADDED_CAP_TIERS


def _color_sub(options: JpegOptions):
    color = "gray" if options.color_type == ColorType.GRAY else "rgb"
    return color, options.subsampling.value


def _to_device(imgs, device) -> torch.Tensor:
    if isinstance(imgs, np.ndarray):
        imgs = torch.from_numpy(np.ascontiguousarray(imgs))
    return imgs.to(device).contiguous()


def jpeg_coeffs_sharded(imgs, options: JpegOptions, *, device) -> torch.Tensor:
    """[B, H, W, C] (or [B, H, W] gray) uint8 numpy array or tensor ->
    [B, nblocks, 64] int16 zigzag coefficients on ``device``."""
    color, sub = _color_sub(options)
    quant = QuantizationTables(options.quality)
    return jenc._device_coeffs_batch(
        _to_device(imgs, device), quant.luminance_table, quant.chrominance_table,
        color=color, subsampling=sub,
    )


def _use_sparse_fast_path(options: JpegOptions) -> bool:
    """True for the baseline standard-table encode, the only one ported."""
    return not (
        options.optimize_huffman or options.optimal_huffman
        or options.progressive or options.trellis_quant
    )


def _fetch_compacted(zz_dev: torch.Tensor, compacted):
    """d2h stage: bring the compacted streams (or, above the top cap tier,
    the dense coefficients) to the host. On a per-block overflow it
    re-compacts the still-on-device coefficients at the smallest tier that
    holds the measured maxcount. Returns ("padded", dc, counts, poss, vals)
    or ("dense", zz) as numpy arrays, for ``_pack_hosted``."""
    dc, counts, poss, vals, _total, maxcount = compacted
    cap = poss.shape[2]
    maxc = int(maxcount.max())
    if maxc > cap:
        tier = next((t for t in PADDED_CAP_TIERS if t > cap and maxc <= t), None)
        if tier is None:
            return ("dense", zz_dev.cpu().numpy())
        dc, counts, poss, vals, _total, maxcount = compact_padded(zz_dev, tier)
    return ("padded", dc.cpu().numpy(), counts.cpu().numpy(),
            poss.cpu().numpy(), vals.cpu().numpy())


def _pack_hosted(state, options: JpegOptions, pattern, host_workers: int) -> List[bytes]:
    """Pack stage: entropy-pack the host-resident streams of every image on
    ``host_workers`` threads. Pure host work, no device waits."""
    huff = HuffmanTables.default()
    if state[0] == "dense":
        return native_pack_scan_batch(
            state[1], pattern, huff, options.restart_interval, nthreads=host_workers
        )
    _, dc, counts, poss, vals = state

    def pack_padded(i: int) -> bytes:
        return native_pack_scan_padded(
            dc[i], counts[i], poss[i], vals[i], pattern, huff, options.restart_interval
        )

    with concurrent.futures.ThreadPoolExecutor(max_workers=host_workers) as ex:
        return list(ex.map(pack_padded, range(dc.shape[0])))


def _assemble_jpeg(scan: bytes, options: JpegOptions, quant: QuantizationTables) -> bytes:
    """Wrap a baseline std-table entropy scan in the JPEG marker frame."""
    out = bytearray()
    markers.write_soi(out)
    markers.write_app0(out)
    markers.write_dqt(out, quant)
    markers.write_sof(
        out, markers.SOF0, options.width, options.height,
        options.color_type, options.subsampling,
    )
    markers.write_dht(out, HuffmanTables.default())
    if options.restart_interval is not None:
        markers.write_dri(out, options.restart_interval)
    markers.write_sos(out, options.color_type)
    out += scan
    markers.write_eoi(out)
    return bytes(out)


def encode_jpeg_batch_sharded(
    imgs, options: JpegOptions, *, device, host_workers: int = 8
) -> List[bytes]:
    """Encode a batch of same-shape images ([B, H, W, 3] RGB or [B, H, W]
    gray uint8, numpy or tensor) to baseline JPEG bytes, computing on
    ``device`` ("cpu" or a CUDA device) and packing on the host.

    Byte-identical, image by image, to the JAX package's
    ``encode_jpeg_batch_sharded`` and ``jpeg.encode``."""
    if not _use_sparse_fast_path(options):
        raise NotImplementedError(
            "optimize_huffman, optimal_huffman, progressive and trellis_quant are "
            "not ported yet (ROADMAP.md queue 1 item 6, JPEG remainder)"
        )
    if len(imgs) == 0:
        return []
    jenc._validate(options, imgs[0].numel() if torch.is_tensor(imgs) else imgs[0].size)
    quant = QuantizationTables(options.quality)
    color, sub = _color_sub(options)
    _, _, pattern = scan_layout(options.width, options.height, color, sub)
    zz_dev = jpeg_coeffs_sharded(imgs, options, device=device)
    compacted = compact_padded(zz_dev, PADDED_CAP_PER_BLOCK)
    scans = _pack_hosted(_fetch_compacted(zz_dev, compacted), options, pattern, host_workers)
    return [_assemble_jpeg(s, options, quant) for s in scans]
