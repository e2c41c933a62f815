"""Batched decode: the decode-side counterpart of the encode batches.

Counterpart of the JAX package's ``decode/batch.py``. Its
``decode_jpeg_batch`` maps the per-file decode over host threads and runs
each file's pixel tail on its own; here every file's entropy stage writes
into one coefficient buffer (the baseline scans' native calls, which release
the GIL, on host threads), and the pixel tail runs once for the whole batch
on ``device`` (``jpeg_decoder.decode_files``); under the host pixel tier,
the CPU's default, each file decodes through the host library on the
threads. ``decode_png_batch`` maps the per-file PNG decode over host
threads, as the JAX package does: INFLATE and the row reconstruction are
library calls that release the GIL.
"""

from __future__ import annotations

import concurrent.futures
import functools
from typing import List, Sequence

from .jpeg_decoder import JpegImage, decode_files
from .png_decoder import PngImage, decode_png


def decode_png_batch(
    files: Sequence[bytes],
    *,
    keep_bit_depth: bool = False,
    workers: int = 8,
) -> List[PngImage]:
    """Decode many PNGs concurrently on host threads (order preserved); the
    first file, in order, that fails raises its error."""
    fn = functools.partial(decode_png, keep_bit_depth=keep_bit_depth)
    if len(files) <= 1:
        return [fn(f) for f in files]
    with concurrent.futures.ThreadPoolExecutor(max_workers=workers) as ex:
        return list(ex.map(fn, files))


def decode_jpeg_batch(
    files: Sequence[bytes],
    *,
    fancy_upsampling: bool = False,
    workers: int = 8,
    device="cuda",
) -> List[JpegImage]:
    """Decode many JPEGs, baseline or progressive, of any sizes and
    samplings (order preserved), under the pixel tier ``device`` selects
    (``jpeg_decoder._pixel_tier``, ``PIXO_TPU_DECODE_PIXELS``): on a card,
    entropy on the host (the baseline scans' library calls on ``workers``
    threads) and the pixel tail on the card in one pass; for "cpu", each
    file through the host library on ``workers`` threads. Each image equals
    the JAX package's ``decode_jpeg``; the first file, in order, that fails
    raises its error."""
    return decode_files(files, fancy_upsampling, workers, device)
