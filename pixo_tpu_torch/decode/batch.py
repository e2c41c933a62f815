"""Batched JPEG decode: the decode-side counterpart of the encode batches.

Counterpart of the JAX package's ``decode/batch.py::decode_jpeg_batch``,
which maps the per-file decode over host threads and runs each file's pixel
tail on its own. Here every file's entropy stage writes into one
coefficient buffer (the baseline scans' native calls, which release the
GIL, on host threads), and the pixel tail runs once for the whole batch
on ``device`` (``jpeg_decoder.decode_files``). The PNG decode is not
ported (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

from typing import List, Sequence

from .jpeg_decoder import JpegImage, decode_files


def decode_jpeg_batch(
    files: Sequence[bytes],
    *,
    fancy_upsampling: bool = False,
    workers: int = 8,
    device,
) -> List[JpegImage]:
    """Decode many JPEGs, baseline or progressive, of any sizes and
    samplings (order preserved): entropy on the host (the baseline scans'
    library calls on ``workers`` threads), the pixel tail on ``device``
    ("cpu" or a CUDA device) in one pass. Each image equals the JAX
    package's ``decode_jpeg``; the first file, in order, that fails raises
    its error."""
    return decode_files(files, fancy_upsampling, workers, device)
