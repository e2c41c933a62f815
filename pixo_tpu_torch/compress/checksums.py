"""CRC-32 and Adler-32 checksums.

Counterpart of the JAX package's ``compress/checksums.py`` (parity with pixo
``src/compress/crc32.rs`` and ``src/compress/adler32.rs``): the same
functions, routed through the native library, which raises where it does not
load; the JAX package's NumPy versions are its fallback tier, which the port
does not have. Both agree with ``zlib.crc32`` and ``zlib.adler32``.

``adler32_device`` is the counterpart of the JAX package's device Adler-32
(``adler32_jnp``): on a CUDA tensor the kernel of ``csrc/adler32.cu``, on a
CPU tensor its plain version (``adler32_plain``). As in the JAX package, no
path calls it.
"""

from __future__ import annotations

import torch

from ..native import native_adler32, native_crc32

ADLER_MOD = 65521
ADLER_CHUNK = 2048  # bytes a chunk of the plain version, as adler32_jnp's


def crc32(data: bytes, crc: int = 0) -> int:
    """CRC-32 (IEEE, reflected) of ``data``, continuing from ``crc``."""
    return native_crc32(data, crc)


class Crc32:
    """Incremental CRC-32 (mirrors pixo's ``Crc32`` struct)."""

    def __init__(self) -> None:
        self._crc = 0

    def update(self, data: bytes) -> None:
        self._crc = crc32(data, self._crc)

    def finalize(self) -> int:
        return self._crc


def adler32(data: bytes, adler: int = 1) -> int:
    """Adler-32 of ``data``, continuing from ``adler``."""
    return native_adler32(data, adler)


def adler32_plain(data: torch.Tensor, adler: int = 1) -> int:
    """``adler32_device`` in plain PyTorch on ``data``'s device: each
    2048-byte chunk's sum and weighted sum, then a sequential carry of (a, b)
    mod 65521 over the chunks, as ``adler32_jnp``."""
    n = data.numel()
    a, b = adler & 0xFFFF, (adler >> 16) & 0xFFFF
    if n == 0:
        return (b << 16) | a
    d = torch.nn.functional.pad(data.to(torch.int64), (0, (-n) % ADLER_CHUNK)).reshape(-1, ADLER_CHUNK)
    lengths = (n - ADLER_CHUNK * torch.arange(d.shape[0], device=data.device)).clamp(0, ADLER_CHUNK)
    j = torch.arange(ADLER_CHUNK, device=data.device)
    csums = d.sum(1)
    wsums = (d * (lengths[:, None] - j[None, :]).clamp(min=0)).sum(1)
    for csum, wsum, m in zip(csums.tolist(), wsums.tolist(), lengths.tolist()):
        b = (b + a * m + wsum) % ADLER_MOD
        a = (a + csum) % ADLER_MOD
    return (b << 16) | a


def adler32_device(data: torch.Tensor, adler: int = 1) -> int:
    """Adler-32 of the [N] uint8 tensor ``data``, continuing from ``adler``,
    on ``data``'s device, as a Python int: the kernel of
    ``csrc/adler32.cu`` on a CUDA tensor (two launches, counted as one call
    in ``adler32_device.launches``), the plain version on a CPU tensor.
    Equal to ``zlib.adler32`` and the JAX package's ``adler32_jnp``."""
    from ..ops.kernels import _check, _device_guard, _device_kind, _require, _stream, count_launch, load

    _require(data, torch.uint8, "data")
    if data.dim() != 1:
        raise ValueError(f"data must be [N] uint8, got {tuple(data.shape)}")
    adler &= 0xFFFFFFFF
    if _device_kind(data) == "cpu":
        return adler32_plain(data, adler)
    if data.numel() == 0:
        return adler
    lib = load()
    scratch = torch.empty(lib.pixo_adler32_scratch_words(data.numel()), dtype=torch.int32,
                          device=data.device)
    with _device_guard(data):
        rc = lib.pixo_adler32(data.data_ptr(), data.numel(), adler, scratch.data_ptr(), _stream(data))
    _check(lib, rc, "adler32")
    count_launch(adler32_device)
    return int(scratch[-1].item()) & 0xFFFFFFFF


adler32_device.launches = 0
