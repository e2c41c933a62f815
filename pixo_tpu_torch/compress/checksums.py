"""CRC-32 and Adler-32 checksums.

Counterpart of the JAX package's ``compress/checksums.py`` (parity with pixo
``src/compress/crc32.rs`` and ``src/compress/adler32.rs``): the same
functions, routed through the native library, which raises where it does not
load; the JAX package's NumPy versions are its fallback tier, which the port
does not have. Both agree with ``zlib.crc32`` and ``zlib.adler32``.

``adler32_device`` is the counterpart of the JAX package's device Adler-32
(``adler32_jnp``): on a CUDA tensor the kernel of ``csrc/adler32.cu`` (one
launch over ``adler32_plan``'s contiguous shares, one a CTA), on a CPU
tensor its plain version (``adler32_plain``). As in the JAX package, no
path calls it.
"""

from __future__ import annotations

import functools

import torch

from ..native import native_adler32, native_crc32

ADLER_MOD = 65521
ADLER_CHUNK = 2048  # bytes a chunk of the plain version, as adler32_jnp's
ADLER_THREADS = 256  # csrc/adler32.cu's kAdlerThreads
ADLER_MIN_SHARE = 16 * ADLER_THREADS  # bytes: a 16-byte chunk a thread
ADLER_MAX_SHARE = 1 << 24  # bytes: keeps a thread's 32-bit sum of its chunks exact


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


def adler32_plan(n: int, slots: int):
    """(grid, share): how ``adler32_device`` splits ``n`` bytes on a card
    that holds ``slots`` CTAs of the kernel at once (``_adler_slots``). CTA c
    takes bytes [c * share, (c + 1) * share), so every byte once, in one
    contiguous share each. The share is the bytes over the card's CTAs in
    whole 16-byte chunks, at least ``ADLER_MIN_SHARE`` (a chunk a thread)
    and at most ``ADLER_MAX_SHARE``; the grid is the shares it takes, none
    of them empty, and only the last ragged."""
    if n < 1 or slots < 1:
        raise ValueError(f"a plan needs n and slots of at least 1, got {n} and {slots}")
    share = -(-n // slots)
    share = min(ADLER_MAX_SHARE, max(ADLER_MIN_SHARE, -(-share // 16) * 16))
    return -(-n // share), share


@functools.lru_cache(maxsize=None)
def _adler_slots(device: torch.device) -> int:
    """The kernel's CTA slots on ``device``: SMs x CTAs an SM (its
    occupancy), queried once a device."""
    from ..ops.kernels import _sm_count, load

    per_sm = load().pixo_adler32_ctas_per_sm()
    if per_sm < 1:
        raise RuntimeError("the adler32 kernel's occupancy query failed")
    return _sm_count(device) * per_sm


def adler32_device(data: torch.Tensor, adler: int = 1) -> int:
    """Adler-32 of the [N] uint8 tensor ``data``, continuing from ``adler``,
    on ``data``'s device, as a Python int: the kernel of
    ``csrc/adler32.cu`` on a CUDA tensor (a memset of its ticket and one
    launch, counted in ``adler32_device.launches``), the plain version on a
    CPU tensor. Equal to ``zlib.adler32`` and the JAX package's
    ``adler32_jnp``."""
    from ..ops.kernels import _check, _device_guard, _device_kind, _require, _stream, count_launch, load

    _require(data, torch.uint8, "data")
    if data.dim() != 1:
        raise ValueError(f"data must be [N] uint8, got {tuple(data.shape)}")
    adler &= 0xFFFFFFFF
    if _device_kind(data) == "cpu":
        return adler32_plain(data, adler)
    n = data.numel()
    if n == 0:
        return adler
    lib = load()
    grid, share = adler32_plan(n, _adler_slots(data.device))
    scratch = torch.empty(2 * grid + 2, dtype=torch.int32, device=data.device)
    with _device_guard(data):
        rc = lib.pixo_adler32(data.data_ptr(), n, adler, grid, share, scratch.data_ptr(), _stream(data))
    _check(lib, rc, "adler32")
    count_launch(adler32_device)
    return int(scratch[-1].item()) & 0xFFFFFFFF


adler32_device.launches = 0
