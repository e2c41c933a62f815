"""The device half of the optimal parse's match tables (``PIXO_TPU_LZ77=device``).

Counterpart of the JAX package's ``ops/lz77_assist.py``, with the same names
and signatures on ``torch.Tensor``s, on the input's device:

- ``hash4``: the 4-byte hash of every position (the host matcher's
  ``hash4``);
- ``batched_match_lengths``: the match length of many (position,
  candidate) pairs, up to ``max_len``;
- ``chain_candidates``: for every position, the first ``k`` steps of the
  host matcher's hash chain (the nearest earlier positions with the same
  hash, nearest first) with their exact match lengths: the tables that
  ``native_deflate_optimal_assisted`` reads.

Each wrapper takes its plain PyTorch version (``*_plain``) for a tensor on
the CPU and for a CUDA tensor launches its kernel (``csrc/lz77.cu``) or
raises; it never falls back. Each keeps a count of its launches in its
``launches`` attribute, exact under threads (the PNG pool calls
``chain_candidates`` from eight at once). ``stream_to`` and ``tables_to_host``
move the route's stream to the device and its tables back.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import _check, _device_guard, _device_kind, _require, _stream, count_launch, load, upload_pinned

HASH_BITS = 16
HASH_MUL = 2654435761
MAX_MATCH = 258
PLAIN_PAIRS = 1 << 24  # pairs a step of the plain match lengths takes


def _data_input(data: torch.Tensor) -> int:
    _require(data, torch.uint8, "data")
    if data.dim() != 1:
        raise ValueError(f"data must be [N] uint8, got {tuple(data.shape)}")
    if data.numel() > 0x7FFFFFFF:
        raise ValueError("data must hold fewer than 2^31 bytes")
    return data.numel()


def hash4_plain(data: torch.Tensor) -> torch.Tensor:
    """``hash4`` in plain PyTorch: the multiply in int64 on 16-bit halves (no
    overflow), masked to 32 bits, then ``>> 16``."""
    d = data.to(torch.int64)
    n = d.numel()
    v = d.clone()
    for k in range(1, 4):
        if k < n:
            v[: n - k] |= d[k:] << (8 * k)
    lo, hi = v & 0xFFFF, v >> 16
    prod = (lo * HASH_MUL + (((hi * HASH_MUL) & 0xFFFF) << 16)) & 0xFFFFFFFF
    return (prod >> (32 - HASH_BITS)).to(torch.int32)


def hash4(data: torch.Tensor) -> torch.Tensor:
    """[N] uint8 -> [N] int32 4-gram hashes on ``data``'s device; positions
    N-3.. hash their trailing bytes as if zero-padded (callers mask the
    tail), as the JAX package's ``hash4``."""
    n = _data_input(data)
    if _device_kind(data) == "cpu":
        return hash4_plain(data)
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    if n == 0:
        return out
    lib = load()
    with _device_guard(data):
        rc = lib.pixo_hash4(data.data_ptr(), n, out.data_ptr(), _stream(data))
    _check(lib, rc, "hash4")
    count_launch(hash4)
    return out


hash4.launches = 0


def batched_match_lengths_plain(data: torch.Tensor, pos: torch.Tensor, cand: torch.Tensor,
                                max_len: int = MAX_MATCH) -> torch.Tensor:
    """``batched_match_lengths`` in plain PyTorch: a loop over the offsets
    0..max_len-1 with a live mask, ``PLAIN_PAIRS`` pairs at a time (no
    [M, max_len] gather)."""
    n, m = data.numel(), pos.numel()
    out = torch.zeros(m, dtype=torch.int32, device=data.device)
    if n == 0:
        return out
    for lo in range(0, m, PLAIN_PAIRS):
        p = pos[lo:lo + PLAIN_PAIRS].to(torch.int64)
        c = cand[lo:lo + PLAIN_PAIRS].to(torch.int64)
        length = torch.zeros_like(p)
        live = torch.ones_like(p, dtype=torch.bool)
        for j in range(max_len):
            a_idx = p + j
            live &= (a_idx < n) & (data[a_idx.clamp(0, n - 1)] == data[(c + j).clamp(0, n - 1)])
            length += live
            if j % 16 == 15 and not bool(live.any()):
                break
        out[lo:lo + PLAIN_PAIRS] = length.to(torch.int32)
    return out


def _pairs_input(pos: torch.Tensor, cand: torch.Tensor, data: torch.Tensor) -> int:
    _require(pos, torch.int32, "pos")
    _require(cand, torch.int32, "cand")
    if pos.dim() != 1 or pos.shape != cand.shape:
        raise ValueError(f"pos and cand must be [M] int32 alike, got {tuple(pos.shape)} "
                         f"and {tuple(cand.shape)}")
    if pos.device != data.device or cand.device != data.device:
        raise ValueError("data, pos and cand must lie on one device")
    return pos.numel()


def batched_match_lengths(data: torch.Tensor, pos: torch.Tensor, cand: torch.Tensor, *,
                          max_len: int = MAX_MATCH) -> torch.Tensor:
    """Match lengths between data[pos..] and data[cand..] for many pairs:
    [N] uint8 data, [M] int32 pos and cand -> [M] int32, each the first j
    where pos + j >= N or data[pos + j] != data[clip(cand + j, 0, N - 1)],
    at most ``max_len`` (the JAX package's ``batched_match_lengths``)."""
    n = _data_input(data)
    m = _pairs_input(pos, cand, data)
    if max_len < 0:
        raise ValueError(f"max_len must be >= 0, got {max_len}")
    if _device_kind(data) == "cpu":
        return batched_match_lengths_plain(data, pos, cand, max_len)
    out = torch.empty(m, dtype=torch.int32, device=data.device)
    if m == 0:
        return out
    lib = load()
    with _device_guard(data):
        rc = lib.pixo_match_lengths(data.data_ptr(), n, pos.data_ptr(), cand.data_ptr(), m, max_len,
                                    out.data_ptr(), _stream(data))
    _check(lib, rc, "batched_match_lengths")
    count_launch(batched_match_lengths)
    return out


batched_match_lengths.launches = 0


def chain_candidates_plain(data: torch.Tensor, k: int = 16):
    """``chain_candidates`` in plain PyTorch: a stable sort by key (the hash,
    or ``(1 << 16) + pos`` for the last three positions), the k shifted
    compares scattered back to position order, then the lengths of the
    candidates found."""
    n = data.numel()
    cand = torch.full((n, k), -1, dtype=torch.int32, device=data.device)
    lens = torch.zeros((n, k), dtype=torch.int32, device=data.device)
    if n == 0:
        return cand, lens
    pos = torch.arange(n, dtype=torch.int64, device=data.device)
    key = torch.where(pos + 4 <= n, hash4_plain(data).to(torch.int64), (1 << HASH_BITS) + pos)
    skey, order = torch.sort(key, stable=True)
    for kk in range(1, min(k, n - 1) + 1):
        same = skey[kk:] == skey[:-kk]
        cand[order[kk:][same], kk - 1] = order[:-kk][same].to(torch.int32)
    flat = cand.reshape(-1)
    found = torch.nonzero(flat >= 0).reshape(-1)
    lens.reshape(-1)[found] = batched_match_lengths_plain(
        data, (found // k).to(torch.int32), flat[found])
    return cand, lens


def chain_candidates(data: torch.Tensor, *, k: int = 16):
    """First ``k`` hash-chain candidates of every position, with exact match
    lengths: [N] uint8 -> (cand [N, k] int32, lens [N, k] int32) on
    ``data``'s device. ``cand`` is -1 past the chain's end (and ``lens`` 0
    there); the last three positions, which the host never inserts, have
    rows of -1. Equal to the JAX package's ``chain_candidates``."""
    n = _data_input(data)
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if _device_kind(data) == "cpu":
        return chain_candidates_plain(data, k)
    cand = torch.empty((n, k), dtype=torch.int32, device=data.device)
    lens = torch.empty((n, k), dtype=torch.int32, device=data.device)
    if n == 0:
        return cand, lens
    lib = load()
    work = torch.empty(lib.pixo_chain_workspace(n), dtype=torch.int32, device=data.device)
    with _device_guard(data):
        rc = lib.pixo_chain_candidates(data.data_ptr(), n, k, work.data_ptr(), cand.data_ptr(),
                                       lens.data_ptr(), _stream(data))
    _check(lib, rc, "chain_candidates")
    count_launch(chain_candidates)
    return cand, lens


chain_candidates.launches = 0


def stream_to(src: np.ndarray, device) -> torch.Tensor:
    """The [N] uint8 stream ``src`` on ``device``: a copy (``src`` may be a
    read-only view of bytes), through pinned memory for a card."""
    if torch.device(device).type == "cpu":
        return torch.from_numpy(src.copy())
    return upload_pinned(src, device)


def tables_to_host(cand: torch.Tensor, lens: torch.Tensor):
    """``chain_candidates``' tables as numpy arrays on the host: from a card
    through pinned memory, whose cached blocks PyTorch hands out again (a
    pageable copy of the 100.7 MB of one 512x512 RGB image's tables took 48.6
    ms, 2.1 GB/s, on an NVIDIA H100 80GB HBM3's host)."""
    if cand.device.type == "cpu":
        return cand.numpy(), lens.numpy()
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in (cand, lens)]
    for h, t in zip(host, (cand, lens)):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(cand.device).synchronize()
    return host[0].numpy(), host[1].numpy()
