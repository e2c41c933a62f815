"""Hand-written Hopper kernels of the ported slices, and their wrappers.

Counterpart of the JAX package's ``ops/pallas_kernels.py``. The CUDA sources
live in ``pixo_tpu_torch/csrc/``; they are compiled with ``nvcc`` at first use,
one process per source, all at once, and linked into one shared library with
a plain C interface (``_build/``), called through ctypes on PyTorch's current
stream.

- ``coeffs``: uint8 pixels -> int16 zigzag coefficients, the whole per-block
  chain of the encoder (``csrc/coeffs.cu``). It replaces ``dct8x8_aan_pallas``
  widened to ``jpeg/encoder.py::_device_coeffs``.
- ``dct_zz``: the same chain up to the unquantized f32 DCT in zigzag order,
  a kernel of its own beside the coefficient kernel (``csrc/coeffs.cu``,
  each CTA one contiguous share of the batch's tiles, ``dct_zz_plan``): the
  trellis quantizer's front end, replacing ``dct8x8_aan_pallas`` widened to
  ``jpeg/encoder.py::_device_dct_zz``.
- ``dct8x8_aan``: the standalone [N, 8, 8] f32 AAN DCT, sharing the
  coefficient kernel's butterfly (``csrc/aan.cuh``): the direct counterpart
  of ``dct8x8_aan_pallas``.
- ``trellis_quantize``: the trellis quantizer's Viterbi DP, a thread a block
  (``csrc/trellis.cu``), replacing the jit ``trellis_quantize_batch_device``
  of the JAX package's ``ops/trellis_device.py``, which has no Pallas
  kernel.
- ``compact_padded``: per-block compaction of the coefficient stream
  (``csrc/compact.cu``), replacing the ``lax.top_k`` of
  ``ops/sparse_pack.py::sparsify_blocks_padded``.
- ``count_symbols``: the optimized-Huffman encode's DC and AC symbol
  histograms of a batch's coefficient streams (``csrc/huffman.cu``),
  replacing the jit ``_count_device`` of ``ops/huffman_device.py``, which
  has no Pallas kernel.
- ``filter_bank``: the five PNG filter candidates and their scores
  (``csrc/filter_bank.cu``), the direct counterpart of ``filter_bank_pallas``.
- ``filter_rows``: the PNG encode's filter stage in one kernel (scores,
  the reference's selection rule, the chosen filter with its type byte),
  sharing ``filter_bank``'s source; it replaces ``filter_bank_pallas`` with
  the selection of ``ops/png_filters.py::filter_image_batch`` fused in, the
  max preset's Bigrams (``_bigram_scores`` and its argmin) among them.
- ``idct_planes``: the JPEG decode's tail up to the planes (dequantize,
  un-zigzag, jidctint IDCT, plane assembly) over every plane of a batch in
  one launch (``csrc/idct.cu``); it replaces ``idct8x8_int_pallas`` widened
  to ``ops/jpeg_decode.py::dequant_idct_blocks`` and ``assemble_plane``.
  ``idct_planes_table`` is the same launch for a caller that keeps its
  ``PlaneTable`` (the batch decoder, which packs it once a batch).
- ``idct8x8_int``: the standalone [N, 8, 8] integer IDCT, sharing the decode
  kernel's butterfly (``csrc/idct.cuh``): the direct counterpart of
  ``idct8x8_int_pallas``.
- ``resize_lanczos3``: the separable Lanczos3 resize of a same-shape group,
  both passes in the serial f32 tap order (``csrc/resize.cu``); it replaces
  the jit-compiled ``_lanczos_pass`` pair of ``ops/resize_kernels.py``, for
  which the JAX package has no Pallas kernel.
- ``kmeans_refine``, ``palette_lut`` and ``dither_fs``: the lossy PNG's
  weighted k-means refinement, 6-6-6 palette LUT and wavefront
  Floyd-Steinberg dither over a batch of images (``csrc/quantize.cu``, the
  redmean argmin in ``csrc/redmean.cuh``); they replace the jit functions
  ``kmeans_refine_device``, ``palette_lut_device`` and ``dither_fs_device`` of
  the JAX package's ``ops/quantize_device.py``, which have no Pallas kernel.
- ``hash4``, ``match_lengths`` and ``chain_candidates`` (``csrc/lz77.cu``):
  the device half of the optimal parse's match tables, wrapped in
  ``ops/lz77_assist.py``; and ``adler32`` (``csrc/adler32.cu``), wrapped in
  ``compress/checksums.py::adler32_device``. They replace the jit functions
  of the JAX package's ``ops/lz77_assist.py`` and ``adler32_jnp``.
- ``unfilter`` (``csrc/unfilter.cu``): the PNG row reconstruction as a
  wavefront, a pixel a step, a lane a row, warps of 32 rows handed on
  through rings, an image on a cluster of CTAs, wrapped in
  ``ops/png_unfilter.py::unfilter_device_batch``; it replaces the jit
  ``unfilter_device_batch`` of the JAX package's ``ops/png_unfilter.py``,
  which has no Pallas kernel.

Each wrapper takes its plain PyTorch version for a tensor on the CPU, and
for a CUDA tensor launches its kernel or raises; it never falls back. Each
keeps a count of its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..native import MODES
from ..utils.build import build_shared_library
from .blockify import blocks_420, blocks_422, blocks_444, blocks_gray, num_blocks
from .dct import dct8x8_aan as dct8x8_aan_plain
from .huffman_device import count_symbols_plain
from .jpeg_decode import dequant_idct_blocks
from .jpeg_decode import idct8x8_int as idct8x8_int_plain
from .png_filters import (
    MODE_ADAPTIVE_FAST,
    MODE_BIGRAMS,
    _candidates,
    _signed_abs_scores,
    early_stop,
    filter_rows_plain,
    native_mode,
    resolve_strategy,
)
from . import quantize_device
from .quantize import quantize_blocks, zigzag_blocks
from .resize_kernels import _lanczos_pass, pad_taps
from .sparse_pack import PADDED_CAP_TIERS, sparsify_blocks_padded_batch
from .trellis_device import RATE_LUT, trellis_quantize_batch_plain

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = [os.path.join(CSRC, f) for f in ("coeffs.cu", "compact.cu", "filter_bank.cu", "idct.cu",
                                           "resize.cu", "quantize.cu", "huffman.cu", "trellis.cu",
                                           "lz77.cu", "adler32.cu", "unfilter.cu", "aan.cuh", "idct.cuh",
                                           "redmean.cuh")]

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# -fmad=false: no mul+add pair may become an FMA (the AAN DCT is bit-exact
# only without contraction); IEEE division stays the default (no fast math).
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", f"-I{CSRC}"]

MAX_CHANNELS = 16  # csrc/coeffs.cu's kMaxChannels: the dct_zz kernel's four stages of raw rows then take 133 KB
RESIZE_MAX_CHANNELS = 4  # csrc/resize.cu's horizontal pass: a slot holds 4 channels of 4 rows as halves

_PLAIN_BLOCKS = {"gray": blocks_gray, "444": blocks_444, "420": blocks_420, "422": blocks_422}

_lib = None
_lock = threading.Lock()
build_seconds = 0.0  # time the first load() of this process spent compiling
build_log = ""  # the compiler's output of that build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def load():
    """Build (at first use) and load the CUDA kernel library; raises on failure."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is None:
            built = build_shared_library(
                "pixo_kernels", [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v"], SOURCES, timeout=900,
                link=[_nvcc(), *_ARCH, "-shared"],
            )
            build_seconds, build_log = built.seconds, built.log
            lib = ctypes.CDLL(built.path)
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
            lib.pixo_coeffs.restype = ctypes.c_int
            lib.pixo_coeffs.argtypes = [vp, i64, i64, i64, i32, i32, vp, vp, vp, vp]
            lib.pixo_dct_zz.restype = ctypes.c_int
            lib.pixo_dct_zz.argtypes = [vp, i64, i64, i64, i32, i32, vp, vp]
            lib.pixo_coeffs_ctas_per_sm.restype = ctypes.c_int
            lib.pixo_coeffs_ctas_per_sm.argtypes = [i32, i32, i32, vp]
            lib.pixo_trellis_quantize.restype = ctypes.c_int
            lib.pixo_trellis_quantize.argtypes = [vp, i64, vp, vp, vp, i32, ctypes.c_float, vp, vp, vp]
            lib.pixo_dct8x8_aan.restype = ctypes.c_int
            lib.pixo_dct8x8_aan.argtypes = [vp, vp, i64, vp]
            lib.pixo_compact.restype = ctypes.c_int
            lib.pixo_compact.argtypes = [vp, i64, i64, i32, vp, vp, vp, vp, vp, vp, vp]
            lib.pixo_count_symbols.restype = ctypes.c_int
            lib.pixo_count_symbols.argtypes = [vp, i64, i64, vp, i32, i32, i64, i64, vp, vp]
            lib.pixo_count_ctas_per_sm.restype = ctypes.c_int
            lib.pixo_count_ctas_per_sm.argtypes = []
            lib.pixo_filter_bank.restype = ctypes.c_int
            lib.pixo_filter_bank.argtypes = [vp, i64, i64, i64, i32, i32, vp, vp, vp]
            lib.pixo_filter_rows.restype = ctypes.c_int
            lib.pixo_filter_rows.argtypes = [vp, i64, i64, i64, i32, i32, i32, i32, i32, vp, vp]
            lib.pixo_idct_planes.restype = ctypes.c_int
            lib.pixo_idct_planes.argtypes = [vp, i64, vp, i32, vp, vp]
            lib.pixo_idct8x8_int.restype = ctypes.c_int
            lib.pixo_idct8x8_int.argtypes = [vp, vp, i64, vp]
            lib.pixo_resize_lanczos3.restype = ctypes.c_int
            lib.pixo_resize_lanczos3.argtypes = [vp, i64, i64, i64, i32, vp, vp, i32, i64,
                                                 vp, vp, i32, i64, vp, vp, i32, i32, i32, vp]
            lib.pixo_palette_lut.restype = ctypes.c_int
            lib.pixo_palette_lut.argtypes = [vp, i64, i32, vp, vp, vp]
            lib.pixo_kmeans_refine.restype = ctypes.c_int
            lib.pixo_kmeans_refine.argtypes = [vp, i64, i32, vp, vp, vp, i64, vp, i64, vp, vp, vp, vp]
            lib.pixo_dither_fs.restype = ctypes.c_int
            lib.pixo_dither_fs.argtypes = [vp, i64, i64, i64, vp, i32, vp, vp, i32, i32, vp, vp, vp]
            lib.pixo_hash4.restype = ctypes.c_int
            lib.pixo_hash4.argtypes = [vp, i64, vp, vp]
            lib.pixo_match_lengths.restype = ctypes.c_int
            lib.pixo_match_lengths.argtypes = [vp, i64, vp, vp, i64, i32, vp, vp]
            lib.pixo_chain_workspace.restype = i64
            lib.pixo_chain_workspace.argtypes = [i64]
            lib.pixo_chain_candidates.restype = ctypes.c_int
            lib.pixo_chain_candidates.argtypes = [vp, i64, i32, vp, vp, vp, vp]
            lib.pixo_adler32_ctas_per_sm.restype = ctypes.c_int
            lib.pixo_adler32_ctas_per_sm.argtypes = []
            lib.pixo_adler32.restype = ctypes.c_int
            lib.pixo_adler32.argtypes = [vp, i64, ctypes.c_uint32, i64, i64, vp, vp]
            lib.pixo_unfilter.restype = ctypes.c_int
            lib.pixo_unfilter.argtypes = [vp, vp, i64, i64, i64, i32, i32, i32, i32, vp, vp, vp]
            lib.pixo_cuda_error_string.restype = ctypes.c_char_p
            lib.pixo_cuda_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


_count_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches`` under a lock: exact where threads
    launch at once (the PNG pool runs the optimal DEFLATE's route on eight)."""
    with _count_lock:
        wrapper.launches += 1


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.pixo_cuda_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def _device_guard(t: torch.Tensor):
    """Makes ``t``'s device the current one for a launch; no guard where it
    already is (the guard's enter and exit are a measurable part of a
    wrapper's host time)."""
    idx = t.get_device()
    return contextlib.nullcontext() if torch._C._cuda_getDevice() == idx else torch.cuda.device(idx)


H100_SMS = 132


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    """The SMs of ``device``, queried once a device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _require(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _table(q) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(q, dtype=np.float32).reshape(64))


def coeffs_plain(imgs: torch.Tensor, lum_q, chrom_q, mode: str) -> torch.Tensor:
    """The plain PyTorch chain on ``imgs``' device: blockify -> AAN DCT ->
    quantize -> zigzag. ``imgs`` is [B, H, W] (gray) or [B, H, W, C] uint8;
    the tables are natural-order [64] or [8, 8] f32. Returns
    [B, nblocks, 64] int16 in scan order."""
    blocks = _PLAIN_BLOCKS[mode](imgs)
    lum = torch.as_tensor(_table(lum_q), device=imgs.device).reshape(8, 8)
    chrom = torch.as_tensor(_table(chrom_q), device=imgs.device).reshape(8, 8)
    if mode == "gray":
        qmap = lum[None]
    elif mode == "420":
        qmap = torch.stack([lum] * 4 + [chrom] * 2)
    elif mode == "422":
        qmap = torch.stack([lum] * 2 + [chrom] * 2)
    else:
        qmap = torch.stack([lum, chrom, chrom])
    b, bpm = blocks.shape[0], qmap.shape[0]
    dct = dct8x8_aan_plain(blocks).reshape(b, -1, bpm, 8, 8)
    return zigzag_blocks(quantize_blocks(dct, qmap)).reshape(b, -1, 64)


def _pixels_shape(imgs: torch.Tensor, mode: str):
    """(b, h, w, c) of a coefficient kernel's input, checked."""
    if mode not in MODES:
        raise ValueError(f"unknown coefficient mode {mode!r}")
    _require(imgs, torch.uint8, "imgs")
    if mode == "gray":
        if imgs.dim() != 3:
            raise ValueError(f"gray input must be [B, H, W], got {tuple(imgs.shape)}")
        return (*imgs.shape, 1)
    if imgs.dim() != 4 or imgs.shape[3] < 3:
        raise ValueError(f"color input must be [B, H, W, C>=3], got {tuple(imgs.shape)}")
    return tuple(imgs.shape)


def _kernel_pixels(b: int, h: int, w: int, c: int) -> None:
    if b * h * w == 0:
        raise ValueError("empty batch")
    if c > MAX_CHANNELS:
        raise ValueError(f"the coefficient kernel takes at most {MAX_CHANNELS} channels, got {c}")


def coeffs(imgs: torch.Tensor, lum_q, chrom_q, mode: str) -> torch.Tensor:
    """[B, H, W] (gray) or [B, H, W, C>=3] uint8 pixels -> [B, nblocks, 64]
    int16 zigzag coefficients in scan order, on ``imgs``' device.

    ``mode`` is "gray", "444", "420" or "422"; ``lum_q``/``chrom_q`` are the
    natural-order f32 quantization tables (numpy, [64] or [8, 8])."""
    b, h, w, c = _pixels_shape(imgs, mode)
    if _device_kind(imgs) == "cpu":
        return coeffs_plain(imgs, lum_q, chrom_q, mode)
    _kernel_pixels(b, h, w, c)
    lib = load()
    lum, chrom = _table(lum_q), _table(chrom_q)
    out = torch.empty((b, num_blocks(h, w, mode), 64), dtype=torch.int16, device=imgs.device)
    with _device_guard(imgs):
        rc = lib.pixo_coeffs(
            imgs.data_ptr(), b, h, w, c, MODES[mode],
            lum.ctypes.data, chrom.ctypes.data, out.data_ptr(), _stream(imgs),
        )
    _check(lib, rc, "coeffs")
    coeffs.launches += 1
    return out


coeffs.launches = 0


def dct_zz_plain(imgs: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain PyTorch chain without the quantizer, on ``imgs``' device:
    blockify -> AAN DCT -> zigzag. Returns [B, nblocks, 64] f32 in scan
    order (the counterpart of the JAX package's ``_device_dct_zz``)."""
    blocks = _PLAIN_BLOCKS[mode](imgs)
    return zigzag_blocks(dct8x8_aan_plain(blocks)).reshape(blocks.shape[0], -1, 64)


def dct_zz(imgs: torch.Tensor, mode: str) -> torch.Tensor:
    """[B, H, W] (gray) or [B, H, W, C>=3] uint8 pixels -> [B, nblocks, 64]
    f32 unquantized DCT in zigzag and scan order, on ``imgs``' device: the
    trellis quantizer's input, bit-equal to ``dct_zz_plain`` and to the host
    library's ``native_jpeg_dct_zz``."""
    b, h, w, c = _pixels_shape(imgs, mode)
    if _device_kind(imgs) == "cpu":
        return dct_zz_plain(imgs, mode)
    _kernel_pixels(b, h, w, c)
    lib = load()
    out = torch.empty((b, num_blocks(h, w, mode), 64), dtype=torch.float32, device=imgs.device)
    with _device_guard(imgs):
        rc = lib.pixo_dct_zz(imgs.data_ptr(), b, h, w, c, MODES[mode], out.data_ptr(), _stream(imgs))
    _check(lib, rc, "dct_zz")
    dct_zz.launches += 1
    return out


dct_zz.launches = 0


def coeffs_ctas_per_sm(mode: str, c: int, raw: bool) -> int:
    """CTAs of the coefficient kernel (or, ``raw``, of the ``dct_zz``
    kernel) that one SM of the current card holds at ``c`` channels."""
    lib = load()
    per_sm = ctypes.c_int32(0)
    _check(lib, lib.pixo_coeffs_ctas_per_sm(MODES[mode], c, int(raw), ctypes.byref(per_sm)),
           "coeffs occupancy")
    return per_sm.value


TILE_W = 128  # csrc/coeffs.cu's kTileW: the pixels a tile spans
# each mode's MCU width and height and blocks an MCU (csrc/coeffs.cu's Tile<MODE>)
TILE_MCU = {"gray": (8, 8, 1), "444": (8, 8, 3), "420": (16, 16, 6), "422": (16, 8, 4)}
DCT_ZZ_THREADS_PER_SM = 1152  # csrc/coeffs.cu's kZzThreadsPerSm: the threads an SM the dct_zz plan sizes its grid by


class ZzTiles(NamedTuple):
    """How the coefficient and ``dct_zz`` kernels cut one image of a mode
    into tiles: an image's run of ``mcus`` MCUs in one MCU row, in the order
    images, MCU rows, runs."""

    n_mcu_x: int
    n_mcu_y: int
    n_tiles_x: int
    mcus: int  # MCUs a whole tile
    bpm: int  # blocks an MCU

    @property
    def tiles_per_img(self) -> int:
        return self.n_tiles_x * self.n_mcu_y

    @property
    def threads(self) -> int:  # a CTA's: eight lanes a block of a whole tile
        return 8 * self.mcus * self.bpm


def zz_tiles(h: int, w: int, mode: str) -> ZzTiles:
    """The tiles of an ``h`` x ``w`` image in ``mode``."""
    mcu_w, mcu_h, bpm = TILE_MCU[mode]
    n_mcu_x, mcus = -(-w // mcu_w), TILE_W // mcu_w
    return ZzTiles(n_mcu_x, -(-h // mcu_h), -(-n_mcu_x // mcus), mcus, bpm)


def dct_zz_plan_ctas(mode: str) -> int:
    """CTAs an SM the ``dct_zz`` kernel's plan takes in ``mode`` (its
    ``__launch_bounds__``): gray 9, 4:4:4 3, 4:2:0 3, 4:2:2 4."""
    return DCT_ZZ_THREADS_PER_SM // zz_tiles(1, 1, mode).threads


def dct_zz_plan(n_tiles: int, slots: int) -> list:
    """The ``dct_zz`` kernel's shares of a batch's ``n_tiles`` tiles on a
    card that keeps ``slots`` CTAs at once (``dct_zz_slots``): [(begin,
    end)] a CTA, contiguous, in order, differing by at most one tile, the
    first ``n_tiles % grid`` one longer; the grid is ``min(n_tiles,
    slots)``, so no share is empty. The kernel computes its own bounds from
    ``blockIdx.x`` alike."""
    if n_tiles < 1 or slots < 1:
        raise ValueError(f"a plan needs n_tiles and slots of at least 1, got {n_tiles} and {slots}")
    grid = min(n_tiles, slots)
    q, r = divmod(n_tiles, grid)
    return [(c * q + min(c, r), (c + 1) * q + min(c + 1, r)) for c in range(grid)]


def dct_zz_slots(device: torch.device, mode: str, c: int) -> int:
    """The ``dct_zz`` kernel's CTA slots on ``device`` at ``c`` channels, as
    its launch sizes the grid: SMs x its occupancy, at most
    ``dct_zz_plan_ctas``."""
    with torch.cuda.device(device):
        per_sm = coeffs_ctas_per_sm(mode, c, True)
    return _sm_count(device) * min(per_sm, dct_zz_plan_ctas(mode))


MAX_PATTERN = 8  # csrc/trellis.cu's kMaxPattern: blocks an MCU pattern may hold


def trellis_quantize(dct_zz: torch.Tensor, lum_zz, chrom_zz, pattern, lam: float = 1.0) -> torch.Tensor:
    """[N, 64] f32 zigzag DCT blocks -> [N, 64] int16 trellis-quantized, on
    ``dct_zz``'s device, bit-equal to
    ``ops/trellis_device.py::trellis_quantize_batch_plain`` and to the host
    library's ``native_trellis_quantize``. ``lum_zz``/``chrom_zz`` are the
    zigzag f32 tables (numpy [64]); block i takes the chroma one where
    ``pattern[i % len(pattern)]`` is not 0."""
    _require(dct_zz, torch.float32, "dct_zz")
    if dct_zz.dim() != 2 or dct_zz.shape[1] != 64:
        raise ValueError(f"dct_zz must be [N, 64], got {tuple(dct_zz.shape)}")
    if not 1 <= len(pattern) <= MAX_PATTERN:
        raise ValueError(f"the pattern must hold 1 to {MAX_PATTERN} blocks, got {len(pattern)}")
    if _device_kind(dct_zz) == "cpu":
        return trellis_quantize_batch_plain(dct_zz, lum_zz, chrom_zz, pattern, lam)
    n = dct_zz.shape[0]
    if n == 0:
        raise ValueError("empty batch")
    lib = load()
    lum, chrom = _table(lum_zz), _table(chrom_zz)
    pat = np.ascontiguousarray(pattern, dtype=np.uint8)
    out = torch.empty((n, 64), dtype=torch.int16, device=dct_zz.device)
    with _device_guard(dct_zz):
        rc = lib.pixo_trellis_quantize(dct_zz.data_ptr(), n, lum.ctypes.data, chrom.ctypes.data,
                                       pat.ctypes.data, len(pat), lam, RATE_LUT.ctypes.data,
                                       out.data_ptr(), _stream(dct_zz))
    _check(lib, rc, "trellis_quantize")
    trellis_quantize.launches += 1
    return out


trellis_quantize.launches = 0


def dct8x8_aan(blocks: torch.Tensor) -> torch.Tensor:
    """Forward AAN DCT over [N, 8, 8] f32 blocks, bit-exact with
    ``ops/dct.py::dct8x8_aan``."""
    _require(blocks, torch.float32, "blocks")
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (8, 8):
        raise ValueError(f"blocks must be [N, 8, 8], got {tuple(blocks.shape)}")
    if _device_kind(blocks) == "cpu":
        return dct8x8_aan_plain(blocks)
    if blocks.shape[0] == 0:
        raise ValueError("empty batch")
    lib = load()
    out = torch.empty_like(blocks)
    with _device_guard(blocks):
        rc = lib.pixo_dct8x8_aan(blocks.data_ptr(), out.data_ptr(), blocks.shape[0], _stream(blocks))
    _check(lib, rc, "dct8x8_aan")
    dct8x8_aan.launches += 1
    return out


dct8x8_aan.launches = 0


# Images a compaction launch takes: csrc/compact.cu takes at most 65,535, and
# a multiple of 16 keeps every group's slices of the outputs 16-byte aligned.
COMPACT_MAX_BATCH = 65520


def batch_groups(b: int, most: int) -> list:
    """[lo, hi) ranges that cut a batch of ``b`` images into groups of at
    most ``most``, in order."""
    if b < 1 or most < 1:
        raise ValueError(f"a batch of at least 1 image and groups of at least 1, got {b} and {most}")
    return [(lo, min(lo + most, b)) for lo in range(0, b, most)]


def _compact_outputs(b: int, n: int, cap: int, device):
    """``compact_padded``'s six outputs; total and maxcount are the two rows
    of one [2, B] buffer, so the kernel library zeroes both with one memset."""
    total, maxcount = torch.empty((2, b), dtype=torch.int32, device=device).unbind(0)
    return (torch.empty((b, n), dtype=torch.int16, device=device),
            torch.empty((b, n), dtype=torch.uint8, device=device),
            torch.empty((b, n, cap), dtype=torch.uint8, device=device),
            torch.empty((b, n, cap), dtype=torch.int16, device=device), total, maxcount)


def compact_padded(zz: torch.Tensor, cap_per_block: int):
    """[B, N, 64] int16 zigzag blocks -> per-block padded streams
    (dc [B, N] i16, counts [B, N] u8, poss [B, N, cap] u8, vals [B, N, cap]
    i16, total [B] i32, maxcount [B] i32), equal to
    ``ops/sparse_pack.py::sparsify_blocks_padded_batch``. On a card the
    kernel runs once a group of at most ``COMPACT_MAX_BATCH`` images
    (``batch_groups``), each launch writing its slices of the outputs."""
    if cap_per_block not in PADDED_CAP_TIERS:
        raise ValueError(f"cap_per_block must be one of {PADDED_CAP_TIERS}")
    _require(zz, torch.int16, "zz")
    if zz.dim() != 3 or zz.shape[2] != 64:
        raise ValueError(f"zz must be [B, N, 64], got {tuple(zz.shape)}")
    if _device_kind(zz) == "cpu":
        return sparsify_blocks_padded_batch(zz, cap_per_block)
    b, n = zz.shape[0], zz.shape[1]
    if not (b >= 1 and n >= 1):
        raise ValueError(f"unsupported batch shape {tuple(zz.shape)}")
    lib = load()
    outs = _compact_outputs(b, n, cap_per_block, zz.device)
    stream = _stream(zz)
    for lo, hi in batch_groups(b, COMPACT_MAX_BATCH):
        dc, counts, poss, vals, total, maxcount = (t[lo:hi] for t in outs)
        with _device_guard(zz):
            rc = lib.pixo_compact(
                zz[lo:hi].data_ptr(), hi - lo, n, cap_per_block, dc.data_ptr(), counts.data_ptr(),
                poss.data_ptr(), vals.data_ptr(), total.data_ptr(), maxcount.data_ptr(), stream,
            )
        _check(lib, rc, "compact")
        count_launch(compact_padded)  # the streams' cap escalation launches from their copy thread
    return outs


compact_padded.launches = 0


HIST_BINS = 2 * 12 + 2 * 256  # csrc/huffman.cu's counters an image: dc [2][12], then ac [2][256]
COUNT_CTAS_PER_SM = 3  # at most, of the count kernel's occupancy: 4 CTAs an SM were no faster (--count-parts)
COUNT_STEP = 16  # csrc/huffman.cu's kStep: the blocks a warp counts in a pass
COUNT_PASS = 128  # its kPass: the blocks a CTA of 8 warps counts in a pass
COUNT_MAX_SHARE = 1 << 24  # its kMaxShare: the most blocks a CTA takes, which keeps its int32 sums exact


def count_plan(b: int, n: int, ctas: int = 3 * H100_SMS):
    """(grid, share): how ``count_symbols`` splits a batch of ``b`` images of
    ``n`` blocks on a card that holds ``ctas`` CTAs of the count kernel at
    once (``_count_slots``). CTA c takes blocks [c * share, (c + 1) * share)
    of the flattened b * n, so every block once, in one contiguous share
    each; a share may start inside an MCU, a restart segment or an image.
    The share is the batch over the card's CTAs, in whole steps of
    ``COUNT_STEP`` blocks, at least one pass (``COUNT_PASS``: fewer would
    leave warps idle and give an image more CTAs to meet) and at most
    ``COUNT_MAX_SHARE``; the grid is the shares it takes, none of them
    empty."""
    if b < 1 or n < 1 or ctas < 1:
        raise ValueError(f"a plan needs b, n and ctas of at least 1, got {b}, {n} and {ctas}")
    total = b * n
    share = -(-total // ctas)
    share = min(COUNT_MAX_SHARE, max(COUNT_PASS, -(-share // COUNT_STEP) * COUNT_STEP))
    return -(-total // share), share


@functools.lru_cache(maxsize=None)
def _count_slots(device: torch.device) -> int:
    """The count kernel's CTA slots on ``device``: SMs x CTAs an SM (its
    occupancy, at most ``COUNT_CTAS_PER_SM``), queried once a device."""
    per_sm = load().pixo_count_ctas_per_sm()
    if per_sm < 1:
        raise RuntimeError("the count kernel's occupancy query failed")
    return _sm_count(device) * min(per_sm, COUNT_CTAS_PER_SM)


@functools.lru_cache(maxsize=16)
def count_layout(pattern: tuple) -> np.ndarray:
    """The count kernel's table of an MCU pattern: [bpm, 3] int8, for each
    slot its table class (0 for component 0, 1 for the others), the
    previous slot of its component in the MCU (-1 for none) and the last
    slot of its component in the MCU. Block j = m * bpm + k's DC predictor
    is block j - k + prev[k] where prev[k] >= 0, else block (m - 1) * bpm +
    last[k] where m > 0 starts no restart segment, else none
    (``huffman_device.py::_prev_block_index``)."""
    out = np.zeros((len(pattern), 3), np.int8)
    for k, c in enumerate(pattern):
        same = [q for q, d in enumerate(pattern) if d == c]
        out[k] = (c != 0, max((q for q in same if q < k), default=-1), same[-1])
    out.setflags(write=False)
    return out


def count_symbols(zz: torch.Tensor, pattern, restart_interval: Optional[int] = None):
    """[B, N, 64] int16 zigzag blocks in scan order -> each image's symbol
    counts (dc [B, 2, 12], ac [B, 2, 256]) int64, table class 0 for
    component 0 and 1 for the others, equal to
    ``ops/huffman_device.py::count_symbols_plain``. ``pattern`` is the MCU's
    component ids (1 to 6 of 0, 1, 2); ``restart_interval`` the MCUs a
    restart segment, or None. The kernel takes ``zz`` at any address, and
    the batch in one launch at any size (``count_plan``)."""
    pattern = tuple(int(c) for c in pattern)
    if not 1 <= len(pattern) <= 6 or any(c not in (0, 1, 2) for c in pattern):
        raise ValueError(f"pattern must be 1 to 6 component ids of 0, 1, 2, got {pattern}")
    if restart_interval is not None and restart_interval < 1:
        raise ValueError(f"restart_interval must be None or at least 1, got {restart_interval}")
    if zz.dtype != torch.int16:
        raise TypeError(f"zz must be torch.int16, got {zz.dtype}")
    if not zz.is_contiguous():
        raise ValueError("zz must be contiguous")
    if zz.dim() != 3 or zz.shape[2] != 64 or zz.shape[1] % len(pattern):
        raise ValueError(f"zz must be [B, N, 64] with N a multiple of {len(pattern)}, "
                         f"got {tuple(zz.shape)}")
    if _device_kind(zz) == "cpu":
        return count_symbols_plain(zz, pattern, restart_interval)
    b, n = zz.shape[0], zz.shape[1]
    if not (b >= 1 and 1 <= n < 2**31):
        raise ValueError(f"unsupported batch shape {tuple(zz.shape)}")
    lib = load()
    dev = zz.device
    slots = count_layout(pattern)
    grid, share = count_plan(b, n, _count_slots(dev))
    hist = torch.empty((b, HIST_BINS), dtype=torch.int64, device=dev)
    with _device_guard(zz):
        rc = lib.pixo_count_symbols(zz.data_ptr(), b, n, slots.ctypes.data, len(pattern),
                                    restart_interval or 0, grid, share, hist.data_ptr(), _stream(zz))
    _check(lib, rc, "count_symbols")
    count_symbols.launches += 1
    return hist[:, :24].view(b, 2, 12), hist[:, 24:].view(b, 2, 256)


count_symbols.launches = 0


def _filter_input(rows: torch.Tensor, bpp: int):
    # the filter kernels take rows at any byte offset
    if rows.dtype != torch.uint8:
        raise TypeError(f"rows must be torch.uint8, got {rows.dtype}")
    if not rows.is_contiguous():
        raise ValueError("rows must be contiguous")
    if rows.dim() != 3 or rows.numel() == 0:
        raise ValueError(f"rows must be a non-empty [B, H, RB] tensor, got {tuple(rows.shape)}")
    if not 1 <= bpp <= 8:
        raise ValueError(f"bpp must be 1..8, got {bpp}")
    b, h, rb = rows.shape
    if b * h > 2**31 - 1:
        raise ValueError(f"{b * h} rows exceed the kernel's grid")
    return b, h, rb


def filter_bank_plain(rows: torch.Tensor, bpp: int):
    """The plain version of ``filter_bank`` on ``rows``' device."""
    cands = _candidates(rows, bpp)
    return cands.to(torch.uint8), _signed_abs_scores(cands)


def filter_bank(rows: torch.Tensor, bpp: int):
    """[B, H, RB] uint8 raw rows -> (candidates [B, 5, H, RB] uint8 for None,
    Sub, Up, Average, Paeth, scores [B, H, 5] int32 sum of |byte as i8|), on
    ``rows``' device; the row above row 0 is zeros. Equal to
    ``ops/png_filters.py::_candidates`` and ``_signed_abs_scores``."""
    b, h, rb = _filter_input(rows, bpp)
    if _device_kind(rows) == "cpu":
        return filter_bank_plain(rows, bpp)
    lib = load()
    cands = torch.empty((b, 5, h, rb), dtype=torch.uint8, device=rows.device)
    scores = torch.empty((b, h, 5), dtype=torch.int32, device=rows.device)
    with _device_guard(rows):
        rc = lib.pixo_filter_bank(
            rows.data_ptr(), b, h, rb, bpp, filter_rows_plan(h, rb, False), cands.data_ptr(),
            scores.data_ptr(), _stream(rows)
        )
    _check(lib, rc, "filter_bank")
    filter_bank.launches += 1
    return cands, scores


filter_bank.launches = 0


FILTER_STRIP_ROWS = 8  # csrc/filter_bank.cu's kStripRows: rows a strip, a warp each
FILTER_SMEM_BUDGET = 200 * 1024  # its kStripMaxSmem: shared memory a strip may take
FILTER_BIGRAM_BYTES = 8192  # its kBigramBytes: a row's bitmap of the 65,536 byte pairs (mode 7)


def _filter_region(nbytes: int) -> int:
    """csrc/filter_bank.cu's region_bytes: the shared memory that holds
    ``nbytes`` staged bytes at any alignment."""
    return (nbytes + 63) & ~15


def filter_rows_plan(h: int, rb: int, sticky: bool, bigrams: bool = False) -> int:
    """Which kernel ``filter_rows`` launches for [*, h, rb] rows, by shape
    alone (and mode 7, ``bigrams``): the rows a thread block of the strip
    kernel takes (1 to 8), or 0 for the long-row kernel.

    A strip holds its rows, the row above them and its output rows in shared
    memory (and row 0 of the image under the sticky rule; under Bigrams, a
    bitmap of 8 KB a row). It takes as many rows as fit the budget, up to 8
    and the image's height; where fewer than 4 fit (and the image has more),
    a warp a row would leave most of the card idle, and the long-row kernel
    (a thread block a row) takes over."""
    def smem(strip):
        return (_filter_region((strip + 1) * rb) + _filter_region(strip * (rb + 1))
                + (_filter_region(rb) if sticky else 0) + (strip * FILTER_BIGRAM_BYTES if bigrams else 0))

    most = min(FILTER_STRIP_ROWS, h)
    strip = next((s for s in range(most, 0, -1) if smem(s) <= FILTER_SMEM_BUDGET), 0)
    return strip if strip >= min(4, h) else 0


def filter_rows(rows: torch.Tensor, *, bpp: int, strategy, small_image: bool,
                sticky_fast: bool) -> torch.Tensor:
    """[B, H, RB] uint8 raw rows -> [B, H, RB+1] uint8 PNG rows, each led by
    its filter id, on ``rows``' device: the fused filter stage of the batch
    encode. Arguments as ``ops/png_filters.py::filter_image_batch``
    (``strategy`` a FilterStrategy or its value; ``small_image``: area <=
    4096; ``sticky_fast``: height <= 32), whose result it equals."""
    b, h, rb = _filter_input(rows, bpp)
    strat = resolve_strategy(strategy, small_image)
    if _device_kind(rows) == "cpu":
        return filter_rows_plain(
            rows, bpp=bpp, strategy=strat, small_image=small_image, sticky_fast=sticky_fast
        )
    mode = native_mode(strat)
    sticky = sticky_fast and mode == MODE_ADAPTIVE_FAST
    lib = load()
    out = torch.empty((b, h, rb + 1), dtype=torch.uint8, device=rows.device)
    with _device_guard(rows):
        rc = lib.pixo_filter_rows(
            rows.data_ptr(), b, h, rb, bpp, mode, early_stop(mode, rb), int(sticky),
            filter_rows_plan(h, rb, sticky, mode == MODE_BIGRAMS), out.data_ptr(), _stream(rows),
        )
    _check(lib, rc, "filter_rows")
    filter_rows.launches += 1
    return out


filter_rows.launches = 0


class PlaneTable:
    """The decode tail's plane table, checked against ``n`` coefficient
    blocks and packed as ``csrc/idct.cu``'s PlaneDesc array, once.

    ``planes`` is [P, 5] int64: each plane's first block, blocks per row,
    block rows, output byte offset and output pitch. ``packed`` is [P, 38]
    int64: a plane's int32 zigzag table (32 int64), its five geometry fields
    and a pad. The tables may come later (``set_qtables``): a decoder knows
    a batch's geometry before its entropy stage has read every table."""

    def __init__(self, planes, n: int, qtables=None):
        planes = np.asarray(planes, dtype=np.int64)
        if planes.ndim != 2 or planes.shape[1] != 5 or planes.shape[0] == 0:
            raise ValueError(f"planes must be a non-empty [P, 5] table, got {planes.shape}")
        first, bpr, brows, off, pitch = planes.T
        nb = bpr * brows
        if (bpr < 1).any() or (brows < 1).any():
            raise ValueError("every plane needs at least one block")
        if first[0] < 0 or (first[1:] < first[:-1] + nb[:-1]).any() or first[-1] + nb[-1] > n:
            raise ValueError("plane block ranges must be sorted, disjoint and inside the coefficients")
        if (off < 0).any() or (off % 8).any() or (pitch % 8).any() or (pitch < 8 * bpr).any():
            raise ValueError("offsets and pitches must be multiples of 8, each pitch a full row")
        self.n = n
        self.packed = np.zeros((len(planes), 38), np.int64)
        self.packed[:, 32:37] = planes
        self.out_size = int((off + 8 * brows * pitch).max())
        self.tiled = int(64 * nb.sum()) == self.out_size  # no byte outside every plane
        if qtables is not None:
            self.set_qtables(qtables)

    @property
    def planes(self) -> np.ndarray:
        return self.packed[:, 32:37]

    @property
    def qtables(self) -> np.ndarray:
        """[P, 64] int32, each plane's zigzag table: a view of ``packed``."""
        return self.packed[:, :32].view(np.int32)

    def set_qtables(self, qtables) -> None:
        """``qtables`` is [P, 64], each plane's zigzag table, taken as int32."""
        q = np.asarray(qtables)
        if q.shape != self.qtables.shape:
            raise ValueError(f"qtables must be {list(self.qtables.shape)}, got {list(q.shape)}")
        self.qtables[...] = q.astype(np.int32)

    def output(self, device) -> torch.Tensor:
        """The output buffer: left unset where the planes tile it, zeroed
        where bytes lie outside every plane."""
        make = torch.empty if self.tiled else torch.zeros
        return make(self.out_size, dtype=torch.uint8, device=device)


def _idct_table_plain(coeffs: torch.Tensor, table: PlaneTable) -> torch.Tensor:
    dev = coeffs.device
    planes = np.ascontiguousarray(table.planes)
    nb_host = planes[:, 1] * planes[:, 2]
    first, bpr, _, off, pitch = torch.from_numpy(planes).to(dev).unbind(1)
    nb = torch.from_numpy(nb_host).to(dev)
    pid = torch.repeat_interleave(torch.arange(len(planes), device=dev), nb,
                                  output_size=int(nb_host.sum()))
    k = torch.arange(pid.numel(), device=dev) - (torch.cumsum(nb, 0) - nb)[pid]
    q = torch.from_numpy(np.ascontiguousarray(table.qtables)).to(dev)
    blocks = dequant_idct_blocks(coeffs[first[pid] + k], q[pid])
    by, bx = k // bpr[pid], k % bpr[pid]
    p = pitch[pid][:, None, None]
    r = torch.arange(8, device=dev)
    idx = (off[pid] + 8 * by * pitch[pid] + 8 * bx)[:, None, None] + r[:, None] * p + r
    out = table.output(dev)
    out[idx.reshape(-1)] = blocks.reshape(-1)
    return out


def idct_planes_plain(coeffs: torch.Tensor, qtables, planes) -> torch.Tensor:
    """The plain version of ``idct_planes`` on ``coeffs``' device:
    ``dequant_idct_blocks`` over every block of every plane, then a scatter
    of each 8x8 block to its plane's raster."""
    return _idct_table_plain(coeffs, PlaneTable(planes, coeffs.shape[0], qtables))


def idct_planes(coeffs: torch.Tensor, qtables, planes) -> torch.Tensor:
    """[N, 64] int16 zigzag coefficient blocks -> one uint8 buffer holding
    every plane's pixels, on ``coeffs``' device: the decode tail's dequantize,
    un-zigzag, jidctint IDCT and plane assembly in one launch.

    ``planes`` ([P, 5] int64, host) gives each plane's first block, blocks
    per row, block rows, byte offset and pitch; a plane's blocks are in
    raster order and block (by, bx) lands at offset + 8 by pitch + 8 bx.
    ``qtables`` ([P, 64], host) gives each plane's zigzag table (uint16
    values, taken as int32). Each plane equals ``assemble_plane`` of
    ``ops/jpeg_decode.py::dequant_idct_blocks`` of its blocks. Planes must
    not overlap in the output. A caller that keeps a ``PlaneTable`` takes
    ``idct_planes_table`` and spares the checks and the packing."""
    _idct_input(coeffs)
    return idct_planes_table(coeffs, PlaneTable(planes, coeffs.shape[0], qtables))


def _idct_input(coeffs: torch.Tensor) -> None:
    _require(coeffs, torch.int16, "coeffs")
    if coeffs.dim() != 2 or coeffs.shape[1] != 64:
        raise ValueError(f"coeffs must be [N, 64], got {tuple(coeffs.shape)}")
    if _device_kind(coeffs) == "cuda" and coeffs.shape[0] == 0:
        raise ValueError("empty batch")


def upload_pinned(host: np.ndarray, device) -> torch.Tensor:
    """``host`` (which may be read-only) on ``device``, copied through pinned
    memory on the current stream without waiting for it. PyTorch's
    pinned-memory cache hands the staging block out again only once the copy
    has run."""
    dtype = torch.from_numpy(np.empty(0, host.dtype)).dtype
    pinned = torch.empty(host.shape, dtype=dtype, pin_memory=True)
    pinned.numpy()[...] = host
    return pinned.to(device, non_blocking=True)


def idct_planes_table(coeffs: torch.Tensor, table: PlaneTable, desc=None) -> torch.Tensor:
    """``idct_planes`` with its plane table checked and packed beforehand.
    ``desc`` is ``table.packed`` on ``coeffs``' device where the caller has
    copied it there already (with the coefficients, say); without it the
    table goes up here, through pinned memory, without a wait."""
    _idct_input(coeffs)
    if coeffs.shape[0] != table.n:
        raise ValueError(f"the plane table was checked for {table.n} blocks, got {coeffs.shape[0]}")
    if _device_kind(coeffs) == "cpu":
        return _idct_table_plain(coeffs, table)
    if desc is None:
        desc = upload_pinned(table.packed, coeffs.device)
    elif (desc.device != coeffs.device or desc.dtype != torch.int64
          or tuple(desc.shape) != table.packed.shape or not desc.is_contiguous()
          or desc.data_ptr() % 16):
        raise ValueError("desc must be the packed plane table on the coefficients' device")
    lib = load()
    out = table.output(coeffs.device)
    with _device_guard(coeffs):
        rc = lib.pixo_idct_planes(coeffs.data_ptr(), coeffs.shape[0], desc.data_ptr(),
                                  desc.shape[0], out.data_ptr(), _stream(coeffs))
    _check(lib, rc, "idct_planes")
    idct_planes.launches += 1
    return out


idct_planes.launches = 0


def idct8x8_int(blocks: torch.Tensor) -> torch.Tensor:
    """[N, 8, 8] int32 natural-order dequantized blocks -> [N, 8, 8] uint8,
    bit-exact with ``ops/jpeg_decode.py::idct8x8_int`` (int32 wraparound)."""
    _require(blocks, torch.int32, "blocks")
    if blocks.dim() != 3 or tuple(blocks.shape[1:]) != (8, 8):
        raise ValueError(f"blocks must be [N, 8, 8], got {tuple(blocks.shape)}")
    if _device_kind(blocks) == "cpu":
        return idct8x8_int_plain(blocks)
    if blocks.shape[0] == 0:
        raise ValueError("empty batch")
    lib = load()
    out = torch.empty(blocks.shape, dtype=torch.uint8, device=blocks.device)
    with _device_guard(blocks):
        rc = lib.pixo_idct8x8_int(blocks.data_ptr(), out.data_ptr(), blocks.shape[0],
                                  _stream(blocks))
    _check(lib, rc, "idct8x8_int")
    idct8x8_int.launches += 1
    return out


idct8x8_int.launches = 0


def _taps(starts, weights, device, axis: str):
    """One axis' tap table as contiguous tensors on ``device``: starts [dst]
    int32 and weights [dst, K] float32 (numpy arrays or tensors). A tensor
    pair already so placed comes back as it is."""
    if not (isinstance(starts, torch.Tensor) and isinstance(weights, torch.Tensor)):
        starts, weights = torch.as_tensor(starts), torch.as_tensor(weights)
    if starts.dtype != torch.int32 or weights.dtype != torch.float32:
        raise TypeError(f"{axis} taps must be int32 starts and float32 weights, "
                        f"got {starts.dtype} and {weights.dtype}")
    if (starts.dim() != 1 or weights.dim() != 2 or weights.shape[0] != starts.shape[0]
            or weights.numel() == 0):
        raise ValueError(f"{axis} taps must be starts [dst] and weights [dst, K >= 1], got "
                         f"{tuple(starts.shape)} and {tuple(weights.shape)}")
    if starts.device != device or not starts.is_contiguous():
        starts = starts.to(device).contiguous()
    if weights.device != device or not weights.is_contiguous():
        weights = weights.to(device).contiguous()
    return starts, weights


def _device_taps(starts, weights, device, axis: str):
    """``_taps`` as the kernel takes them: K a multiple of 4 (zero weights
    appended, which change no sum) and the weights 16-byte aligned.
    ``ops/resize_kernels.py::_taps_on`` makes its device copies so."""
    starts, weights = _taps(starts, weights, device, axis)
    if weights.shape[1] % 4 or weights.data_ptr() % 16:
        weights = pad_taps(weights)
    return starts, weights


RESIZE_THREADS = 256  # csrc/resize.cu's kResizeThreads: the most threads of a tile
RESIZE_SMEM_BUDGET = 232448 - 1024  # its kResizeMaxSmem: 227 KB, less 1 KB for static variables
RESIZE_TILE_COLS = (32, 64, 128)  # output columns a horizontal tile may take


class ResizePlan(NamedTuple):
    """The resize kernel's launches for one shape (``resize_plan``)."""

    cols: int  # output columns of a horizontal tile; 0: the direct route
    quads: int  # groups of 4 source rows a tile takes at once (cols * quads threads)
    span: int  # source pixels of a row a tile can stage (its slots, a multiple of 8)
    smem: int  # shared-memory bytes of a horizontal thread block
    vertical: str  # a thread's bytes of an output row: "granules" (16), "words" (4) or "bytes" (1)

    @property
    def horizontal(self) -> str:
        return "tiled" if self.cols else "direct"


def _align16(n: int) -> int:
    return (n + 15) & ~15


def resize_smem(cols: int, quads: int, span: int, k: int, c: int) -> int:
    """csrc/resize.cu's tile_smem: the weights [k][cols] f32, the slots
    [quads][span + 2] of 32 bytes (four rows' channels as halves) and 4 *
    quads rows of the source span as copied (16-byte chunks at any
    alignment)."""
    return 4 * k * cols + 32 * quads * (span + 2) + 4 * quads * _align16(span * c + 32)


def resize_tile(w: int, c: int, dw: int, k: int, cols: int, quads: int,
                vertical: str) -> ResizePlan:
    """The horizontal tile of ``cols`` columns and ``quads`` row groups for
    rows of ``w`` pixels of ``c`` channels to ``dw`` with windows of ``k``
    taps (a multiple of 4): its span (``resize_plan`` says why) and its
    shared memory."""
    span = -(-min(-(-(min(cols, dw) - 1) * w // dw) + 2 + k, w + k) // 8) * 8
    return ResizePlan(cols, quads, span, resize_smem(cols, quads, span, k, c), vertical)


@functools.lru_cache(maxsize=256)
def resize_plan(b: int, h: int, w: int, c: int, dh: int, dw: int, kx: int, ky: int) -> ResizePlan:
    """How ``resize_lanczos3`` launches for [b, h, w, c] -> [b, dh, dw, c]
    with windows of ``kx`` and ``ky`` taps, by shape alone.

    The horizontal tile takes the fewest columns of ``RESIZE_TILE_COLS``
    that cover the output row (128 beyond it) and 256 threads. Its span is
    what ``lanczos_taps``' starts can need: the windows of ``cols``
    neighbouring outputs lie at most (cols - 1) * w / dw pixels apart (2 more
    for the floor and the f32 rounding of the centres), plus a window,
    rounded up to a multiple of 8 slots (the kernel's swizzle). Where
    that does not fit ``RESIZE_SMEM_BUDGET``, the tile takes fewer row
    groups, then fewer columns; where not even 32 columns of one group fit,
    the pass takes the direct route (pixels from global memory). The
    vertical pass takes 16-byte granules where an output row is a whole
    number of them, else words where it is a whole number of those."""
    k = -(-kx // 4) * 4
    n = dw * c
    vertical = "granules" if n % 16 == 0 else "words" if n % 4 == 0 else "bytes"
    cols = next((t for t in RESIZE_TILE_COLS if t >= dw), RESIZE_TILE_COLS[-1])
    quads = RESIZE_THREADS // cols
    while True:
        plan = resize_tile(w, c, dw, k, cols, quads, vertical)
        if plan.smem <= RESIZE_SMEM_BUDGET:
            return plan
        if quads > 1:
            quads //= 2
        elif cols > RESIZE_TILE_COLS[0]:
            cols //= 2
        else:
            return ResizePlan(0, 0, 0, 0, vertical)


def resize_lanczos3_plain(imgs: torch.Tensor, sx, wx, sy, wy) -> torch.Tensor:
    """The plain version of ``resize_lanczos3`` on ``imgs``' device: the
    horizontal then the vertical ``ops/resize_kernels.py::_lanczos_pass``."""
    sx, wx = _taps(sx, wx, imgs.device, "x")
    sy, wy = _taps(sy, wy, imgs.device, "y")
    return _lanczos_pass(_lanczos_pass(imgs, sx, wx, 2), sy, wy, 1)


def resize_lanczos3(imgs: torch.Tensor, sx, wx, sy, wy) -> torch.Tensor:
    """[B, H, W, C] uint8 -> [B, dst_h, dst_w, C] uint8 on ``imgs``' device:
    the separable Lanczos3 resize of a same-shape group.

    ``sx`` [dst_w] int32 and ``wx`` [dst_w, Kx] float32 are the horizontal
    windows (first source column and weights of each output column), ``sy``
    and ``wy`` the vertical ones, as ``ops/resize_kernels.py::lanczos_taps``
    makes them (numpy arrays, or tensors already on the device). Each output
    is a serial f32 accumulation of its window's taps in index order, source
    indices clamped to the image, rounded half away from zero and clamped to
    uint8, with a uint8 intermediate between the passes: byte-identical to
    ``resize_lanczos3_np`` and the host library. On the card C is at most 4;
    the launches follow ``resize_plan``."""
    # the kernel takes images at any byte offset (a group of a decoded batch)
    if imgs.dtype != torch.uint8:
        raise TypeError(f"imgs must be torch.uint8, got {imgs.dtype}")
    if not imgs.is_contiguous():
        raise ValueError("imgs must be contiguous")
    if imgs.dim() != 4 or imgs.numel() == 0:
        raise ValueError(f"imgs must be a non-empty [B, H, W, C] tensor, got {tuple(imgs.shape)}")
    if _device_kind(imgs) == "cpu":
        return resize_lanczos3_plain(imgs, sx, wx, sy, wy)
    b, h, w, c = imgs.shape
    if c > RESIZE_MAX_CHANNELS:
        raise ValueError(f"the resize kernel takes at most {RESIZE_MAX_CHANNELS} channels, got {c}")
    sx, wx = _device_taps(sx, wx, imgs.device, "x")
    sy, wy = _device_taps(sy, wy, imgs.device, "y")
    dw, dh, kx, ky = wx.shape[0], wy.shape[0], wx.shape[1], wy.shape[1]
    plan = resize_plan(b, h, w, c, dh, dw, kx, ky)
    lib = load()
    # the intermediate and the result in one allocation, the result 16-byte aligned
    mid = _align16(b * h * dw * c)
    buf = torch.empty(mid + b * dh * dw * c, dtype=torch.uint8, device=imgs.device)
    out = buf[mid:].view(b, dh, dw, c)
    with _device_guard(imgs):
        rc = lib.pixo_resize_lanczos3(
            imgs.data_ptr(), b, h, w, c, sx.data_ptr(), wx.data_ptr(), kx, dw,
            sy.data_ptr(), wy.data_ptr(), ky, dh, buf.data_ptr(), out.data_ptr(),
            plan.cols, plan.quads, plan.span, _stream(imgs),
        )
    _check(lib, rc, "resize_lanczos3")
    resize_lanczos3.launches += 1
    return out


resize_lanczos3.launches = 0


PALETTE_MAX = 256  # csrc/quantize.cu's kMaxPalette: indices are uint8
LUT_SIZE = 64 * 64 * 64
QUANTIZE_MAX_BATCH = 65535  # palettes a quantization wrapper takes: the LUT launch's gridDim.y


def _quantize_inputs(tensors, batch: int, k: int) -> None:
    """The common checks of the three quantization wrappers: dtypes,
    contiguity, one device, and a batch and palette size the kernels take.
    The kernels read their bytes one by one, so a tensor may start at any
    offset of its buffer."""
    for t, dtype, name in tensors:
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devices = {t.device for t, _, _ in tensors}
    if len(devices) != 1:
        raise ValueError(f"the tensors lie on several devices: {sorted(map(str, devices))}")
    _device_kind(tensors[0][0])
    if not (1 <= batch <= QUANTIZE_MAX_BATCH and 1 <= k <= PALETTE_MAX):
        raise ValueError(f"a batch of 1 to {QUANTIZE_MAX_BATCH} palettes of 1 to {PALETTE_MAX} "
                         f"entries is taken, got {batch} of {k}")


KMEANS_CHUNK_MIN = 64  # colours a chunk takes at least: a colour a thread of csrc/quantize.cu's two warps
KMEANS_CHUNK_MAX = 1024
KMEANS_CHUNKS_PER_SM = 8  # about 16 warps an SM


class KmeansPlan(NamedTuple):
    """The k-means kernel's schedule for a batch (``kmeans_plan``)."""

    chunks: np.ndarray  # [n, 4] int32: image, first colour, end, chunks of that image
    per_chunk: int  # colours a chunk takes at most


@functools.lru_cache(maxsize=64)
def kmeans_plan(counts: tuple, sms: int = H100_SMS) -> KmeansPlan:
    """How ``kmeans_refine`` splits a batch whose image i has its colours of
    non-zero weight among its first ``counts[i]``: chunks of at most
    ``per_chunk`` colours, the batch's total over ``KMEANS_CHUNKS_PER_SM``
    chunks an SM, clamped to 64..1024; each image's colours cut into the
    fewest such chunks, of sizes that differ by at most one, and an image
    without colours in one empty chunk (its last CTA still writes its
    palette). A CTA takes a chunk."""
    if not counts or min(counts) < 0:
        raise ValueError(f"a count of colours, at least 0, an image is taken, got {counts[:8]}")
    total = sum(counts)
    per = min(KMEANS_CHUNK_MAX, max(KMEANS_CHUNK_MIN, -(-total // (sms * KMEANS_CHUNKS_PER_SM))))
    rows = []
    for i, n in enumerate(counts):
        parts = max(1, -(-n // per))
        cuts = [n * j // parts for j in range(parts + 1)]
        rows += [(i, cuts[j], cuts[j + 1], parts) for j in range(parts)]
    return KmeansPlan(np.asarray(rows, np.int32).reshape(-1, 4), per)


@functools.lru_cache(maxsize=16)
def _kmeans_chunks_on(counts: tuple, sms: int, device: torch.device) -> torch.Tensor:
    """``kmeans_plan(counts, sms).chunks`` on ``device``, cached."""
    return torch.from_numpy(kmeans_plan(counts, sms).chunks).to(device)


_kmeans_scratch = {}  # (device, stream) -> int64 zeros: [B, K, 5] sums, then [B] uint32 tickets


def _kmeans_scratch_for(device: torch.device, stream: int, words: int) -> torch.Tensor:
    """The k-means kernel's scratch on ``device`` for launches on
    ``stream``, ``words`` int64 at least: zero, and left zero by every call,
    so it is allocated once and grown, never cleared."""
    buf = _kmeans_scratch.get((device, stream))
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int64, device=device)
        _kmeans_scratch[(device, stream)] = buf
    return buf


def kmeans_refine(palette: torch.Tensor, colors: torch.Tensor, weights: torch.Tensor,
                  k_valid: torch.Tensor, counts=None) -> torch.Tensor:
    """Weighted k-means refinement (two iterations) of a batch of palettes,
    on their device: palette [B, K, 4] uint8, colors [B, M, 4] uint8,
    weights [B, M] int32 (non-negative), k_valid [B] int32 (each palette's
    real entries; the rows past it take no colour) -> [B, K, 4] uint8, equal to
    ``ops/quantize_device.py::kmeans_refine`` and to the host tier's
    ``refine_palette_kmeans`` of the unpadded palette. ``counts`` (B ints on
    the host, or None for M each): the kernel scans image i's first
    counts[i] colours only, so every colour past them must weigh 0 (the
    padding of ``png/quantize.py::_pad_hist``); it sets the schedule
    (``kmeans_plan``), not the result."""
    if palette.dim() != 3 or palette.shape[2] != 4 or colors.dim() != 3 or colors.shape[2] != 4:
        raise ValueError(f"palette and colors must be [B, K, 4] and [B, M, 4], got "
                         f"{tuple(palette.shape)} and {tuple(colors.shape)}")
    b, k, m = palette.shape[0], palette.shape[1], colors.shape[1]
    if colors.shape[0] != b or tuple(weights.shape) != (b, m) or tuple(k_valid.shape) != (b,):
        raise ValueError(f"weights must be [{b}, {m}] and k_valid [{b}], got "
                         f"{tuple(weights.shape)} and {tuple(k_valid.shape)}")
    _quantize_inputs([(palette, torch.uint8, "palette"), (colors, torch.uint8, "colors"),
                      (weights, torch.int32, "weights"), (k_valid, torch.int32, "k_valid")], b, k)
    if m < 1 or m > 0x7FFFFFFF:
        raise ValueError(f"1 to 2^31 - 1 colours an image are taken, got {m}")
    counts = (m,) * b if counts is None else tuple(int(n) for n in counts)
    if len(counts) != b or not all(0 <= n <= m for n in counts):
        raise ValueError(f"counts must be {b} numbers of 0 to {m} colours, got {counts[:8]}")
    if _device_kind(palette) == "cpu":
        return quantize_device.kmeans_refine(palette, colors, weights, k_valid)
    dev = palette.device
    chunks = _kmeans_chunks_on(counts, _sm_count(dev), dev)
    stream = _stream(palette)
    scratch = _kmeans_scratch_for(dev, stream, b * k * 5 + -(-b // 2))
    out = torch.empty_like(palette)
    lib = load()
    with _device_guard(palette):
        rc = lib.pixo_kmeans_refine(palette.data_ptr(), b, k, k_valid.data_ptr(), colors.data_ptr(),
                                    weights.data_ptr(), m, chunks.data_ptr(), chunks.shape[0],
                                    scratch.data_ptr(), scratch.data_ptr() + 8 * b * k * 5,
                                    out.data_ptr(), stream)
    if rc:
        _kmeans_scratch.pop((dev, stream), None)
    _check(lib, rc, "kmeans_refine")
    kmeans_refine.launches += 1
    return out


kmeans_refine.launches = 0


def _k_valid_inputs(k_valid: Optional[torch.Tensor], b: int) -> list:
    """``_quantize_inputs``' entry for an optional k_valid [B] int32."""
    if k_valid is None:
        return []
    if tuple(k_valid.shape) != (b,):
        raise ValueError(f"k_valid must be [{b}], got {tuple(k_valid.shape)}")
    return [(k_valid, torch.int32, "k_valid")]


def palette_lut(palette: torch.Tensor, k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, K, 4] uint8 palettes -> [B, 262144] uint8 6-6-6 opaque LUTs on
    their device: entry (r6 << 12 | g6 << 6 | b6) is the nearest palette
    entry of the grid colour with each 6-bit value v widened to (v << 2) |
    (v >> 4), alpha 255, among each palette's first ``k_valid`` entries
    ([B] int32, clamped to 1..K; all K without it). Equal to
    ``ops/quantize_device.py::palette_lut`` and the host library's
    ``palette_lut_build`` of those entries."""
    if palette.dim() != 3 or palette.shape[2] != 4:
        raise ValueError(f"palette must be [B, K, 4], got {tuple(palette.shape)}")
    b, k = palette.shape[:2]
    _quantize_inputs([(palette, torch.uint8, "palette")] + _k_valid_inputs(k_valid, b), b, k)
    if _device_kind(palette) == "cpu":
        return quantize_device.palette_lut(palette, k_valid)
    lib = load()
    out = torch.empty((b, LUT_SIZE), dtype=torch.uint8, device=palette.device)
    with _device_guard(palette):
        rc = lib.pixo_palette_lut(palette.data_ptr(), b, k, None if k_valid is None else k_valid.data_ptr(),
                                  out.data_ptr(), _stream(palette))
    _check(lib, rc, "palette_lut")
    palette_lut.launches += 1
    return out


palette_lut.launches = 0

DITHER_BAND = 32  # csrc/quantize.cu's band: a warp takes 32 rows, a lane a row
DITHER_MAX_WARPS = 32  # csrc/quantize.cu's kDitherMaxWarps
DITHER_LAG = 65  # steps between two bands' starts: 2 a row of the band above, 1 to read ahead
DITHER_RING_MIN = 128  # slots of a ring whose reader never waits on its own earlier band
DITHER_RING_SMEM = 232448 - 4096 - 1024  # 227 KB, less the palette and 1 KB for static variables
DITHER_MAX_PIXELS = 0x7FFFFFFF // 4  # the kernel's per-image offsets are 32-bit


class DitherPlan(NamedTuple):
    """The dither kernel's launch for one image shape (``dither_plan``)."""

    warps: int  # warps of the CTA that takes one image; warp j takes bands j, j + warps, ...
    ring_slots: int  # 32-bit slots of each warp's input ring (the row above its band)
    ring: str  # where the rings live: "shared" memory, or a "global" scratch past the budget
    smem: int  # dynamic shared-memory bytes: the rings, or 0 on the global scratch
    steps: int  # steps on the critical path
    grown: int  # of them, the steps beyond the wavefront's W + 2(H - 1): a band edge's and the cap's


def dither_ring_slots(w: int, warps: int, bands: int) -> int:
    """Slots of each ring for rows of ``w`` pixels in ``bands`` bands on
    ``warps`` warps: 128 where no band waits for its warp to finish an
    earlier one; where bands wrap round the warps, a multiple of 32 with
    warps x (slots - 65) >= W, which keeps the CTA from deadlocking
    (``dither_plan``) and the writers from waiting."""
    if bands <= warps:
        return DITHER_RING_MIN
    return max(DITHER_RING_MIN, -(-(-(-w // warps) + DITHER_LAG) // 32) * 32)


@functools.lru_cache(maxsize=256)
def dither_plan(h: int, w: int) -> DitherPlan:
    """How ``dither_fs`` launches for images of ``h`` x ``w``, by shape alone.

    One CTA an image. A warp takes a band of 32 rows, a lane a row; band c
    starts 65 steps after band c - 1 (at step s its lane 0 takes the error
    of the row above at column s + 1 and reads column s + 2 ahead, which that
    band's lane 31 makes 64 steps into it) and takes W + 2(rows - 1) steps.
    So the path is the wavefront's W + 2(H - 1) steps and one a band edge.
    Warp j takes bands j, j + warps, ...; the warps are the least count that
    finishes a band (W + 62 steps) before its next one is due, 65 x warps
    steps later, capped at 32 and at the bands. Where the cap binds, a
    warp's next band waits for it, and the path grows by that too.

    Each warp reads the row above its band from a ring that the warp before
    it writes, one 32-bit slot a column. A writer waits for free slots, so
    the rings must hold what the warps cannot: where bands wrap round the
    warps, every warp in a band and each waiting on the next, the rings
    together must hold about a row, or the CTA deadlocks: the slots keep
    warps x (slots - 65) >= W (``dither_ring_slots``). Where bands do not
    wrap the reader never waits on its own earlier band, and 128 slots
    suffice. The rings live in shared memory up to ``DITHER_RING_SMEM``
    (rows of ~54,000 pixels at 32 warps), in a global scratch beyond."""
    if h < 1 or w < 1:
        raise ValueError(f"an image of at least one pixel is taken, got {h}x{w}")
    if h * w > DITHER_MAX_PIXELS:
        raise ValueError(f"the dither takes images of at most {DITHER_MAX_PIXELS} pixels, got {h}x{w}")
    bands = -(-h // DITHER_BAND)
    warps = min(DITHER_MAX_WARPS, bands, -(-(w + 2 * (DITHER_BAND - 1)) // DITHER_LAG))
    slots = dither_ring_slots(w, warps, bands)
    band_steps = w + 2 * (DITHER_BAND - 1)
    last = bands - 1
    if band_steps <= DITHER_LAG * warps or bands <= warps:
        start = DITHER_LAG * last
    else:  # round q of the bands starts when each warp has finished its band of round q - 1
        start = (last // warps) * band_steps + (last % warps) * DITHER_LAG
    steps = start + w + 2 * (h - DITHER_BAND * last - 1)
    ring_bytes = 4 * warps * slots
    ring = "shared" if ring_bytes <= DITHER_RING_SMEM else "global"
    return DitherPlan(warps, slots, ring, ring_bytes if ring == "shared" else 0, steps,
                      steps - (w + 2 * (h - 1)))


def dither_fs(rgba: torch.Tensor, palette: torch.Tensor, lut: torch.Tensor,
              k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Floyd-Steinberg dithering of a batch on its device: [B, H, W, 4]
    uint8 pixels, [B, K, 4] uint8 palettes, [B, 262144] uint8 LUTs (each
    palette's ``palette_lut``) -> [B, H, W] uint8 palette indices, equal to
    ``ops/quantize_device.py::dither_fs`` and the host library's sequential
    ``dither_fs``. A pixel whose alpha is not 255 takes the nearest of its
    palette's first ``k_valid`` entries ([B] int32, clamped to 1..K; all K
    without it). The launch follows ``dither_plan``."""
    if rgba.dim() != 4 or rgba.shape[3] != 4 or rgba.numel() == 0:
        raise ValueError(f"rgba must be a non-empty [B, H, W, 4] tensor, got {tuple(rgba.shape)}")
    b, h, w = rgba.shape[:3]
    if palette.dim() != 3 or palette.shape[0] != b or palette.shape[2] != 4:
        raise ValueError(f"palette must be [{b}, K, 4], got {tuple(palette.shape)}")
    if tuple(lut.shape) != (b, LUT_SIZE):
        raise ValueError(f"lut must be [{b}, {LUT_SIZE}], got {tuple(lut.shape)}")
    _quantize_inputs([(rgba, torch.uint8, "rgba"), (palette, torch.uint8, "palette"),
                      (lut, torch.uint8, "lut")] + _k_valid_inputs(k_valid, b), b, palette.shape[1])
    if _device_kind(rgba) == "cpu":
        return quantize_device.dither_fs(rgba, palette, lut, k_valid)
    plan = dither_plan(h, w)
    lib = load()
    out = torch.empty((b, h, w), dtype=torch.uint8, device=rgba.device)
    ring = (torch.empty((b, plan.warps, plan.ring_slots), dtype=torch.int32, device=rgba.device)
            if plan.ring == "global" else None)
    with _device_guard(rgba):
        rc = lib.pixo_dither_fs(rgba.data_ptr(), b, h, w, palette.data_ptr(), palette.shape[1],
                                None if k_valid is None else k_valid.data_ptr(),
                                lut.data_ptr(), plan.warps, plan.ring_slots,
                                None if ring is None else ring.data_ptr(), out.data_ptr(), _stream(rgba))
    _check(lib, rc, "dither_fs")
    dither_fs.launches += 1
    return out


dither_fs.launches = 0
