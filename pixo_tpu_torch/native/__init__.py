"""ctypes bindings to the C++ host tier.

The port's host library is its own ``native/core.cpp``: a copy of the JAX
package's in which the two checksum exports are named ``pixo_crc32`` and
``pixo_adler32``, so that nothing it exports carries zlib's names. A change
to it must leave every output as it was: ``tests/test_torch_native_parity.py``
holds each export to the JAX package's library. It is compiled into the
port's library in ``pixo_tpu_torch/_build/`` with the JAX package's flags,
profile-guided as the JAX package builds it:
an instrumented compile, the port's own training battery
(``_pgo_train.py``, the port's ``device="cpu"`` paths on synthetic inputs)
run in a subprocess on that library, and a compile that reads the profile
(``utils/build.py``). ``PIXO_TPU_NO_PGO=1`` builds the plain library
instead; the two sit side by side in ``_build/``, and their output bytes
are the same. Every export of the library is bound:

- ``jpeg_pack_scan`` / ``jpeg_pack_scan_batch``: dense [nblocks, 64] packers
  (the compaction-overflow fallback);
- ``jpeg_pack_scan_padded``: the packer that reads the device's padded
  per-block streams (``ops/sparse_pack.py``);
- ``jpeg_pack_scan_sparse``: the packer of the flat compaction route
  (``ops/sparse_pack.py::sparsify_blocks``), which no entry point takes;
- ``jpeg_coefficients`` and ``jpeg_encode_scan_fused``: the host
  coefficient pipeline and the fused host encode: the JPEG encode's host
  tier (``jpeg/encoder.py``, ``device="cpu"``), and the references that
  the device path is held against;
- ``jpeg_dct_zz`` and ``jpeg_trellis_quantize``: the trellis quantizer's
  host tier (the same chain as ``jpeg_coefficients`` up to the unquantized
  zigzag DCT, then the Viterbi DP on threads), and the oracles of the DCT
  and trellis kernels;
- ``jpeg_count_symbols``: the baseline scan's symbol histograms, the host
  tier's count and the oracle of the count kernel;
- ``jpeg_count_progressive_scan`` and ``jpeg_encode_progressive_scan``: one
  progressive scan's symbol counts and entropy bytes
  (``jpeg/progressive.py``);
- ``huffman_build_lengths``: length-limited code lengths by package-merge
  (``compress/huffman.py``, the optimal JPEG tables);
- ``deflate_compress`` / ``deflate_compress_parity``: the zlib-wrapped
  DEFLATE of every PNG encode (``compress/deflate.py``);
- ``deflate_compress_optimal`` / ``deflate_optimal_parity``: the iterative
  optimal parse of the PNG ``max`` preset (``compress/deflate.py::
  deflate_optimal_zlib``), the performance path and the reference mirror;
- ``deflate_compress_optimal_assisted``: the same performance parse reading
  the first chain steps from tables made on the card
  (``ops/lz77_assist.py::chain_candidates``), the ``PIXO_TPU_LZ77=device``
  route, byte-identical to the plain entry;
- ``png_filter_apply``: the host PNG filter tier of the per-image encode,
  and an oracle for the filter kernel;
- ``pixo_crc32`` and ``pixo_adler32``: the PNG chunk checksum and zlib's
  (``compress/checksums.py``);
- ``jpeg_decode_scan``, ``jpeg_prog_dc_segment`` and ``jpeg_prog_ac_segment``:
  the JPEG decode's entropy stage, baseline and progressive, writing int16
  zigzag coefficient planes in place (a baseline scan as a prepared call that
  may run on another thread; a progressive scan segment by segment);
- ``jpeg_decode_pixels`` and ``jpeg_decode_baseline``: the host pixel tail
  and the fused host decode, oracles only (tests and ``chip_smoke.py``
  hold the decode's device tail against them; no path of the port runs
  them);
- ``inflate_decompress``: INFLATE into a buffer of exactly the expected
  size (``compress/deflate.py``), the PNG decode's first stage;
- ``png_unfilter`` and ``png_palette_expand``: the PNG decode's row
  reconstruction and its palette gather (``decode/png_decoder.py``);
- ``resize_lanczos3_host``: the separable Lanczos3 resize in the serial f32
  tap order: the oracle that the resize kernel and its plain version are
  held to (no path of the port calls it);
- ``nearest_palette_batch``, ``palette_lut_build`` and ``dither_fs``: the
  lossy PNG's host tier (``png/quantize.py``: redmean argmin, the 6-6-6
  opaque LUT, sequential Floyd-Steinberg), and the oracles that the
  quantization kernels are held to.

Unlike the JAX package, a failed build or load raises, and a failed step of
the profile-guided build does not fall back to the plain build: there is no
Python fallback tier here, and a silent ``None`` would hide the failure.
"""

from __future__ import annotations

import ctypes
import os
import sys
import threading
from typing import Callable, Optional, Sequence

import numpy as np

from ..ops.blockify import num_blocks
from ..utils.build import Built, Training, build_shared_library

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "core.cpp")

COMMAND = [
    "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
    "-march=native", "-fno-exceptions", "-fvisibility=hidden", "-pthread",
    # the AAN DCT of jpeg_coefficients is bit-exact only without FMA contraction
    "-ffp-contract=off",
    # the library's own calls bind to its own definitions, whatever a process
    # loaded first (torch's CUDA libraries load libz)
    "-Wl,-Bsymbolic",
]

# Coefficient modes, as numbered by the host library and the CUDA kernel.
MODES = {"gray": 0, "444": 1, "420": 2, "422": 3}

# the training battery of the profile-guided build, run as
# ``python -m pixo_tpu_torch.native._pgo_train <instrumented library>``
TRAINING = Training(
    command=[sys.executable, "-m", "pixo_tpu_torch.native._pgo_train"],
    files=[os.path.join(os.path.dirname(os.path.abspath(__file__)), "_pgo_train.py")],
    cwd=_REPO,
)

_lib = None
_lock = threading.Lock()
library_path = ""  # the library load() loaded
profile_guided = False  # whether it was built with a profile
build_seconds = {}  # each step of its build in this process: seconds; empty when already built


def _cpu_flags() -> str:
    """The host CPU's feature flags: a ``-march=native`` library is valid
    only on a CPU that has them, so they are part of the build's key."""
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("flags")), "")
    except OSError:
        return ""


def _build(pgo: bool) -> Built:
    """The host library, profile-guided or plain, built at first use."""
    return build_shared_library("pixo_core", COMMAND, [SOURCE], timeout=600, key=_cpu_flags(),
                                training=TRAINING if pgo else None)


def _open(path: str):
    lib = ctypes.CDLL(path)
    _configure(lib)
    return lib


def load():
    """Build (at first use) and load the host library, profile-guided unless
    ``PIXO_TPU_NO_PGO`` is set; raises on failure."""
    global _lib, library_path, profile_guided, build_seconds
    with _lock:
        if _lib is None:
            pgo = not os.environ.get("PIXO_TPU_NO_PGO")
            built = _build(pgo)
            _lib = _open(built.path)
            library_path, profile_guided, build_seconds = built.path, pgo, dict(built.steps)
    return _lib


def _load_instrumented(path: str) -> None:
    """Make the library at ``path`` (the profile-guided build's instrumented
    one) the one every binding calls: the training battery's, which never
    builds."""
    global _lib
    with _lock:
        _lib = _open(path)


_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_i16p = ctypes.POINTER(ctypes.c_int16)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f32p = ctypes.POINTER(ctypes.c_float)
_i16pp = ctypes.POINTER(_i16p)

# dc lum codes/lens, dc chrom codes/lens, ac lum codes/lens, ac chrom codes/lens
_HUFF = [_u16p, _u8p, _u16p, _u8p, _u16p, _u8p, _u16p, _u8p]


def _configure(lib) -> None:
    lib.jpeg_pack_scan.restype = ctypes.c_int64
    lib.jpeg_pack_scan.argtypes = [
        _i16p, ctypes.c_int64,           # zz coeffs, nblocks
        _u8p, ctypes.c_int32,            # pattern, blocks per mcu
        *_HUFF,
        ctypes.c_int32,                  # restart interval (0 = off)
        _u8p, ctypes.c_int64,            # out buffer, capacity
    ]
    lib.jpeg_pack_scan_sparse.restype = ctypes.c_int64
    lib.jpeg_pack_scan_sparse.argtypes = [
        _i16p, _u8p, _u8p, _i16p,        # dc, counts, flat positions, flat values
        ctypes.c_int64,                  # nblocks
        _u8p, ctypes.c_int32,            # pattern, blocks per mcu
        *_HUFF,
        ctypes.c_int32,                  # restart interval (0 = off)
        _u8p, ctypes.c_int64,            # out buffer, capacity
    ]
    lib.jpeg_pack_scan_padded.restype = ctypes.c_int64
    lib.jpeg_pack_scan_padded.argtypes = [
        _i16p, _u8p, _u8p, _i16p,        # dc, counts, positions, values
        ctypes.c_int64, ctypes.c_int32,  # nblocks, per-block row stride
        _u8p, ctypes.c_int32,            # pattern, blocks per mcu
        *_HUFF,
        ctypes.c_int32,                  # restart interval (0 = off)
        _u8p, ctypes.c_int64,            # out buffer, capacity
    ]
    lib.jpeg_pack_scan_batch.restype = ctypes.c_int32
    lib.jpeg_pack_scan_batch.argtypes = [
        _i16p, ctypes.c_int32, ctypes.c_int64,  # zz, batch, blocks per image
        _u8p, ctypes.c_int32,                   # pattern, blocks per mcu
        *_HUFF,
        ctypes.c_int32,                         # restart interval (0 = off)
        _u8p, ctypes.c_int64,                   # out buffer, per-image capacity
        _i64p,                                  # out lengths [batch]
        ctypes.c_int32,                         # threads
    ]
    lib.jpeg_coefficients.restype = ctypes.c_int64
    lib.jpeg_coefficients.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # img, h, w, c_in
        ctypes.c_int32,                                        # mode
        _f32p, _f32p,                                          # qlum, qchrom (natural [64])
        _i16p,                                                 # out [nblocks, 64]
    ]
    lib.jpeg_encode_scan_fused.restype = ctypes.c_int64
    lib.jpeg_encode_scan_fused.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # img, h, w, c_in
        ctypes.c_int32,                                        # mode
        _f32p, _f32p,                                          # qlum, qchrom (natural [64])
        _u8p, ctypes.c_int32,                                  # pattern, blocks per mcu
        *_HUFF,
        ctypes.c_int32,                                        # restart interval (0 = off)
        _u8p, ctypes.c_int64,                                  # out buffer, capacity
    ]
    lib.jpeg_dct_zz.restype = ctypes.c_int64
    lib.jpeg_dct_zz.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,  # img, h, w, c_in
        ctypes.c_int32,                                        # mode
        _f32p,                                                 # out [nblocks, 64] f32
    ]
    lib.jpeg_trellis_quantize.restype = ctypes.c_int32
    lib.jpeg_trellis_quantize.argtypes = [
        _f32p, ctypes.c_int64,           # zigzag dct [nblocks, 64], nblocks
        _u8p, ctypes.c_int32,            # pattern, blocks per mcu
        _f32p, _f32p,                    # lum, chrom tables (zigzag [64])
        ctypes.c_float,                  # lambda
        _i16p,                           # out [nblocks, 64]
        ctypes.c_int32,                  # threads
    ]
    lib.jpeg_count_symbols.restype = ctypes.c_int32
    lib.jpeg_count_symbols.argtypes = [
        _i16p, ctypes.c_int64,           # zz coeffs, nblocks
        _u8p, ctypes.c_int32,            # pattern, blocks per mcu
        ctypes.c_int32,                  # restart interval (0 = off)
        _i64p, _i64p, _i64p, _i64p,      # dc_lum[12], dc_chrom[12], ac_lum[256], ac_chrom[256]
    ]
    lib.jpeg_encode_progressive_scan.restype = ctypes.c_int64
    lib.jpeg_encode_progressive_scan.argtypes = [
        _i16p, ctypes.c_int64,           # one component's blocks, nblocks
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ss, se, ah, al
        _u16p, _u8p, _u16p, _u8p,        # dc codes/lens, ac codes/lens
        ctypes.c_int32,                  # eobn_ok: -1 sniff lens[0x10], 0/1 explicit
        _u8p, ctypes.c_int64,            # out buffer, capacity
    ]
    lib.jpeg_count_progressive_scan.restype = ctypes.c_int32
    lib.jpeg_count_progressive_scan.argtypes = [
        _i16p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # ss, se, ah, al
        _i64p, _i64p,                    # dc counts [12], ac counts [256], added to
    ]
    lib.huffman_build_lengths.restype = ctypes.c_int32
    lib.huffman_build_lengths.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_int32, ctypes.c_int32, _u8p,  # freqs, n, max_len, out
    ]
    lib.deflate_compress.restype = ctypes.c_int64
    lib.deflate_compress.argtypes = [
        _u8p, ctypes.c_int64,            # input
        ctypes.c_int32,                  # level 1-9
        ctypes.c_int32,                  # zlib wrap (0/1)
        _u8p, ctypes.c_int64,            # out, capacity
    ]
    lib.deflate_compress_parity.restype = ctypes.c_int64
    lib.deflate_compress_parity.argtypes = [
        _u8p, ctypes.c_int64,            # input
        ctypes.c_int32,                  # level 1-9
        ctypes.c_int32,                  # zlib wrap (0/1)
        ctypes.c_int32,                  # packed semantics (0/1)
        _u8p, ctypes.c_int64,            # out, capacity
    ]
    lib.deflate_compress_optimal.restype = ctypes.c_int64
    lib.deflate_compress_optimal.argtypes = [
        _u8p, ctypes.c_int64,            # input
        ctypes.c_int32,                  # iterations
        ctypes.c_int32,                  # zlib wrap (0/1)
        _u8p, ctypes.c_int64,            # out, capacity
    ]
    lib.deflate_compress_optimal_assisted.restype = ctypes.c_int64
    lib.deflate_compress_optimal_assisted.argtypes = [
        _u8p, ctypes.c_int64,            # input
        ctypes.c_int32,                  # iterations
        ctypes.c_int32,                  # zlib wrap (0/1)
        _i32p, _i32p, ctypes.c_int32,    # cand, lens [input, k], k
        _u8p, ctypes.c_int64,            # out, capacity
    ]
    lib.deflate_optimal_parity.restype = ctypes.c_int64
    lib.deflate_optimal_parity.argtypes = [
        _u8p, ctypes.c_int64,            # input (always zlib-wrapped)
        ctypes.c_int32,                  # iterations
        _u8p, ctypes.c_int64,            # out, capacity
    ]
    lib.png_filter_apply.restype = ctypes.c_int32
    lib.png_filter_apply.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64,  # rows, height, row bytes
        ctypes.c_int32, ctypes.c_int32,        # bpp, mode
        ctypes.c_int32,                        # sticky (0/1)
        _u8p,                                  # out [height, row bytes + 1]
    ]
    lib.pixo_crc32.restype = ctypes.c_uint32
    lib.pixo_crc32.argtypes = [_u8p, ctypes.c_int64, ctypes.c_uint32]
    lib.pixo_adler32.restype = ctypes.c_uint32
    lib.pixo_adler32.argtypes = [_u8p, ctypes.c_int64, ctypes.c_uint32]
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    huff = [_u8p, _u8p, _i32p]           # bits [n x 16], values, value offsets [n]
    lib.jpeg_decode_scan.restype = i32
    lib.jpeg_decode_scan.argtypes = [
        _u8p, _i64p, i32,                # segments, offsets [nseg + 1], nseg
        i64, i64, i32,                   # restart interval, total mcus, mcu cols
        i32, _i32p, _i32p,               # ncomp, comp h, comp v
        *huff, *huff,                    # dc tables, ac tables
        _i16pp, _i32p,                   # coefficient planes, dc predictors
    ]
    lib.jpeg_prog_dc_segment.restype = i32
    lib.jpeg_prog_dc_segment.argtypes = [
        ctypes.c_void_p, i64, i64, i64,  # segment, length, unit start, unit end
        i32, i32, i32,                   # mcu cols, interleaved, ns
        _i32p, _i32p, _i32p,             # comp h, comp v, block width
        *huff,                           # dc tables
        i32, i32,                        # ah, al
        _i16pp, _i32p,                   # coefficient planes, dc predictors
    ]
    lib.jpeg_prog_ac_segment.restype = i32
    lib.jpeg_prog_ac_segment.argtypes = [
        ctypes.c_void_p, i64, i64, i64,  # segment, length, unit start, unit end
        i32, i32,                        # stride, block width
        i32, i32, i32, i32,              # ss, se, ah, al
        _u8p, _u8p,                      # ac bits [16], values
        _i16p, _i64p,                    # plane, eob run
    ]
    lib.jpeg_decode_pixels.restype = i64
    lib.jpeg_decode_pixels.argtypes = [
        _i16p, _i64p, _u16p,             # coefficients, comp offsets, zigzag tables
        _i32p, _i32p, i32,               # comp h, comp v, ncomp
        i32, i32, i32, i32,              # mcu cols, mcu rows, max h, max v
        i32, i32, i32, _u8p,             # width, height, fancy, out
    ]
    lib.jpeg_decode_baseline.restype = i32
    lib.jpeg_decode_baseline.argtypes = [
        _u8p, _i64p, i32,                # segments, offsets, nseg
        i64, i64, i32, i32,              # restart interval, total mcus, mcu cols, rows
        i32, _i32p, _i32p,               # ncomp, comp h, comp v
        i32, i32, i32, i32,              # max h, max v, width, height
        *huff, *huff,                    # dc tables, ac tables
        _u16p, i32, _u8p,                # zigzag tables, fancy, out
    ]
    lib.inflate_decompress.restype = i64
    lib.inflate_decompress.argtypes = [
        _u8p, i64,                       # input
        i32,                             # zlib wrap (0/1)
        _u8p, i64,                       # out, capacity (the exact expected size)
    ]
    lib.png_unfilter.restype = i32
    lib.png_unfilter.argtypes = [_u8p, i64, i64, i32, _u8p]  # rows, height, row bytes, bpp, out
    lib.png_palette_expand.restype = None
    lib.png_palette_expand.argtypes = [_u8p, i64, _u8p, i32, _u8p]  # samples, n, lut, channels, out
    lib.resize_lanczos3_host.restype = i32
    lib.resize_lanczos3_host.argtypes = [
        _u8p, i64, i64, i32,             # img, h, w, c
        _i32p, _f32p, i32, i32,          # x starts, x weights, taps, dst width
        _i32p, _f32p, i32, i32,          # y starts, y weights, taps, dst height
        _u8p,                            # out [dst height, dst width, c]
    ]
    lib.nearest_palette_batch.restype = i32
    lib.nearest_palette_batch.argtypes = [_u8p, i64, _u8p, i64, _u8p]  # colors, n, palette, k, out
    lib.palette_lut_build.restype = i32
    lib.palette_lut_build.argtypes = [_u8p, i64, _u8p]  # palette, k, lut [64^3]
    lib.dither_fs.restype = i32
    lib.dither_fs.argtypes = [
        _u8p, i32, i32,                  # rgba [h * w, 4], width, height
        _u8p, i32,                       # palette [k, 4], k
        _u8p, _u8p,                      # opaque lut [64^3], out indices [h * w]
    ]


def _ptr(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


def _huff_args(tables):
    """The eight code/length pointers of ``tables`` (arrays it keeps alive)."""
    arrays = (
        tables.dc_lum_codes, tables.dc_lum_lengths,
        tables.dc_chrom_codes, tables.dc_chrom_lengths,
        tables.ac_lum_codes, tables.ac_lum_lengths,
        tables.ac_chrom_codes, tables.ac_chrom_lengths,
    )
    for a, ptype in zip(arrays, _HUFF):
        want = np.uint16 if ptype is _u16p else np.uint8
        if a.dtype != want or not a.flags.c_contiguous:
            raise ValueError("Huffman code tables must be contiguous uint16/uint8 arrays")
    return [_ptr(a, p) for a, p in zip(arrays, _HUFF)]


def _scan_capacity(nblocks: int) -> int:
    # worst case ~16 bits/symbol * 64 symbols/block, plus stuffing margin
    return nblocks * 64 * 4 + 4096


def native_pack_scan(
    zz: np.ndarray, pattern: Sequence[int], tables, restart_interval: Optional[int]
) -> bytes:
    """Entropy-pack one image's dense [nblocks, 64] int16 zigzag blocks."""
    lib = load()
    zz = np.ascontiguousarray(zz, dtype=np.int16)
    pat = np.asarray(pattern, dtype=np.uint8)
    cap = _scan_capacity(zz.shape[0])
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpeg_pack_scan(
        _ptr(zz, _i16p), zz.shape[0], _ptr(pat, _u8p), len(pattern),
        *_huff_args(tables), restart_interval or 0, _ptr(out, _u8p), cap,
    )
    if n < 0:
        raise RuntimeError("native jpeg_pack_scan failed")
    return out[:n].tobytes()


def native_pack_scan_sparse(
    dc: np.ndarray,
    counts: np.ndarray,
    poss: np.ndarray,
    vals: np.ndarray,
    pattern: Sequence[int],
    tables,
    restart_interval: Optional[int],
) -> bytes:
    """Pack one scan from the flat compacted streams
    (``ops/sparse_pack.py::sparsify_blocks``): block i's ``counts[i]``
    nonzero ACs follow those of the blocks before it in ``poss``/``vals``.
    Byte-identical to ``native_pack_scan`` on the dense blocks the streams
    were compacted from."""
    lib = load()
    dc = np.ascontiguousarray(dc, dtype=np.int16)
    counts = np.ascontiguousarray(counts, dtype=np.uint8)
    poss = np.ascontiguousarray(poss, dtype=np.uint8)
    vals = np.ascontiguousarray(vals, dtype=np.int16)
    nblocks = dc.shape[0]
    if counts.shape != (nblocks,) or poss.ndim != 1 or poss.shape != vals.shape:
        raise ValueError("flat streams disagree in shape")
    if int(counts.sum(dtype=np.int64)) > len(poss):
        raise ValueError("the blocks' counts add up to more entries than the flat streams hold")
    pat = np.asarray(pattern, dtype=np.uint8)
    cap = _scan_capacity(nblocks)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpeg_pack_scan_sparse(
        _ptr(dc, _i16p), _ptr(counts, _u8p), _ptr(poss, _u8p), _ptr(vals, _i16p), nblocks,
        _ptr(pat, _u8p), len(pattern),
        *_huff_args(tables), restart_interval or 0, _ptr(out, _u8p), cap,
    )
    if n < 0:
        raise RuntimeError("native jpeg_pack_scan_sparse failed")
    return out[:n].tobytes()


def native_pack_scan_padded(
    dc: np.ndarray,
    counts: np.ndarray,
    poss: np.ndarray,
    vals: np.ndarray,
    pattern: Sequence[int],
    tables,
    restart_interval: Optional[int],
) -> bytes:
    """Pack one scan straight from the padded per-block layout: ``poss``/
    ``vals`` are [nblocks, cap] rows, block i's ``counts[i]`` live entries
    at the head of row i. Byte-identical to ``native_pack_scan`` on the
    dense blocks the streams were compacted from."""
    lib = load()
    dc = np.ascontiguousarray(dc, dtype=np.int16)
    counts = np.ascontiguousarray(counts, dtype=np.uint8)
    poss = np.ascontiguousarray(poss, dtype=np.uint8)
    vals = np.ascontiguousarray(vals, dtype=np.int16)
    nblocks = dc.shape[0]
    if counts.shape != (nblocks,) or poss.shape != vals.shape or poss.shape[0] != nblocks:
        raise ValueError("padded streams disagree in shape")
    if int(counts.max(initial=0)) > poss.shape[1]:
        raise ValueError("a block holds more nonzeros than its padded row")
    pat = np.asarray(pattern, dtype=np.uint8)
    cap = _scan_capacity(nblocks)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpeg_pack_scan_padded(
        _ptr(dc, _i16p), _ptr(counts, _u8p), _ptr(poss, _u8p), _ptr(vals, _i16p),
        nblocks, poss.shape[1], _ptr(pat, _u8p), len(pattern),
        *_huff_args(tables), restart_interval or 0, _ptr(out, _u8p), cap,
    )
    if n < 0:
        raise RuntimeError("native jpeg_pack_scan_padded failed")
    return out[:n].tobytes()


def native_pack_scan_batch(
    zz_batch: np.ndarray,
    pattern: Sequence[int],
    tables,
    restart_interval: Optional[int],
    nthreads: int,
) -> list:
    """Pack [B, nblocks, 64] coefficient streams on ``nthreads`` C++ threads."""
    lib = load()
    zz_batch = np.ascontiguousarray(zz_batch, dtype=np.int16)
    b, nblocks = zz_batch.shape[0], zz_batch.shape[1]
    pat = np.asarray(pattern, dtype=np.uint8)
    cap = _scan_capacity(nblocks)
    out = np.empty(b * cap, dtype=np.uint8)
    lens = np.zeros(b, dtype=np.int64)
    rc = lib.jpeg_pack_scan_batch(
        _ptr(zz_batch, _i16p), b, nblocks, _ptr(pat, _u8p), len(pattern),
        *_huff_args(tables), restart_interval or 0, _ptr(out, _u8p), cap,
        _ptr(lens, _i64p), max(1, nthreads),
    )
    if rc != 0:
        raise RuntimeError(f"native jpeg_pack_scan_batch failed ({rc})")
    return [out[i * cap: i * cap + int(lens[i])].tobytes() for i in range(b)]


def _image_args(img: np.ndarray, mode: str, qlum: np.ndarray, qchrom: np.ndarray):
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    c_in = 1 if img.ndim == 2 else img.shape[2]
    ql = np.ascontiguousarray(np.asarray(qlum, dtype=np.float32).reshape(64))
    qc = np.ascontiguousarray(np.asarray(qchrom, dtype=np.float32).reshape(64))
    return img, h, w, c_in, MODES[mode], ql, qc


def native_jpeg_coefficients(
    img: np.ndarray, mode: str, qlum: np.ndarray, qchrom: np.ndarray
) -> np.ndarray:
    """Host coefficient pipeline for one [h, w] or [h, w, 3] uint8 image
    (clamp-pad -> YCbCr -> blockify -> AAN DCT -> quantize -> zigzag).
    ``mode`` is "gray", "444", "420" or "422"; the tables are natural-order
    [64] f32. Returns [nblocks, 64] int16 in scan order."""
    lib = load()
    img, h, w, c_in, m, ql, qc = _image_args(img, mode, qlum, qchrom)
    nblocks = num_blocks(h, w, mode)
    out = np.empty((nblocks, 64), np.int16)
    rc = lib.jpeg_coefficients(
        _ptr(img, _u8p), h, w, c_in, m, _ptr(ql, _f32p), _ptr(qc, _f32p), _ptr(out, _i16p)
    )
    if rc != nblocks:
        raise RuntimeError(f"native jpeg_coefficients failed ({rc}; needs AVX2)")
    return out


def native_jpeg_dct_zz(img: np.ndarray, mode: str) -> np.ndarray:
    """The unquantized zigzag DCT of one [h, w] or [h, w, 3] uint8 image,
    through the same clamp-pad -> YCbCr -> blockify -> AAN chain as
    ``native_jpeg_coefficients``: the trellis front end. Returns
    [nblocks, 64] f32 in scan order."""
    lib = load()
    img, h, w, c_in, m, _, _ = _image_args(img, mode, np.ones(64), np.ones(64))
    nblocks = num_blocks(h, w, mode)
    out = np.empty((nblocks, 64), np.float32)
    rc = lib.jpeg_dct_zz(_ptr(img, _u8p), h, w, c_in, m, _ptr(out, _f32p))
    if rc != nblocks:
        raise RuntimeError(f"native jpeg_dct_zz failed ({rc}; needs AVX2)")
    return out


def native_trellis_quantize(dct_zz, pattern: Sequence[int], lum_q_zz, chrom_q_zz,
                            lambda_: float = 1.0, nthreads: Optional[int] = None) -> np.ndarray:
    """Trellis quantization of [nblocks, 64] zigzag f32 DCT blocks ->
    [nblocks, 64] int16; block i takes the chroma table where
    ``pattern[i % len(pattern)]`` is not 0. Blocks are independent, so the
    library splits them over ``nthreads`` threads (the GIL released; by
    default up to 8, and one below 2048 blocks, where threads cost more than
    they save), with the output of the serial loop."""
    lib = load()
    dct_zz = np.ascontiguousarray(dct_zz, dtype=np.float32)
    pat = np.asarray(pattern, dtype=np.uint8)
    lum = np.ascontiguousarray(lum_q_zz, dtype=np.float32)
    chrom = np.ascontiguousarray(chrom_q_zz, dtype=np.float32)
    out = np.empty((dct_zz.shape[0], 64), dtype=np.int16)
    if nthreads is None:
        nthreads = 1 if dct_zz.shape[0] < 2048 else min(8, os.cpu_count() or 1)
    rc = lib.jpeg_trellis_quantize(
        _ptr(dct_zz, _f32p), dct_zz.shape[0], _ptr(pat, _u8p), len(pat),
        _ptr(lum, _f32p), _ptr(chrom, _f32p), lambda_, _ptr(out, _i16p), int(nthreads),
    )
    if rc != 0:
        raise RuntimeError(f"native jpeg_trellis_quantize failed ({rc})")
    return out


def native_jpeg_encode_scan(
    img: np.ndarray,
    mode: str,
    qlum: np.ndarray,
    qchrom: np.ndarray,
    pattern: Sequence[int],
    tables,
    restart_interval: Optional[int],
) -> bytes:
    """Coefficients and entropy packing of one image in one host call: the
    scan payload, byte-identical to ``native_jpeg_coefficients`` followed by
    ``native_pack_scan``."""
    lib = load()
    img, h, w, c_in, m, ql, qc = _image_args(img, mode, qlum, qchrom)
    pat = np.asarray(pattern, dtype=np.uint8)
    cap = _scan_capacity(num_blocks(h, w, mode))
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpeg_encode_scan_fused(
        _ptr(img, _u8p), h, w, c_in, m, _ptr(ql, _f32p), _ptr(qc, _f32p),
        _ptr(pat, _u8p), len(pattern),
        *_huff_args(tables), restart_interval or 0, _ptr(out, _u8p), cap,
    )
    if n < 0:
        raise RuntimeError("native jpeg_encode_scan_fused failed (needs AVX2)")
    return out[:n].tobytes()


def native_has_fused_encode() -> bool:
    """True: the host library has the fused coefficient + pack call (the
    JAX package asks whether its library was built with it; the port's
    always is, and a failed load raises)."""
    return hasattr(load(), "jpeg_encode_scan_fused")


def native_count_symbols(
    zz: np.ndarray, pattern: Sequence[int], restart_interval: Optional[int]
):
    """Symbol histograms of one baseline scan: (dc_lum [12], dc_chrom [12],
    ac_lum [256], ac_chrom [256]) int64, for ``optimized_from_counts``."""
    lib = load()
    zz = np.ascontiguousarray(zz, dtype=np.int16)
    pat = np.asarray(pattern, dtype=np.uint8)
    out = [np.zeros(n, dtype=np.int64) for n in (12, 12, 256, 256)]
    rc = lib.jpeg_count_symbols(
        _ptr(zz, _i16p), zz.shape[0], _ptr(pat, _u8p), len(pattern), restart_interval or 0,
        *[_ptr(a, _i64p) for a in out],
    )
    if rc != 0:
        raise RuntimeError(f"native jpeg_count_symbols failed ({rc})")
    return tuple(out)


def native_encode_progressive_scan(
    blocks: np.ndarray, ss: int, se: int, ah: int, al: int,
    dc_codes, dc_lens, ac_codes, ac_lens, eobn_ok: Optional[bool] = None,
) -> Optional[bytes]:
    """Entropy bytes of one single-component progressive scan of ``blocks``
    ([n, 64] int16 zigzag), or None where the library declines it (the
    caller then takes the Python scan coder).

    ``eobn_ok``: True/False forces the EOBn-vs-single-EOB flush mode
    (per-scan counted tables, ``jpeg/progressive.py``); None keeps the
    single-table sniff (lens[0x10] != 0)."""
    lib = load()
    blocks = np.ascontiguousarray(blocks, dtype=np.int16)
    tables = [np.ascontiguousarray(a, dtype=t)
              for a, t in ((dc_codes, np.uint16), (dc_lens, np.uint8),
                           (ac_codes, np.uint16), (ac_lens, np.uint8))]
    cap = _scan_capacity(blocks.shape[0])
    out = np.empty(cap, dtype=np.uint8)
    n = lib.jpeg_encode_progressive_scan(
        _ptr(blocks, _i16p), blocks.shape[0], ss, se, ah, al,
        *[_ptr(a, p) for a, p in zip(tables, (_u16p, _u8p, _u16p, _u8p))],
        -1 if eobn_ok is None else int(bool(eobn_ok)), _ptr(out, _u8p), cap,
    )
    if n < 0:
        return None
    return out[:n].tobytes()


def native_count_progressive_scan(
    blocks: np.ndarray, ss: int, se: int, ah: int, al: int,
    dc_counts: np.ndarray, ac_counts: np.ndarray,
) -> bool:
    """Adds one single-component progressive scan's symbol counts to
    ``dc_counts`` [12] and ``ac_counts`` [256] (int64, in place). False
    where the library declines the scan."""
    lib = load()
    blocks = np.ascontiguousarray(blocks, dtype=np.int16)
    for a, n in ((dc_counts, 12), (ac_counts, 256)):
        if a.dtype != np.int64 or a.shape != (n,) or not a.flags.c_contiguous:
            raise ValueError(f"counts must be contiguous int64 arrays of {n}")
    rc = lib.jpeg_count_progressive_scan(
        _ptr(blocks, _i16p), blocks.shape[0], ss, se, ah, al,
        _ptr(dc_counts, _i64p), _ptr(ac_counts, _i64p),
    )
    return rc == 0


def native_build_code_lengths(freqs, max_len: int) -> Optional[np.ndarray]:
    """Length-limited optimal Huffman code lengths (counting-form
    package-merge): uint8 per symbol, tie-for-tie those of
    ``compress/huffman.py::build_code_lengths``; None where the library
    declines the arguments."""
    lib = load()
    f = np.ascontiguousarray(np.asarray(freqs, dtype=np.uint64).reshape(-1))
    out = np.zeros(len(f), np.uint8)
    rc = lib.huffman_build_lengths(
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(f), int(max_len), _ptr(out, _u8p)
    )
    return out if rc == 0 else None


def _byte_view(data) -> np.ndarray:
    """bytes or a contiguous uint8 array -> 1-D uint8 array (no copy), with
    one zero byte in place of an empty input, so the pointer is valid."""
    src = np.frombuffer(data, dtype=np.uint8)
    return src if src.size else np.zeros(1, dtype=np.uint8)


def _deflate_capacity(n_in: int) -> int:
    return n_in + (n_in >> 3) + 4096


def native_deflate(data, level: int, zlib_wrap: bool, parity: bool = False,
                   packed: bool = False) -> bytes:
    """DEFLATE ``data`` (bytes or a contiguous uint8 array) at ``level`` 1-9.

    ``parity`` selects the reference-parity decision layer; ``packed`` (read
    only in parity mode) its deflate_zlib_packed policy, the one every PNG
    encode takes: no block splitting, literal-only streams >= 8 KiB stored."""
    lib = load()
    n_in = len(np.frombuffer(data, dtype=np.uint8))
    src = _byte_view(data)
    cap = _deflate_capacity(n_in)
    out = np.empty(cap, dtype=np.uint8)
    if parity:
        n = lib.deflate_compress_parity(
            _ptr(src, _u8p), n_in, level, int(zlib_wrap), int(packed), _ptr(out, _u8p), cap
        )
    else:
        n = lib.deflate_compress(_ptr(src, _u8p), n_in, level, int(zlib_wrap), _ptr(out, _u8p), cap)
    if n < 0:
        raise RuntimeError(f"native deflate failed ({n})")
    return out[:n].tobytes()


def native_deflate_optimal(data, iterations: int, zlib_wrap: bool) -> bytes:
    """The iterative optimal parse (per-position match tables, an entropy
    cost model and a shortest-path DP, ``iterations`` rounds) of ``data``."""
    lib = load()
    n_in = len(np.frombuffer(data, dtype=np.uint8))
    src = _byte_view(data)
    cap = _deflate_capacity(n_in)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.deflate_compress_optimal(_ptr(src, _u8p), n_in, iterations, int(zlib_wrap),
                                     _ptr(out, _u8p), cap)
    if n < 0:
        raise RuntimeError(f"native deflate_compress_optimal failed ({n})")
    return out[:n].tobytes()


def native_deflate_optimal_assisted(data, iterations: int, zlib_wrap: bool, cand: np.ndarray,
                                    lens: np.ndarray) -> bytes:
    """``native_deflate_optimal`` reading the first ``k`` steps of every
    position's hash chain from ``cand`` and ``lens`` ([len(data), k] int32,
    ``ops/lz77_assist.py::chain_candidates``); the host walks the chains
    past them. The same bytes as ``native_deflate_optimal``."""
    lib = load()
    n_in = len(np.frombuffer(data, dtype=np.uint8))
    cand = np.ascontiguousarray(cand, dtype=np.int32)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    if cand.ndim != 2 or cand.shape != lens.shape or cand.shape[0] != n_in:
        raise ValueError(f"cand and lens must be [{n_in}, k] int32, got {cand.shape} and {lens.shape}")
    src = _byte_view(data)
    cap = _deflate_capacity(n_in)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.deflate_compress_optimal_assisted(_ptr(src, _u8p), n_in, iterations, int(zlib_wrap),
                                              _ptr(cand, _i32p), _ptr(lens, _i32p), cand.shape[1],
                                              _ptr(out, _u8p), cap)
    if n < 0:
        raise RuntimeError(f"native deflate_compress_optimal_assisted failed ({n})")
    return out[:n].tobytes()


def native_deflate_optimal_parity(data, iterations: int = 5) -> bytes:
    """The reference's own ``deflate_optimal_zlib(data, iterations)``, the
    DEFLATE of its PNG max preset (``png/mod.rs:571-573``): zlib-wrapped."""
    lib = load()
    n_in = len(np.frombuffer(data, dtype=np.uint8))
    src = _byte_view(data)
    cap = _deflate_capacity(n_in)
    out = np.empty(cap, dtype=np.uint8)
    n = lib.deflate_optimal_parity(_ptr(src, _u8p), n_in, iterations, _ptr(out, _u8p), cap)
    if n < 0:
        raise RuntimeError(f"native deflate_optimal_parity failed ({n})")
    return out[:n].tobytes()


def native_png_filter(rows: np.ndarray, bpp: int, mode: int, sticky: bool) -> np.ndarray:
    """Forward-filter [H, RB] uint8 rows -> [H, RB+1] rows with the filter id
    as each row's leading byte.

    ``mode``: 0-4 a fixed filter; 5 adaptive/min-sum; 6 adaptive-fast, whose
    row-0 choice holds for every row when ``sticky``; 7 bigrams."""
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    height, rb = rows.shape
    out = np.empty((height, rb + 1), dtype=np.uint8)
    rc = lib.png_filter_apply(_ptr(rows, _u8p), height, rb, bpp, mode, int(sticky), _ptr(out, _u8p))
    if rc != 0:
        raise RuntimeError(f"native png_filter_apply failed ({rc})")
    return out


def native_crc32(data: bytes, crc: int = 0) -> int:
    """CRC-32 (the zlib polynomial) of ``data``, continuing from ``crc``."""
    lib = load()
    src = _byte_view(data)
    return int(lib.pixo_crc32(_ptr(src, _u8p), len(data), crc))


def native_adler32(data: bytes, adler: int = 1) -> int:
    """Adler-32 of ``data``, continuing from ``adler``."""
    lib = load()
    src = _byte_view(data)
    return int(lib.pixo_adler32(_ptr(src, _u8p), len(data), adler))


class NativeDecodeError(Exception):
    """Malformed entropy stream detected by a native decode segment."""


def _huff_arrays(specs):
    """(bits [n x 16], values, value offsets [n]) of ``specs``, a list of
    (bits16, values) Huffman specs, as the native decoders take them. An
    empty value list takes one zero byte, so every offset is valid."""
    bits = np.concatenate([np.frombuffer(bytes(b), np.uint8) for b, _ in specs])
    vals = [np.frombuffer(bytes(v), np.uint8) if v else np.zeros(1, np.uint8) for _, v in specs]
    offs = np.zeros(len(specs), np.int32)
    np.cumsum([len(v) for v in vals[:-1]], out=offs[1:])
    return bits, np.concatenate(vals), offs


def _huff_ptrs(arrays):
    bits, vals, offs = arrays
    return [_ptr(bits, _u8p), _ptr(vals, _u8p), _ptr(offs, _i32p)]


def _segments(segments):
    """The restart segments joined, with their [nseg + 1] offsets."""
    joined = np.frombuffer(b"".join(segments), np.uint8)
    offs = np.zeros(len(segments) + 1, np.int64)
    np.cumsum([len(s) for s in segments], out=offs[1:])
    return (joined if joined.size else np.zeros(1, np.uint8)), offs


def _plane_ptr(plane: np.ndarray):
    if plane.dtype != np.int16 or not plane.flags.c_contiguous or not plane.flags.writeable:
        raise ValueError("coefficient planes must be writable contiguous int16 arrays")
    return _ptr(plane, _i16p)


def _planes_arg(planes):
    return (_i16p * len(planes))(*[_plane_ptr(p) for p in planes])


def native_jpeg_decode_scan_call(segments, restart_interval: int, total_mcus: int,
                                 mcu_cols: int, comp_h, comp_v, dc_specs, ac_specs,
                                 coeff_planes) -> Callable[[], bool]:
    """The entropy decode of every restart segment of a baseline scan into
    ``coeff_planes`` (one writable int16 [nblocks, 64] zigzag array per
    component, over its MCU-padded block grid; every block is written), with
    its arguments made ready here. The returned call runs it in one library
    call, which releases the GIL, so it may run on any thread; it returns
    False when the stream is corrupt, and the caller's Python decoder then
    names the error."""
    lib = load()
    seg, seg_off = _segments(segments)
    ch = np.asarray(comp_h, np.int32)
    cv = np.asarray(comp_v, np.int32)
    dc, ac = _huff_arrays(dc_specs), _huff_arrays(ac_specs)
    prev_dc = np.zeros(len(ch), np.int32)
    args = (
        _ptr(seg, _u8p), _ptr(seg_off, _i64p), len(segments), restart_interval, total_mcus,
        mcu_cols, len(ch), _ptr(ch, _i32p), _ptr(cv, _i32p), *_huff_ptrs(dc), *_huff_ptrs(ac),
        _planes_arg(coeff_planes), _ptr(prev_dc, _i32p),
    )  # each pointer keeps its array alive (numpy's data_as)

    def call() -> bool:
        return lib.jpeg_decode_scan(*args) == 0

    return call


def native_jpeg_prog_dc_scan(segments, ranges, mcu_cols: int, interleaved: bool, comp_h, comp_v,
                             blk_w, dc_specs, ah: int, al: int, coeff_planes) -> None:
    """Decode a whole progressive DC scan in place: restart segment i over
    the units ``ranges[i]`` = [start, end) (empty ranges are skipped), the
    DC predictors reset at each. ``dc_specs`` per scan component, or None
    for a refinement pass. The arguments are made once for the scan, so a
    scan of many short segments pays one library call per segment and
    little else. Raises ``NativeDecodeError`` on a malformed segment."""
    lib = load()
    ns = len(comp_h)
    seg, seg_off = _segments(segments)
    base, offs = seg.ctypes.data, seg_off.tolist()
    ch = np.asarray(comp_h, np.int32)
    cv = np.asarray(comp_v, np.int32)
    bw = np.asarray(blk_w, np.int32)
    dc = (_huff_arrays(dc_specs) if dc_specs is not None
          else (np.zeros(16 * ns, np.uint8), np.zeros(1, np.uint8), np.zeros(ns, np.int32)))
    prev_dc = np.zeros(ns, np.int32)
    fixed = (mcu_cols, int(interleaved), ns, _ptr(ch, _i32p), _ptr(cv, _i32p), _ptr(bw, _i32p),
             *_huff_ptrs(dc), ah, al, _planes_arg(coeff_planes), _ptr(prev_dc, _i32p))
    for i, (u0, u1) in enumerate(ranges):
        if u0 >= u1:
            continue
        prev_dc[:] = 0
        if lib.jpeg_prog_dc_segment(base + offs[i], offs[i + 1] - offs[i], u0, u1, *fixed):
            raise NativeDecodeError("progressive DC segment")


def native_jpeg_prog_ac_scan(segments, ranges, stride: int, blk_w: int, ss: int, se: int,
                             ah: int, al: int, ac_spec, plane: np.ndarray) -> None:
    """Decode a whole progressive AC scan into ``plane`` in place, segment
    by segment as ``native_jpeg_prog_dc_scan`` does; the EOB run resets at
    each segment and carries across units within one. Raises
    ``NativeDecodeError`` on a malformed segment."""
    lib = load()
    seg, seg_off = _segments(segments)
    base, offs = seg.ctypes.data, seg_off.tolist()
    bits, vals, _ = _huff_arrays([ac_spec])
    eobrun = np.zeros(1, np.int64)
    fixed = (stride, blk_w, ss, se, ah, al, _ptr(bits, _u8p), _ptr(vals, _u8p),
             _plane_ptr(plane), _ptr(eobrun, _i64p))
    for i, (u0, u1) in enumerate(ranges):
        if u0 >= u1:
            continue
        eobrun[0] = 0
        if lib.jpeg_prog_ac_segment(base + offs[i], offs[i + 1] - offs[i], u0, u1, *fixed):
            raise NativeDecodeError("progressive AC segment")


def _pixels_out(ncomp: int, width: int, height: int) -> np.ndarray:
    return np.empty((height, width, 3) if ncomp == 3 else (height, width), np.uint8)


def native_jpeg_decode_pixels_call(comp_coeffs, qtables_zz, comp_h, comp_v, mcu_cols: int,
                                   mcu_rows: int, max_h: int, max_v: int, width: int, height: int,
                                   fancy: bool = False) -> Callable[[], Optional[np.ndarray]]:
    """The host pixel tail (dequantize, un-zigzag, jidctint, assemble,
    upsample and colour-convert), with its arguments made ready here.
    ``comp_coeffs``: one int16 [nblocks, 64] zigzag array per component;
    ``qtables_zz``: one [64] zigzag table each. The returned call runs it in
    one library call, which releases the GIL, so it may run on any thread;
    it returns [H, W, 3] (or [H, W] gray) uint8, or None where the host tier
    declines the geometry."""
    lib = load()
    coeffs = np.ascontiguousarray(np.concatenate([np.asarray(c, np.int16) for c in comp_coeffs]))
    offs = np.zeros(len(comp_coeffs) + 1, np.int64)
    np.cumsum([len(c) for c in comp_coeffs], out=offs[1:])
    qt = np.ascontiguousarray(np.stack([np.asarray(q, np.uint16) for q in qtables_zz]))
    ch = np.asarray(comp_h, np.int32)
    cv = np.asarray(comp_v, np.int32)
    out = _pixels_out(len(comp_coeffs), width, height)
    args = (
        _ptr(coeffs, _i16p), _ptr(offs, _i64p), _ptr(qt, _u16p), _ptr(ch, _i32p),
        _ptr(cv, _i32p), len(ch), mcu_cols, mcu_rows, max_h, max_v, width, height,
        int(fancy), _ptr(out, _u8p),
    )  # each pointer keeps its array alive (numpy's data_as)

    def call() -> Optional[np.ndarray]:
        return out if lib.jpeg_decode_pixels(*args) == 0 else None

    return call


def native_jpeg_decode_baseline_call(segments, restart_interval: int, total_mcus: int, mcu_cols: int,
                                     mcu_rows: int, comp_h, comp_v, max_h: int, max_v: int,
                                     width: int, height: int, dc_specs, ac_specs, qtables_zz,
                                     fancy: bool = False) -> Callable[[], Optional[np.ndarray]]:
    """The fused host baseline decode (entropy, IDCT, upsample and colour in
    one library call), with its arguments made ready here. The returned
    call releases the GIL, so it may run on any thread; it returns the
    pixels as ``native_jpeg_decode_pixels_call``'s does, or None for a
    corrupt stream or a geometry it declines."""
    lib = load()
    seg, seg_off = _segments(segments)
    ch = np.asarray(comp_h, np.int32)
    cv = np.asarray(comp_v, np.int32)
    dc, ac = _huff_arrays(dc_specs), _huff_arrays(ac_specs)
    qt = np.ascontiguousarray(np.stack([np.asarray(q, np.uint16) for q in qtables_zz]))
    out = _pixels_out(len(ch), width, height)
    args = (
        _ptr(seg, _u8p), _ptr(seg_off, _i64p), len(segments), restart_interval, total_mcus,
        mcu_cols, mcu_rows, len(ch), _ptr(ch, _i32p), _ptr(cv, _i32p), max_h, max_v,
        width, height, *_huff_ptrs(dc), *_huff_ptrs(ac), _ptr(qt, _u16p), int(fancy),
        _ptr(out, _u8p),
    )  # each pointer keeps its array alive (numpy's data_as)

    def call() -> Optional[np.ndarray]:
        return out if lib.jpeg_decode_baseline(*args) == 0 else None

    return call


class NativeInflateError(Exception):
    """The native INFLATE rejected its input: a malformed stream, output
    beyond the expected size, or a stream form it does not take."""


def native_inflate(data: bytes, expected_size: int, zlib_wrap: bool) -> bytes:
    """INFLATE ``data`` (zlib-wrapped or raw) into at most ``expected_size``
    bytes. Raises ``NativeInflateError`` where the library rejects the
    stream; ``compress/deflate.py`` then lets Python's zlib name the error,
    as the JAX package does."""
    lib = load()
    src = _byte_view(data)
    out = np.empty(max(expected_size, 1), dtype=np.uint8)
    n = lib.inflate_decompress(_ptr(src, _u8p), len(data), int(zlib_wrap), _ptr(out, _u8p),
                               expected_size)
    if n < 0:
        raise NativeInflateError(f"native inflate rejected the stream ({n})")
    return out[:n].tobytes()


def native_png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """[H, RB+1] uint8 filtered rows, each led by its filter id (0-4) ->
    [H, RB] reconstructed rows."""
    lib = load()
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    height, rb1 = rows.shape
    out = np.empty((height, rb1 - 1), dtype=np.uint8)
    rc = lib.png_unfilter(_ptr(rows, _u8p), height, rb1 - 1, bpp, _ptr(out, _u8p))
    if rc != 0:
        raise RuntimeError(f"native png_unfilter failed ({rc})")
    return out


def native_palette_expand(samples: np.ndarray, lut_rgba: np.ndarray, channels: int) -> np.ndarray:
    """Gather a padded [256, 4] uint8 RGBA table over uint8 ``samples`` ->
    ``samples.shape + (channels,)``; with 3 channels, each entry's RGB."""
    lib = load()
    samples = np.ascontiguousarray(samples, dtype=np.uint8)
    lut = np.ascontiguousarray(lut_rgba, dtype=np.uint8)
    if lut.shape != (256, 4) or channels not in (3, 4):
        raise ValueError("the palette table must be [256, 4] and channels 3 or 4")
    out = np.empty(samples.size * channels, dtype=np.uint8)
    lib.png_palette_expand(_ptr(samples, _u8p), samples.size, _ptr(lut, _u8p), channels,
                           _ptr(out, _u8p))
    return out.reshape(samples.shape + (channels,))


def native_resize_lanczos3(arr: np.ndarray, sx: np.ndarray, wx: np.ndarray, sy: np.ndarray,
                           wy: np.ndarray) -> np.ndarray:
    """Separable Lanczos3 of one [h, w, c] uint8 image (c 1 to 4) with the
    taps of ``ops/resize_kernels.py::lanczos_taps`` for each axis: the
    horizontal pass, then the vertical one, each output a serial f32
    accumulation over its taps, the intermediate rounded and clamped to
    uint8. Bit-identical to ``resize_lanczos3_np``."""
    lib = load()
    h, w, c = arr.shape
    dst_w, kx = wx.shape
    dst_h, ky = wy.shape
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    sxc = np.ascontiguousarray(sx, dtype=np.int32)
    syc = np.ascontiguousarray(sy, dtype=np.int32)
    wxc = np.ascontiguousarray(wx, dtype=np.float32)
    wyc = np.ascontiguousarray(wy, dtype=np.float32)
    out = np.empty((dst_h, dst_w, c), np.uint8)
    rc = lib.resize_lanczos3_host(
        _ptr(arr, _u8p), h, w, c, _ptr(sxc, _i32p), _ptr(wxc, _f32p), kx, dst_w,
        _ptr(syc, _i32p), _ptr(wyc, _f32p), ky, dst_h, _ptr(out, _u8p),
    )
    if rc != 0:
        raise RuntimeError(f"native resize_lanczos3_host failed ({rc}; needs AVX2 and 1 to 4 channels)")
    return out


def _palette(palette) -> np.ndarray:
    palette = np.ascontiguousarray(palette, dtype=np.uint8)
    if palette.ndim != 2 or palette.shape[1] != 4 or not 1 <= len(palette) <= 256:
        raise ValueError(f"the palette must be [k, 4] uint8 with k 1 to 256, got {palette.shape}")
    return palette


def native_nearest_palette(colors, palette) -> np.ndarray:
    """[n, 4] x [k, 4] uint8 -> [n] uint8: each colour's nearest palette
    entry by the redmean distance, the first on ties."""
    lib = load()
    colors = np.ascontiguousarray(colors, dtype=np.uint8).reshape(-1, 4)
    palette = _palette(palette)
    out = np.empty(max(len(colors), 1), np.uint8)
    src = colors if len(colors) else np.zeros((1, 4), np.uint8)
    rc = lib.nearest_palette_batch(_ptr(src, _u8p), len(colors), _ptr(palette, _u8p),
                                   len(palette), _ptr(out, _u8p))
    if rc != 0:
        raise RuntimeError(f"native nearest_palette_batch failed ({rc})")
    return out[:len(colors)]


def native_palette_lut(palette) -> np.ndarray:
    """[k, 4] uint8 -> [64^3] uint8: the 6-6-6 opaque LUT, each grid colour's
    nearest palette entry."""
    lib = load()
    palette = _palette(palette)
    out = np.empty(64 * 64 * 64, np.uint8)
    rc = lib.palette_lut_build(_ptr(palette, _u8p), len(palette), _ptr(out, _u8p))
    if rc != 0:
        raise RuntimeError(f"native palette_lut_build failed ({rc})")
    return out


def native_dither_fs(rgba, width: int, height: int, palette, opaque_lut) -> np.ndarray:
    """Floyd-Steinberg dithering of [height * width, 4] uint8 pixels to
    [height * width] uint8 palette indices, the sequential host scan."""
    lib = load()
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    palette = _palette(palette)
    opaque_lut = np.ascontiguousarray(opaque_lut, dtype=np.uint8)
    if rgba.size != 4 * width * height or opaque_lut.size != 64 * 64 * 64:
        raise ValueError("dither_fs needs width * height RGBA pixels and a [64^3] LUT")
    out = np.empty(width * height, dtype=np.uint8)
    rc = lib.dither_fs(_ptr(rgba, _u8p), width, height, _ptr(palette, _u8p), len(palette),
                       _ptr(opaque_lut, _u8p), _ptr(out, _u8p))
    if rc != 0:
        raise RuntimeError(f"native dither_fs failed ({rc})")
    return out
