"""PNG decoder: numpy on the host, with the shared C++ tier's INFLATE, row
reconstruction and palette gather.

Counterpart of the JAX package's ``decode/png_decoder.py``, whose decode is
host work too; pixels, fields and errors equal its. Behavioral parity with
pixo ``src/decode/png.rs``:
  - chunk parse with CRC verification, IHDR validation,
  - decompression-bomb guard via exact expected-size inflate
    (``calculate_expected_size``, ``src/decode/png.rs:78-98``),
  - per-row unfilter (all five filters),
  - bit-depth expansion 1/2/4/16 -> 8,
  - indexed -> RGB(A) via PLTE/tRNS,
  - Adam7 interlacing decoded (beyond parity: pixo rejects it).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from typing import Optional

import numpy as np

from .. import errors
from ..color import ColorType
from ..compress.deflate import inflate_zlib
from ..native import native_palette_expand, native_png_unfilter
from ..png.chunks import PNG_SIGNATURE

MAX_DECODE_DIMENSION = 65535
# Decompression-bomb guard (reference: src/decode/png.rs:15)
MAX_DECODED_SIZE = 1 << 31

# Adam7 pass geometry: (x0, y0, dx, dy)
ADAM7_PASSES = (
    (0, 0, 8, 8),
    (4, 0, 8, 8),
    (0, 4, 4, 8),
    (2, 0, 4, 4),
    (0, 2, 2, 4),
    (1, 0, 2, 2),
    (0, 1, 1, 2),
)

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_VALID_DEPTHS = {
    0: (1, 2, 4, 8, 16),
    2: (8, 16),
    3: (1, 2, 4, 8),
    4: (8, 16),
    6: (8, 16),
}


@dataclasses.dataclass
class PngImage:
    width: int
    height: int
    color_type: ColorType
    pixels: np.ndarray  # [H, W, C] uint8 (C per color_type)

    @property
    def data(self) -> bytes:
        return self.pixels.tobytes()


def _expected_size(width: int, height: int, bit_depth: int, channels: int) -> int:
    bits_per_row = width * channels * bit_depth
    row_bytes = (bits_per_row + 7) // 8
    return (row_bytes + 1) * height


def decode_png(data: bytes, *, keep_bit_depth: bool = False) -> PngImage:
    """Decode a PNG. ``keep_bit_depth=True`` returns uint16 pixels for
    16-bit files instead of the default high-byte truncation (beyond
    parity: the reference always truncates 16->8)."""
    if len(data) < 8 or data[:8] != PNG_SIGNATURE:
        raise errors.InvalidDecode("not a PNG file (bad signature)")
    pos = 8
    ihdr = None
    idat = bytearray()
    plte: Optional[np.ndarray] = None
    trns: Optional[np.ndarray] = None
    seen_iend = False

    while pos + 8 <= len(data):
        length = struct.unpack(">I", data[pos : pos + 4])[0]
        ctype = data[pos + 4 : pos + 8]
        if pos + 12 + length > len(data):
            raise errors.InvalidDecode("truncated chunk")
        cdata = data[pos + 8 : pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])[0]
        if crc != (zlib.crc32(ctype + cdata) & 0xFFFFFFFF):
            raise errors.InvalidDecode(f"CRC mismatch in {ctype!r} chunk")
        pos += 12 + length

        if ctype == b"IHDR":
            # a 13-byte check, not just CRC: a truncated-but-CRC-consistent
            # IHDR (rewritten length + matching CRC) must fail as invalid
            # PNG, not as a struct.error leak (fuzz finding)
            if length != 13:
                raise errors.InvalidDecode("invalid IHDR length")
            ihdr = struct.unpack(">IIBBBBB", cdata)
        elif ctype == b"PLTE":
            if length % 3 != 0 or length == 0 or length > 768:
                raise errors.InvalidDecode("invalid PLTE length")
            plte = np.frombuffer(cdata, np.uint8).reshape(-1, 3)
        elif ctype == b"tRNS":
            trns = np.frombuffer(cdata, np.uint8)
        elif ctype == b"IDAT":
            idat += cdata
        elif ctype == b"IEND":
            seen_iend = True
            break

    if ihdr is None:
        raise errors.InvalidDecode("missing IHDR")
    if not seen_iend:
        raise errors.InvalidDecode("missing IEND")
    width, height, bit_depth, color_type, comp, filt, interlace = ihdr
    if width == 0 or height == 0:
        raise errors.InvalidDecode("zero dimensions")
    if width > MAX_DECODE_DIMENSION or height > MAX_DECODE_DIMENSION:
        raise errors.InvalidDecode("dimensions too large")
    if comp != 0 or filt != 0:
        raise errors.InvalidDecode("unknown compression/filter method")
    if interlace not in (0, 1):
        raise errors.InvalidDecode("invalid interlace method")
    if color_type not in _CHANNELS:
        raise errors.InvalidDecode(f"invalid color type {color_type}")
    if bit_depth not in _VALID_DEPTHS[color_type]:
        raise errors.InvalidDecode(
            f"invalid bit depth {bit_depth} for color type {color_type}"
        )
    if color_type == 3 and plte is None:
        raise errors.InvalidDecode("indexed PNG missing PLTE")
    if not idat:
        raise errors.InvalidDecode("missing IDAT")

    channels = _CHANNELS[color_type]
    if interlace == 1:
        expected = sum(
            _expected_size(pw, ph, bit_depth, channels)
            for pw, ph in _adam7_dims(width, height)
            if pw and ph
        )
    else:
        expected = _expected_size(width, height, bit_depth, channels)
    if expected > MAX_DECODED_SIZE:
        raise errors.InvalidDecode("decoded size exceeds safety cap")
    try:
        raw = inflate_zlib(bytes(idat), expected)
    except errors.InvalidDecode as exc:  # a failed build of the library is not a bad file
        raise errors.InvalidDecode(f"inflate failed: {exc}") from None
    if len(raw) != expected:
        raise errors.InvalidDecode(
            f"decompressed size {len(raw)} != expected {expected}"
        )

    bpp_bytes = max((channels * bit_depth) // 8, 1)
    keep16 = keep_bit_depth and bit_depth == 16
    if interlace == 1:
        samples = _decode_adam7(
            raw, width, height, bit_depth, channels, color_type, bpp_bytes,
            keep16=keep16,
        )
    else:
        bits_per_row = width * channels * bit_depth
        row_bytes = (bits_per_row + 7) // 8
        recon = unfilter(raw, height, row_bytes, bpp_bytes)
        # Expand bit depth to 8-bit samples (or keep 16-bit on request)
        samples = _expand_samples(
            recon, width, height, bit_depth, channels, color_type,
            keep16=keep16,
        )

    if color_type == 3:
        assert plte is not None
        # reference parity (src/decode/png.rs:492-530): out-of-range
        # indices expand to opaque black, and tRNS upgrades the output to
        # RGBA only when it contains a non-opaque entry
        # (has_alpha_in_trns, src/decode/png.rs:70-73).
        # The LUT is padded to 256 entries so uint8 samples can never
        # index past it — out-of-range indices land on the opaque-black
        # padding, replacing the oob mask-and-patch with a pure gather
        # (NumPy's 2D fancy-indexing here cost 3 ms of a 3.3 ms decode).
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        lut[: len(plte), :3] = plte
        has_alpha = trns is not None and bool((np.asarray(trns) != 0xFF).any())
        if has_alpha:
            lut[: min(len(trns), len(plte)), 3] = trns[: len(plte)]
        channels_out = 4 if has_alpha else 3
        pixels = native_palette_expand(samples, lut, channels_out)
        ct_out = ColorType.RGBA if has_alpha else ColorType.RGB
        return PngImage(width, height, ct_out, pixels)

    ct = {0: ColorType.GRAY, 2: ColorType.RGB, 4: ColorType.GRAY_ALPHA,
          6: ColorType.RGBA}[color_type]
    pixels = samples.reshape(height, width, channels)
    if channels == 1:
        pixels = pixels[..., 0]
    return PngImage(width, height, ct, pixels)


def _adam7_dims(width: int, height: int):
    """Per-pass (pass_width, pass_height) for Adam7."""
    return [
        ((width - x0 + dx - 1) // dx if width > x0 else 0,
         (height - y0 + dy - 1) // dy if height > y0 else 0)
        for (x0, y0, dx, dy) in ADAM7_PASSES
    ]


def _decode_adam7(
    raw: bytes, width: int, height: int, bit_depth: int,
    channels: int, color_type: int, bpp_bytes: int, keep16: bool = False,
) -> np.ndarray:
    """Adam7 de-interlacing: 7 independently filtered sub-images scattered
    onto the output grid. (Beyond-parity: the reference rejects interlaced
    files; we decode them.)"""
    out = np.zeros((height, width * channels),
                   np.uint16 if keep16 else np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (pw, ph) in zip(ADAM7_PASSES, _adam7_dims(width, height)):
        if pw == 0 or ph == 0:
            continue
        row_bytes = (pw * channels * bit_depth + 7) // 8
        nbytes = (row_bytes + 1) * ph
        sub = unfilter(raw[pos : pos + nbytes], ph, row_bytes, bpp_bytes)
        pos += nbytes
        sub_samples = _expand_samples(
            sub, pw, ph, bit_depth, channels, color_type, keep16=keep16)
        sub_px = sub_samples.reshape(ph, pw, channels)
        ys = y0 + dy * np.arange(ph)
        xs = x0 + dx * np.arange(pw)
        grid = out.reshape(height, width, channels)
        grid[np.ix_(ys, xs)] = sub_px
    return out


def _expand_samples(
    recon: np.ndarray, width: int, height: int, bit_depth: int,
    channels: int, color_type: int, keep16: bool = False,
) -> np.ndarray:
    """Unfiltered rows -> per-pixel 8-bit samples.

    1/2/4-bit expand via bit unpacking (gray scaled to full range, palette
    indices kept raw); 16-bit truncates to the high byte (parity with the
    reference's 16->8 handling).
    """
    if bit_depth == 8:
        return recon  # row_bytes == width * channels
    if bit_depth == 16:
        r = recon.reshape(height, width * channels, 2)
        if keep16:
            return (
                (r[..., 0].astype(np.uint16) << 8) | r[..., 1]
            ).reshape(height, -1)
        return r[..., 0].reshape(height, -1)
    # sub-byte depths: gray (ct 0) or indexed (ct 3); one channel
    per_byte = 8 // bit_depth
    rows = recon
    bits = np.unpackbits(rows, axis=1)
    grouped = bits.reshape(height, -1, bit_depth)
    vals = np.zeros((height, grouped.shape[1]), np.uint8)
    for b in range(bit_depth):
        vals = (vals << 1) | grouped[:, :, b]
    vals = vals[:, :width]
    if color_type == 0:
        scale = {1: 255, 2: 85, 4: 17}[bit_depth]
        vals = (vals.astype(np.uint16) * scale).astype(np.uint8)
    return vals


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Reverse per-row PNG filtering -> [height, row_bytes] uint8, in the
    shared C++ tier; ``_unfilter_py`` is its plain reference."""
    arr = np.frombuffer(raw, np.uint8).reshape(height, row_bytes + 1)
    filter_ids = arr[:, 0]
    if (filter_ids > 4).any():
        raise errors.InvalidDecode("invalid filter type")
    return native_png_unfilter(arr, bpp)


def _unfilter_py(arr: np.ndarray, bpp: int) -> np.ndarray:
    """The plain reference of ``unfilter``'s library call, in Python: Sub as
    a per-lane modular running sum, Average and Paeth byte by byte."""
    height, rb1 = arr.shape
    row_bytes = rb1 - 1
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for y in range(height):
        ftype = arr[y, 0]
        row = arr[y, 1:].astype(np.int32)
        if ftype == 0:
            recon = row
        elif ftype == 2:  # Up
            recon = (row + prev) & 0xFF
        elif ftype == 1:  # Sub: per-lane modular cumsum
            recon = row.copy()
            for i in range(bpp, row_bytes):
                recon[i] = (recon[i] + recon[i - bpp]) & 0xFF
        elif ftype == 3:  # Average
            recon = row.copy()
            for i in range(row_bytes):
                left = recon[i - bpp] if i >= bpp else 0
                recon[i] = (recon[i] + ((left + prev[i]) >> 1)) & 0xFF
        else:  # Paeth
            recon = row.copy()
            for i in range(row_bytes):
                a = recon[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                recon[i] = (recon[i] + pred) & 0xFF
        out[y] = recon.astype(np.uint8)
        prev = recon
    return out


def strip_metadata_chunks(data: bytes) -> bytes:
    """Remove tEXt/zTXt/iTXt/tIME chunks (parity: ``strip_metadata_chunks``,
    ``src/png/mod.rs:1906-1943``). Used by recompression paths."""
    if len(data) < 8 or data[:8] != PNG_SIGNATURE:
        return data
    out = bytearray(data[:8])
    pos = 8
    drop = {b"tEXt", b"zTXt", b"iTXt", b"tIME"}
    while pos + 8 <= len(data):
        length = struct.unpack(">I", data[pos : pos + 4])[0]
        ctype = data[pos + 4 : pos + 8]
        end = pos + 12 + length
        if end > len(data):
            break
        if ctype not in drop:
            out += data[pos:end]
        pos = end
    return bytes(out)
