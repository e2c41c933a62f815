"""Encoder/resize option types.

API parity with pixo's option structs and numeric presets:
  - ``PngOptions`` / ``FilterStrategy`` / ``QuantizationOptions``
    (pixo ``src/png/mod.rs:41-364``)
  - ``JpegOptions`` / ``Subsampling`` (pixo ``src/jpeg/mod.rs:96-300``)
  - ``ResizeOptions`` / ``ResizeFilter`` (pixo ``src/resize.rs:34-191``)

Python idiom replaces the Rust builder pattern with dataclasses + keyword
arguments; ``from_preset`` constructors keep the 0=fast / 1=balanced / 2=max
numeric preset contract shared by the CLI and bindings.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from .color import ColorType

MAX_DIMENSION = 65535  # JPEG SOF u16 limit; PNG shares the cap in pixo.


class FilterStrategy(enum.Enum):
    NONE = "none"
    SUB = "sub"
    UP = "up"
    AVERAGE = "average"
    PAETH = "paeth"
    MIN_SUM = "minsum"
    ADAPTIVE = "adaptive"
    ADAPTIVE_FAST = "adaptive_fast"
    BIGRAMS = "bigrams"


class QuantizationMode(enum.Enum):
    OFF = "off"
    AUTO = "auto"
    FORCE = "force"


@dataclasses.dataclass
class QuantizationOptions:
    mode: QuantizationMode = QuantizationMode.OFF
    max_colors: int = 256
    dithering: bool = False


@dataclasses.dataclass
class PngOptions:
    width: int = 0
    height: int = 0
    color_type: ColorType = ColorType.RGBA
    compression_level: int = 2
    filter_strategy: FilterStrategy = FilterStrategy.ADAPTIVE_FAST
    optimize_alpha: bool = False
    reduce_color_type: bool = False
    strip_metadata: bool = False
    reduce_palette: bool = False
    verbose_filter_log: bool = False
    optimal_compression: bool = False
    # Adam7 interlaced output (beyond parity: the reference encoder has no
    # interlace support and its decoder rejects interlaced files; ours
    # round-trips them).
    interlace: bool = False
    # Sample bit depth: 8 (default) or 16 (beyond parity: the reference
    # encoder is 8-bit only). 16-bit input is big-endian bytes or a
    # uint16 array; quantization/reductions do not apply at 16-bit.
    bit_depth: int = 8
    quantization: QuantizationOptions = dataclasses.field(
        default_factory=QuantizationOptions
    )

    @classmethod
    def fast(cls, width: int, height: int) -> "PngOptions":
        return cls(width=width, height=height)

    @classmethod
    def balanced(cls, width: int, height: int) -> "PngOptions":
        return cls(
            width=width,
            height=height,
            compression_level=6,
            filter_strategy=FilterStrategy.ADAPTIVE,
            optimize_alpha=True,
            reduce_color_type=True,
            strip_metadata=True,
            reduce_palette=True,
        )

    @classmethod
    def max(cls, width: int, height: int) -> "PngOptions":
        return cls(
            width=width,
            height=height,
            compression_level=9,
            filter_strategy=FilterStrategy.BIGRAMS,
            optimize_alpha=True,
            reduce_color_type=True,
            strip_metadata=True,
            reduce_palette=True,
            optimal_compression=True,
        )

    @classmethod
    def from_preset(cls, width: int, height: int, preset: int) -> "PngOptions":
        if preset == 0:
            return cls.fast(width, height)
        if preset == 2:
            return cls.max(width, height)
        return cls.balanced(width, height)

    @classmethod
    def from_preset_with_lossless(
        cls, width: int, height: int, preset: int, lossless: bool
    ) -> "PngOptions":
        opts = cls.from_preset(width, height, preset)
        if not lossless:
            opts.quantization = QuantizationOptions(
                mode=QuantizationMode.AUTO, max_colors=256, dithering=True
            )
        return opts

    def replace(self, **kwargs) -> "PngOptions":
        return dataclasses.replace(self, **kwargs)


class Subsampling(enum.Enum):
    S444 = "444"
    S420 = "420"
    # Beyond parity: the reference decodes 4:2:2 but cannot encode it
    # (``src/jpeg/mod.rs:96-300`` offers S444/S420 only); this framework
    # completes the matrix with a 16x8-MCU encode path.
    S422 = "422"


@dataclasses.dataclass
class JpegOptions:
    width: int = 0
    height: int = 0
    color_type: ColorType = ColorType.RGB
    quality: int = 75
    subsampling: Subsampling = Subsampling.S444
    restart_interval: Optional[int] = None
    optimize_huffman: bool = False
    progressive: bool = False
    trellis_quant: bool = False
    # Beyond parity: build the two-pass tables with length-limited
    # package-merge + the libjpeg dummy-symbol trick instead of the
    # reference's depth+1 scheme (never larger; implies the counting pass).
    optimal_huffman: bool = False
    # Progressive scan script: successive approximation (the reference's
    # fuller script, src/jpeg/progressive.rs:68-96 — which its encoder
    # never uses) with per-scan optimized Huffman tables. This is what
    # makes libjpeg/mozjpeg progressive output small; on by default for
    # the shipping progressive path. False selects the reference's used
    # 7-scan spectral-selection-only script (parity mode).
    progressive_sa: bool = True

    @classmethod
    def fast(cls, width: int, height: int, quality: int = 75) -> "JpegOptions":
        return cls(width=width, height=height, quality=quality)

    @classmethod
    def balanced(cls, width: int, height: int, quality: int = 75) -> "JpegOptions":
        return cls(width=width, height=height, quality=quality, optimize_huffman=True)

    @classmethod
    def max(cls, width: int, height: int, quality: int = 75) -> "JpegOptions":
        return cls(
            width=width,
            height=height,
            quality=quality,
            subsampling=Subsampling.S420,
            optimize_huffman=True,
            progressive=True,
            trellis_quant=True,
        )

    @classmethod
    def from_preset(
        cls, width: int, height: int, quality: int, preset: int
    ) -> "JpegOptions":
        if preset == 0:
            return cls.fast(width, height, quality)
        if preset == 2:
            return cls.max(width, height, quality)
        return cls.balanced(width, height, quality)

    def replace(self, **kwargs) -> "JpegOptions":
        return dataclasses.replace(self, **kwargs)


class ResizeFilter(enum.Enum):
    NEAREST = "nearest"
    BILINEAR = "bilinear"
    LANCZOS3 = "lanczos3"


@dataclasses.dataclass
class ResizeOptions:
    src_width: int = 0
    src_height: int = 0
    dst_width: int = 0
    dst_height: int = 0
    color_type: ColorType = ColorType.RGBA
    filter: ResizeFilter = ResizeFilter.LANCZOS3

    def replace(self, **kwargs) -> "ResizeOptions":
        return dataclasses.replace(self, **kwargs)
