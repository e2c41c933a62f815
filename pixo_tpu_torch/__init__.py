"""pixo_tpu_torch: the PyTorch and CUDA port of the JAX package.

The port runs on one NVIDIA H100 (Hopper, sm_90a). The per-block pixel math
is written by hand in CUDA (``csrc/``), with a plain PyTorch version of every
kernel beside it, which is what runs for tensors on the CPU. The bit-serial
entropy packing runs in the same C++ host tier as the JAX package, compiled
from its source. The JAX package stays the reference: for the
same input and options the port emits the same bytes.

Ported so far are the JPEG encode, single-image and batched, baseline and
progressive with the standard, optimized or optimal Huffman tables, and
the trellis quantizer of the ``max`` preset, the PNG encode, single-image
and batched, lossless (every preset, the ``max`` one's Bigrams filter and
optimal DEFLATE among them, Adam7 interlace, 16-bit) and lossy (palette
quantization with Floyd-Steinberg dithering), the batched baseline and progressive
JPEG decode, the PNG decode, the resize (nearest, bilinear, Lanczos3) and the
thumbnail pipeline (decode -> Lanczos3 -> JPEG re-encode, the pixels staying
on the device from the decode to the compacted streams), the JPEG streams
(``parallel.encode_jpeg_stream`` and its overlapped form, on CUDA streams
with pinned copies; ``parallel.make_mesh`` for several cards), the
compression service (``parallel.CompressService``), the command line
(``python -m pixo_tpu_torch``, ``cli.main``), the flat bindings
(``bindings``) and the playground's job (``playground.compress_bytes``):

    from pixo_tpu_torch import JpegOptions, Subsampling, encode_jpeg_batch_sharded

    opts = JpegOptions(width=512, height=512, quality=85, subsampling=Subsampling.S420)
    files = encode_jpeg_batch_sharded(batch_u8, opts, device="cuda")

    from pixo_tpu_torch import jpeg

    balanced = JpegOptions.from_preset(512, 512, 85, 1)   # optimized Huffman tables
    one = jpeg.encode(image_u8, balanced)                  # on the card, a batch of one
    files = jpeg.encode_batch(batch_u8, balanced.replace(progressive=True))
    same = jpeg.encode(image_u8, balanced, device="cpu")   # the host library's tier

    from pixo_tpu_torch import ColorType, PngOptions, encode_png_batch_sharded, png

    opts = PngOptions.balanced(512, 512).replace(color_type=ColorType.RGB)
    files = encode_png_batch_sharded(batch_u8, opts, device="cuda")
    files = png.encode_batch(batch_u8, PngOptions.max(512, 512))  # Bigrams on the card

    from pixo_tpu_torch import encode_png_row_sharded

    one = encode_png_row_sharded(image_u8, opts)           # == png.encode(image_u8, opts)

    from pixo_tpu_torch import QuantizationMode, QuantizationOptions

    lossy = opts.replace(quantization=QuantizationOptions(
        mode=QuantizationMode.FORCE, max_colors=256, dithering=True))
    files = encode_png_batch_sharded(batch_u8, lossy, device="cuda")  # indexed PNGs

    from pixo_tpu_torch import decode_jpeg_batch

    images = decode_jpeg_batch(jpeg_files, device="cuda")  # [H, W, 3] uint8 .pixels

    from pixo_tpu_torch import decode_png_batch, thumbnail_pipeline

    images = decode_png_batch(png_files)                   # on the host
    thumbs = thumbnail_pipeline(files, thumb_size=128, quality=85, device="cuda")  # JPEG bytes

    from pixo_tpu_torch import ResizeFilter, ResizeOptions, resize

    opts = ResizeOptions(src_width=w, src_height=h, dst_width=128, dst_height=128,
                         color_type=ColorType.RGB, filter=ResizeFilter.LANCZOS3)
    small = resize.resize(pixels_u8, opts, device="cuda")  # [128, 128, 3] uint8

    from pixo_tpu_torch.parallel import encode_jpeg_stream_overlapped

    opts = JpegOptions(width=512, height=512, quality=85, subsampling=Subsampling.S420)
    stats = {}
    for files in encode_jpeg_stream_overlapped(batches, opts, stats=stats):
        ...                                                # each batch's files, in order
"""

__version__ = "0.5.0"  # before the imports: cli.py reads it while the package loads

from . import decode, errors, jpeg, png, resize  # noqa: E402
from .color import ColorType, rgb_to_ycbcr  # noqa: E402
from .options import (  # noqa: E402
    FilterStrategy,
    JpegOptions,
    PngOptions,
    QuantizationMode,
    QuantizationOptions,
    ResizeFilter,
    ResizeOptions,
    Subsampling,
)
from .parallel import (  # noqa: E402
    decode_jpeg_batch,
    decode_png_batch,
    encode_jpeg_batch_sharded,
    encode_png_batch_sharded,
    encode_png_row_sharded,
    jpeg_coeffs_sharded,
    thumbnail_pipeline,
)

__all__ = [
    "ColorType",
    "FilterStrategy",
    "JpegOptions",
    "PngOptions",
    "QuantizationMode",
    "QuantizationOptions",
    "ResizeFilter",
    "ResizeOptions",
    "Subsampling",
    "decode",
    "decode_jpeg_batch",
    "decode_png_batch",
    "encode_jpeg_batch_sharded",
    "encode_png_batch_sharded",
    "encode_png_row_sharded",
    "errors",
    "jpeg",
    "jpeg_coeffs_sharded",
    "png",
    "resize",
    "rgb_to_ycbcr",
    "thumbnail_pipeline",
    "__version__",
]
