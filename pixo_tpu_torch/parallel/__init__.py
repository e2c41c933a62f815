"""Batch-sharded execution: the batched encode and decode, the JPEG streams,
the thumbnail pipeline, device meshes and the compression service (the
counterpart of the JAX package's ``parallel/``)."""

from .mesh import batch_sharding, make_mesh, replicated
from .pipeline import (
    decode_jpeg_batch,
    decode_png_batch,
    encode_jpeg_batch_sharded,
    encode_jpeg_stream,
    encode_jpeg_stream_overlapped,
    encode_png_batch_sharded,
    encode_png_row_sharded,
    jpeg_coeffs_sharded,
    thumbnail_pipeline,
)
from .service import (
    CompressService,
    Request,
    RequestCancelled,
    RequestTimeout,
    WorkerCrashed,
)

__all__ = [
    "make_mesh",
    "CompressService",
    "RequestTimeout",
    "RequestCancelled",
    "WorkerCrashed",
    "decode_jpeg_batch",
    "decode_png_batch",
    "batch_sharding",
    "jpeg_coeffs_sharded",
    "encode_jpeg_batch_sharded",
    "encode_jpeg_stream",
    "encode_jpeg_stream_overlapped",
    "encode_png_batch_sharded",
    "encode_png_row_sharded",
    "thumbnail_pipeline",
]
