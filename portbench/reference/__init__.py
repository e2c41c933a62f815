"""The benchmark's plain reference: what ``correct`` is judged against.

Plain PyTorch and NumPy, written for the benchmark from the published
semantics of the baseline JPEG codec and of pixo's Lanczos3 resize (a frozen
rewrite of the plain tier, not an import of it). It imports neither JAX nor
the JAX package nor anything of the program under test, and takes nothing
the program made: it works every output out again from the inputs the
benchmark made.

- ``jpeg_encode``: the coefficient chain (fixed-point BT.601, 4:4:4 and
  4:2:0 blocks, the float AAN DCT in pixo's operation order, quantization
  rounding half away from zero, zigzag), a vectorised baseline Huffman
  packer and the marker frame;
- ``jpeg_decode``: a baseline JPEG parser and Huffman decoder, and the pixel
  tail (dequantization, the jidctint integer IDCT, nearest chroma
  upsampling, the fixed-point inverse BT.601);
- ``resize``: Lanczos3 with pixo's f32 tap order and its intermediate u8
  rounding;
- ``tiers``: which route the compaction takes for a batch of coefficients.

Every float32 step takes an optional ``rnd`` hook, applied to each
result: the control (``portbench/control.py``) passes a bfloat16 rounding
to show that the comparison fails a precision below the one the codec
states.
"""
