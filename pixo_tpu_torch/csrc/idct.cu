// JPEG decode-tail kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel idct8x8_int_pallas (the JAX package's
// ops/pallas_kernels.py:187) and its XLA twin dequant_idct_blocks
// (ops/jpeg_decode.py:136), which the reference decoder runs once per
// component per image (decode/jpeg_decoder.py:598), followed by
// assemble_plane. Here one launch covers every block of every plane of a
// whole batch of images: it dequantizes each int16 zigzag block with its
// plane's table, scatters it to natural order, runs the jidctint column and
// row passes (idct.cuh) and writes the 8x8 pixels into its plane's raster at
// (8 by, 8 bx). The planes lie in one uint8 buffer, each at its own offset
// and pitch.
//
// A block finds its plane by a binary search over the planes' first block
// indices (a few per image), so the launch needs no per-block host array:
// the host uploads one descriptor per plane (its zigzag table and its
// geometry), 304 bytes each.
//
// What bounds it on the card: memory. Per block it reads 128 bytes of
// coefficients and writes 64 bytes of pixels, against about 600 integer
// operations: below the H100's operations-per-byte balance. Design: one
// thread per block, in registers; the coefficients come in with eight
// 16-byte loads and each pixel row goes out as one 8-byte store. The table
// is read from the descriptor through L1, where the threads of one plane
// share it. The loads are not coalesced across a warp (each thread reads
// its own 128-byte row); staging through shared memory is later work.
//
// The second entry point, pixo_idct8x8_int, is the TPU kernel's own
// contract: [N, 8, 8] int32 natural-order blocks -> [N, 8, 8] uint8.

#include <cstdint>
#include <utility>

#include <cuda_runtime.h>

#include "idct.cuh"

namespace pixo {

// One plane of the batch, as the host packs it ([38] int64 a plane).
struct alignas(16) PlaneDesc {
  int32_t q[64];          // dequantization table, zigzag order
  int64_t first_block;    // index of the plane's first block in the coefficients
  int64_t blocks_per_row;
  int64_t block_rows;
  int64_t out_offset;     // byte offset of the plane's raster in the output
  int64_t pitch;          // bytes per raster row
  int64_t pad;
};
static_assert(sizeof(PlaneDesc) == 304, "the host packs 38 int64 a plane");

// Dequantizes a zigzag block in zigzag order and returns it in natural
// order; N... is the inverse zigzag (natural index -> zigzag position), so
// every register index is a compile-time constant.
template <int... N>
__device__ __forceinline__ void dequant_natural(const int16_t* zz, const int32_t* q, uint32_t* x,
                                                std::integer_sequence<int, N...>) {
  uint32_t deq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    deq[i] = static_cast<uint32_t>(static_cast<int32_t>(zz[i])) * static_cast<uint32_t>(q[i]);
  }
  const uint32_t nat[64] = {deq[N]...};
#pragma unroll
  for (int i = 0; i < 64; ++i) x[i] = nat[i];
}

using InverseZigzag = std::integer_sequence<
    int, 0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42, 3, 8, 12, 17, 25, 30, 41, 43, 9,
    11, 18, 24, 31, 40, 44, 53, 10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60, 21,
    34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63>;

__device__ __forceinline__ void load_i16x64(const int16_t* src, int16_t* v) {
  const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int k = 0; k < 8; ++k) *reinterpret_cast<int4*>(v + 8 * k) = s[k];
}

__device__ __forceinline__ void load_q(const int32_t* src, int32_t* q) {
  const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int k = 0; k < 16; ++k) *reinterpret_cast<int4*>(q + 4 * k) = s[k];
}

constexpr int kIdctThreads = 128;

__global__ void __launch_bounds__(kIdctThreads) idct_planes_kernel(
    const int16_t* __restrict__ coeffs, int64_t n, const PlaneDesc* __restrict__ planes,
    int nplanes, uint8_t* __restrict__ out) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= n || planes[0].first_block > gid) return;
  int lo = 0, hi = nplanes - 1;  // the last plane whose first block is <= gid
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (planes[mid].first_block <= gid) lo = mid; else hi = mid - 1;
  }
  const PlaneDesc& p = planes[lo];
  const int64_t k = gid - p.first_block;
  if (k >= p.blocks_per_row * p.block_rows) return;  // between planes: no plane's block
  const int64_t by = k / p.blocks_per_row, bx = k - by * p.blocks_per_row;

  alignas(16) int16_t zz[64];
  alignas(16) int32_t q[64];
  load_i16x64(coeffs + gid * 64, zz);
  load_q(p.q, q);
  uint32_t x[64];
  dequant_natural(zz, q, x, InverseZigzag{});
  alignas(8) uint8_t px[64];
  idct8x8_jidctint(x, px);

  uint8_t* dst = out + p.out_offset + 8 * by * p.pitch + 8 * bx;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<uint2*>(dst + r * p.pitch) = *reinterpret_cast<const uint2*>(px + 8 * r);
  }
}

__global__ void __launch_bounds__(kIdctThreads) idct8x8_int_kernel(
    const int32_t* __restrict__ in, uint8_t* __restrict__ out, int64_t n) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  alignas(16) int32_t v[64];
  load_q(in + gid * 64, v);
  uint32_t x[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) x[i] = static_cast<uint32_t>(v[i]);
  alignas(16) uint8_t px[64];
  idct8x8_jidctint(x, px);
  uint4* dst = reinterpret_cast<uint4*>(out + gid * 64);
#pragma unroll
  for (int k = 0; k < 4; ++k) dst[k] = reinterpret_cast<const uint4*>(px)[k];
}

inline unsigned idct_grid(int64_t n) {
  return static_cast<unsigned>((n + kIdctThreads - 1) / kIdctThreads);
}

}  // namespace pixo

extern "C" {

// coeffs: [n, 64] int16 zigzag blocks on the device, 16-byte aligned;
// planes: [nplanes] descriptors on the device, sorted by first block, their
// block ranges disjoint and inside [0, n); out: the uint8 buffer all planes
// are written to, every offset and pitch a multiple of 8. Blocks outside
// every plane are skipped. Returns cudaGetLastError() after the launch.
int pixo_idct_planes(const int16_t* coeffs, int64_t n, const void* planes, int32_t nplanes,
                     uint8_t* out, void* stream) {
  using namespace pixo;
  if (n <= 0 || nplanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  idct_planes_kernel<<<idct_grid(n), kIdctThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coeffs, n, static_cast<const PlaneDesc*>(planes), nplanes, out);
  return static_cast<int>(cudaGetLastError());
}

// in: [n, 8, 8] int32 on the device; out: [n, 8, 8] uint8; both 16-byte
// aligned.
int pixo_idct8x8_int(const int32_t* in, uint8_t* out, int64_t n, void* stream) {
  using namespace pixo;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  idct8x8_int_kernel<<<idct_grid(n), kIdctThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
