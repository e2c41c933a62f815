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
// and pitch. The host uploads one descriptor per plane (its zigzag table and
// its geometry, 304 bytes each); the launch needs no per-block host array.
//
// What bounds it on the card: memory. Per block it reads 128 bytes of
// coefficients and writes 64 bytes of pixels, against about 600 integer
// operations: below the H100's operations-per-byte balance.
//
// Design: one thread a coefficient block, the block in registers through
// both passes (some 700 instructions a block, no transpose), and around it:
// - a thread block of 128 threads takes 128 consecutive coefficient blocks,
//   16 KB. They come into shared memory first, as 16-byte cp.async granules,
//   neighbouring threads on neighbouring granules: coalesced, and started
//   before anything else, so that the copy runs while the plane is found. A
//   block's granule j lands at slot j ^ (block & 7), so that the threads'
//   reads of their own 128 bytes, 16 at a time, are free of bank conflicts;
// - the plane of the thread block's first coefficient block is found once,
//   by warp 0 probing up to 32 planes a round (two rounds for 1,024 planes);
//   its descriptor and the next one's go to shared memory, and a thread
//   steps on from there while its block index is past the plane's end (a
//   thread block's blocks lie in one or two planes unless planes are tiny;
//   descriptors beyond the two are read from device memory through L1);
// - a thread dequantizes in zigzag order with compile-time indices, so the
//   block never leaves registers, and stores each pixel row as 8 bytes: a
//   warp's 32 blocks are neighbours in a block row, 256 contiguous bytes a
//   pixel row;
// - 80 registers a thread: six thread blocks an SM, so the 768 thread blocks
//   of 16 512x512 4:2:0 images are resident at once.
//
// Tried and lost: the first design (the same arithmetic, every thread
// loading its own 128-byte row from device memory after its own binary
// search over the planes, 88 registers) took 0.0116 ms for those 98,304
// blocks; eight lanes a block (a warp's loads one contiguous 512 bytes, the
// block transposed twice through shared memory, a lane a column, then a lane
// a row, 48 registers) took 0.0125 ms in the same run: its transposes and
// its eightfold index arithmetic made it execute some 3.5 times the
// instructions. This design takes 0.0090 ms (NVIDIA H100 80GB HBM3, 700 W).
//
// The second entry point, pixo_idct8x8_int, is the TPU kernel's own
// contract: [N, 8, 8] int32 natural-order blocks -> [N, 8, 8] uint8, one
// thread a block.

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

constexpr int kPlanesThreads = 128;  // and coefficient blocks a thread block
constexpr int kSmemPlanes = 2;       // descriptors a thread block keeps in shared memory
constexpr int kDescWords = sizeof(PlaneDesc) / 4;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// The last plane whose first block is <= g, or -1 where g lies before every
// plane; run by one whole warp, which probes up to 32 planes a round.
__device__ __forceinline__ int find_plane(const PlaneDesc* __restrict__ planes, int nplanes,
                                          int64_t g, int lane) {
  int lo = 0, hi = nplanes;  // the answer is in [lo, hi), or -1
  if (planes[0].first_block > g) return -1;
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    const bool le = idx < hi && planes[idx].first_block <= g;
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, le));  // >= 1: planes[lo] is <= g
    lo += (c - 1) * step;
    hi = min(hi, lo + step);
  }
  return lo;
}

__global__ void __launch_bounds__(kPlanesThreads) idct_planes_kernel(
    const int16_t* __restrict__ coeffs, int64_t n, const PlaneDesc* __restrict__ planes,
    int nplanes, uint8_t* __restrict__ out) {
  __shared__ __align__(16) int16_t staged[kPlanesThreads * 64];
  __shared__ PlaneDesc local[kSmemPlanes];
  __shared__ int first_plane;

  const int tid = threadIdx.x;
  const int64_t cta0 = static_cast<int64_t>(blockIdx.x) * kPlanesThreads;
  const int here = static_cast<int>(min(static_cast<int64_t>(kPlanesThreads), n - cta0));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int granule = i * kPlanesThreads + tid, blk = granule >> 3, j = granule & 7;
    if (blk < here) {
      cp_async16(staged + 8 * (8 * blk + (j ^ (blk & 7))), coeffs + 64 * cta0 + 8 * granule);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);

  if (tid < 32) {
    const int p = find_plane(planes, nplanes, cta0, tid);
    if (tid == 0) first_plane = max(p, 0);
  }
  __syncthreads();
  const int base = first_plane;
  for (int w = tid; w < kSmemPlanes * kDescWords; w += kPlanesThreads) {
    if (base + w / kDescWords < nplanes) {
      reinterpret_cast<uint32_t*>(local)[w] = reinterpret_cast<const uint32_t*>(planes + base)[w];
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int64_t g = cta0 + tid;
  if (g >= n) return;
  auto desc = [&](int p) { return p - base < kSmemPlanes ? &local[p - base] : &planes[p]; };
  if (desc(base)->first_block > g) return;  // before the first plane
  int p = base;
  while (p + 1 < nplanes && desc(p + 1)->first_block <= g) ++p;
  const PlaneDesc* d = desc(p);
  const int64_t k = g - d->first_block;
  const uint32_t bpr = static_cast<uint32_t>(d->blocks_per_row);
  if (k >= static_cast<int64_t>(bpr) * d->block_rows) return;  // between planes
  const uint32_t by = static_cast<uint32_t>(k) / bpr, bx = static_cast<uint32_t>(k) - by * bpr;

  alignas(16) int16_t zz[64];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<int4*>(zz + 8 * j) =
        *reinterpret_cast<const int4*>(staged + 8 * (8 * tid + (j ^ (tid & 7))));
  }
  uint32_t x[64];
  dequant_natural(zz, d->q, x, InverseZigzag{});
  alignas(8) uint8_t px[64];
  idct8x8_jidctint(x, px);

  const int64_t pitch = d->pitch;
  uint8_t* dst = out + d->out_offset + 8 * static_cast<int64_t>(by) * pitch + 8 * bx;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    *reinterpret_cast<uint2*>(dst + r * pitch) = *reinterpret_cast<const uint2*>(px + 8 * r);
  }
}

constexpr int kIdctThreads = 128;

__device__ __forceinline__ void load_q(const int32_t* src, int32_t* q) {
  const int4* s = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int k = 0; k < 16; ++k) *reinterpret_cast<int4*>(q + 4 * k) = s[k];
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

inline unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
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
  idct_planes_kernel<<<blocks_for(n, kPlanesThreads), kPlanesThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      coeffs, n, static_cast<const PlaneDesc*>(planes), nplanes, out);
  return static_cast<int>(cudaGetLastError());
}

// in: [n, 8, 8] int32 on the device; out: [n, 8, 8] uint8; both 16-byte
// aligned.
int pixo_idct8x8_int(const int32_t* in, uint8_t* out, int64_t n, void* stream) {
  using namespace pixo;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  idct8x8_int_kernel<<<blocks_for(n, kIdctThreads), kIdctThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      in, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
