// JPEG coefficient kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel dct8x8_aan_pallas (the JAX package's
// ops/pallas_kernels.py:169), widened to the whole per-block chain of
// jpeg/encoder.py::_device_coeffs: clamp-pad -> fixed-point YCbCr -> chroma
// average (4:2:0, 4:2:2) -> level shift -> AAN DCT rows then columns ->
// q = dct / table -> round half away from zero -> int16 -> zigzag. It reads
// [B, H, W, C] uint8 pixels and writes [B, nblocks, 64] int16 zigzag blocks
// in scan order, the layout the host packer and the compaction kernel read.
//
// What bounds it on the card: memory, in principle. Per pixel it moves C
// bytes in and 2 x 64 / 64 = 2 bytes per coefficient out, against some 14
// float operations per coefficient: the byte bound is 3 to 4 times the
// operation bound. In practice the instructions bound it: the IEEE division
// of the quantizer (about 10 instructions with its range check, kept
// because a reciprocal multiply changes the bits), the rounding, the DCT's
// explicitly rounded operations and the shared-memory traffic come to
// several dozen instructions per coefficient, so the design spends as few
// as it can:
//
// - a persistent thread block (CTA) per resident slot walks over tiles; a
//   tile is one image's run of MCUs inside one MCU row, 128 pixels wide and
//   one MCU high (8 or 16 rows); while the CTA works on one tile, its next
//   tile's rows are already on their way into shared memory (cp.async, two
//   buffers);
// - a warp copies a row with 16-byte cp.async for every aligned 16-byte
//   granule inside the row's bytes and single bytes for the granules at the
//   row's two ends, so any pitch W*C and any image offset work; rows and
//   columns past the image edge are clamped (repeat the last row and
//   column) when the pixels are read back;
// - every pixel is converted to Y, Cb and Cr once: luma into a uint8 plane,
//   chroma into uint8 planes (4:4:4) or, at 4:2:0 and 4:2:2, straight into
//   the integer sum of each chroma sample's pixels: the plain version's f32
//   sums ((a + b) + c) + d of u8 values are exact, so the integer sum
//   converted once is the same float, then * 0.25 (or 0.5) - 128 as before;
// - eight lanes work on one 8x8 block: lane j loads its row with one 8- or
//   16-byte shared load, runs the row pass, the block goes through shared
//   memory, and lane j runs the column pass on column j, with aan_1d's exact
//   operation sequence; the tile's blocks are ordered so that the four
//   blocks of a warp are all luma or all of one chroma component, so no
//   warp runs both load paths;
// - each lane keeps its eight divisors and zigzag destinations in
//   registers, quantizes its column and writes it in zigzag order into the
//   tile's output in shared memory; a run of MCUs in one MCU row is one
//   contiguous range of scan-order blocks, so the tile leaves with
//   coalesced 16-byte stores.
//
// A variant (RAW) stores the column pass's f32 output in zigzag order
// instead of quantizing it: pixo_dct_zz, [B, nblocks, 64] f32, the trellis
// quantizer's front end (jpeg/encoder.py::_device_dct_zz of the JAX package,
// which runs dct8x8_aan_pallas's function). Only the store and the output
// tile differ: f32 doubles the tile (72 floats a block), which at 4:2:0 and
// three channels takes the CTA to 45,568 bytes of shared memory, still five
// CTAs of 384 threads on an SM.
//
// The third entry point, pixo_dct8x8_aan, is the standalone [N, 8, 8] f32
// DCT: the direct counterpart of dct8x8_aan_pallas, sharing the butterfly.

#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

#include "aan.cuh"

namespace pixo {

struct QTables {
  float lum[64];  // natural order
  float chrom[64];
};

enum Mode { kGray = 0, k444 = 1, k420 = 2, k422 = 3 };

// The zigzag position of each natural-order index.
__constant__ uint8_t kZigzagPos[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42, 3,  8,  12, 17, 25, 30,
    41, 43, 9,  11, 18, 24, 31, 40, 44, 53, 10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38,
    46, 51, 55, 60, 21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

constexpr int kTileW = 128;  // pixels a tile spans
constexpr int kPlanePitch = kTileW + 8;  // bytes a uint8 plane row takes: 8-byte rows
constexpr int kSumPitch = kTileW / 2 + 8;  // uint16 entries a chroma-sum row takes: 16-byte rows
constexpr int kBlockPitch = 72;  // floats an 8x8 block takes: rows of 9, no bank conflicts
constexpr int kOutPitch = 72;  // entries an output block takes: its zigzag stores spread over the banks

// The tile of each mode: MCU size, MCUs a tile, blocks an MCU, and its
// chroma planes: full uint8 planes (4:4:4), or the integer sums of each
// chroma sample's 2x2 (4:2:0) or 1x2 (4:2:2) pixels as uint16.
template <int MODE>
struct Tile {
  static constexpr int kMcuW = (MODE == k420 || MODE == k422) ? 16 : 8;
  static constexpr int kRows = MODE == k420 ? 16 : 8;
  static constexpr int kMcus = kTileW / kMcuW;
  static constexpr int kBpm = MODE == kGray ? 1 : (MODE == k444 ? 3 : (MODE == k420 ? 6 : 4));
  static constexpr int kBlocks = kMcus * kBpm;
  static constexpr int kThreads = 8 * kBlocks;
  static constexpr int kLumaSlots = MODE == kGray ? kBlocks : (MODE == k444 ? kMcus : kMcus * (kBpm - 2));
  // per chroma component; gray has none (1 keeps the dead branch's division defined)
  static constexpr int kChromaSlots = MODE == kGray ? 1 : (kBlocks - kLumaSlots) / 2;
  static constexpr int kChromaBytes =
      MODE == kGray ? 0 : (MODE == k444 ? kRows * kPlanePitch : 8 * kSumPitch * 2);
};

// Byte offsets in the dynamic shared memory: two buffers of staged raw rows
// and their row offsets, the blocks between the two DCT passes, the tile's
// output (int16, or f32 for the RAW variant), the luma plane and the two
// chroma planes.
__host__ __device__ inline int raw_pitch(int c) { return kTileW * c + 32; }

template <bool RAW>
using OutT = typename std::conditional<RAW, float, int16_t>::type;

template <int MODE, bool RAW>
struct Smem {
  using T = Tile<MODE>;
  int raw, fblk, otile, luma, chroma, rowoff, total;
  __host__ __device__ explicit Smem(int c) {
    raw = 0;
    fblk = raw + 2 * T::kRows * raw_pitch(c);
    otile = fblk + T::kBlocks * kBlockPitch * 4;
    luma = otile + T::kBlocks * kOutPitch * static_cast<int>(sizeof(OutT<RAW>));
    chroma = luma + T::kRows * kPlanePitch;
    rowoff = chroma + 2 * T::kChromaBytes;
    total = rowoff + 2 * T::kRows * 4;
  }
};

// Fixed-point BT.601 (pixo src/color.rs:60-77): arithmetic shift, clamp.
__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

struct Ycc {
  int y, cb, cr;
};

__device__ __forceinline__ Ycc ycc(const uint8_t* s) {
  const int r = s[0], g = s[1], b = s[2];
  return {clamp255((77 * r + 150 * g + 29 * b + 128) >> 8),
          clamp255(((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128),
          clamp255(((128 * r - 107 * g - 21 * b + 128) >> 8) + 128)};
}

// Byte k of w, level-shifted, as the plain version computes it: u8 -> f32 - 128.
__device__ __forceinline__ float shifted_byte(uint32_t w, int k) {
  return __fsub_rn(static_cast<float>((w >> (8 * k)) & 0xFFu), 128.0f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Where tile t lies: tiles run over images, then MCU rows, then runs of MCUs.
struct TilePos {
  int64_t img, my, mx0;
  int n_mcus;
};

// Tile counts fit in 31 bits (the launch checks), so the divisions are
// 32-bit ones: a 64-bit division is a subroutine of some 70 instructions.
template <int MODE>
__device__ __forceinline__ TilePos tile_pos(uint32_t t, int64_t n_mcu_x, uint32_t n_tiles_x,
                                            uint32_t tiles_per_img) {
  using T = Tile<MODE>;
  TilePos p;
  const uint32_t img = t / tiles_per_img, rem = t - img * tiles_per_img, my = rem / n_tiles_x;
  p.img = img;
  p.my = my;
  p.mx0 = static_cast<int64_t>(rem - my * n_tiles_x) * T::kMcus;
  p.n_mcus = static_cast<int>(n_mcu_x - p.mx0 < T::kMcus ? n_mcu_x - p.mx0 : T::kMcus);
  return p;
}

// Starts the copy of tile p's pixel rows into raw (their offsets into
// rowoff), a warp a row. Granule k of a row covers the 16 bytes at the
// row's first byte rounded down to 16, plus 16 k; it lands at the same
// offset from raw + r * pitch, so a whole granule is one 16-byte cp.async
// and only the granules at the row's two ends are copied byte by byte. Rows
// past the image's last row repeat it.
template <int MODE>
__device__ __forceinline__ void stage_tile(const uint8_t* __restrict__ imgs, int64_t h, int64_t w,
                                           int c, const TilePos& p, uint8_t* raw, int* rowoff) {
  using T = Tile<MODE>;
  const int64_t x0 = p.mx0 * T::kMcuW, y0 = p.my * T::kRows;
  const int64_t xend = x0 + kTileW < w ? x0 + kTileW : w;  // x0 < w always
  const int nbytes = static_cast<int>((xend - x0) * c);
  const int rp = raw_pitch(c);
  const uint8_t* base = imgs + p.img * h * w * c;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < T::kRows; r += T::kThreads / 32) {
    const int64_t y = y0 + r < h ? y0 + r : h - 1;
    const uintptr_t first = reinterpret_cast<uintptr_t>(base + (y * w + x0) * c);
    const uintptr_t last = first + nbytes, g0 = first & ~static_cast<uintptr_t>(15);
    if (lane == 0) rowoff[r] = static_cast<int>(first & 15);
    for (int k = lane; g0 + 16 * k < last; k += 32) {
      const uintptr_t g = g0 + 16 * static_cast<uintptr_t>(k);
      uint8_t* dst = raw + r * rp + 16 * k;
      if (g >= first && g + 16 <= last) {
        cp_async16(dst, reinterpret_cast<const void*>(g));
      } else {
        for (int b = 0; b < 16; ++b) {
          if (g + b >= first && g + b < last) dst[b] = __ldg(reinterpret_cast<const uint8_t*>(g + b));
        }
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One colour conversion per pixel of the staged tile: the luma plane and
// the chroma planes (4:4:4), or the chroma sums (4:2:0 over 2x2 pixels,
// 4:2:2 over 1x2): the plain version's f32 sums of u8 values are exact
// integers, so an integer sum converted once gives the same float. Columns
// past the image's last repeat it.
template <int MODE>
__device__ __forceinline__ void convert_tile(const uint8_t* raw, const int* rowoff, int rp, int c,
                                             int last, uint8_t* luma, uint8_t* chroma) {
  using T = Tile<MODE>;
  const int tid = threadIdx.x;
  if (MODE == kGray || MODE == k444) {
    for (int q = tid; q < T::kRows * kTileW; q += T::kThreads) {
      const int r = q / kTileW, px = q - r * kTileW;
      const uint8_t* s = raw + r * rp + rowoff[r] + (px < last ? px : last) * c;
      uint8_t* d = luma + r * kPlanePitch + px;
      if (MODE == kGray) {
        d[0] = s[0];
      } else {
        const Ycc v = ycc(s);
        d[0] = static_cast<uint8_t>(v.y);
        d[T::kRows * kPlanePitch] = static_cast<uint8_t>(v.cb);
        d[T::kRows * kPlanePitch + T::kChromaBytes] = static_cast<uint8_t>(v.cr);
      }
    }
  } else {
    // a thread takes the 2x2 (4:2:0) or 1x2 (4:2:2) pixels of one chroma sample
    constexpr int kRowsPer = MODE == k420 ? 2 : 1;
    uint16_t* cbs = reinterpret_cast<uint16_t*>(chroma);
    uint16_t* crs = reinterpret_cast<uint16_t*>(chroma + T::kChromaBytes);
    for (int q = tid; q < 8 * (kTileW / 2); q += T::kThreads) {
      const int sy = q / (kTileW / 2), sx = q - sy * (kTileW / 2);
      const int xa = (2 * sx < last ? 2 * sx : last) * c, xb = (2 * sx + 1 < last ? 2 * sx + 1 : last) * c;
      int cb = 0, cr = 0;
#pragma unroll
      for (int dy = 0; dy < kRowsPer; ++dy) {
        const int r = kRowsPer * sy + dy;
        const uint8_t* s = raw + r * rp + rowoff[r];
        const Ycc a = ycc(s + xa), b = ycc(s + xb);
        *reinterpret_cast<uint16_t*>(luma + r * kPlanePitch + 2 * sx) =
            static_cast<uint16_t>(a.y | (b.y << 8));
        cb += a.cb + b.cb;
        cr += a.cr + b.cr;
      }
      cbs[sy * kSumPitch + sx] = static_cast<uint16_t>(cb);
      crs[sy * kSumPitch + sx] = static_cast<uint16_t>(cr);
    }
  }
}

// A persistent loop over tiles: while a CTA converts and transforms one
// tile, the copy of its next tile's rows is in flight. RAW writes the f32
// DCT in zigzag order; otherwise the quantized int16 coefficients.
template <int MODE, bool RAW>
__global__ void __launch_bounds__(Tile<MODE>::kThreads) coeffs_kernel(
    const uint8_t* __restrict__ imgs, int64_t h, int64_t w, int c, int64_t n_mcu_x,
    uint32_t n_tiles_x, uint32_t tiles_per_img, uint32_t n_tiles, int64_t nblocks, QTables qt,
    OutT<RAW>* __restrict__ out) {
  using T = Tile<MODE>;
  extern __shared__ int4 smem[];
  const Smem<MODE, RAW> lay(c);
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem);
  const int rp = raw_pitch(c);
  float* fblk = reinterpret_cast<float*>(sm + lay.fblk);
  OutT<RAW>* otile = reinterpret_cast<OutT<RAW>*>(sm + lay.otile);
  uint8_t* luma = sm + lay.luma;
  uint8_t* chroma = sm + lay.chroma;
  int* rowoffs = reinterpret_cast<int*>(sm + lay.rowoff);

  // slot -> (MCU in the tile, plane, position in the MCU's scan order,
  // sample origin): fixed for the whole loop
  const int tid = threadIdx.x, slot = tid >> 3, j = tid & 7;
  int mcu, plane, comp, ry = 0, cx;
  if (slot < T::kLumaSlots) {
    plane = 0;
    if (MODE == k420) {
      mcu = slot >> 2;
      comp = slot & 3;
      ry = (comp >> 1) * 8;
      cx = mcu * 16 + (comp & 1) * 8;
    } else if (MODE == k422) {
      mcu = slot >> 1;
      comp = slot & 1;
      cx = mcu * 16 + comp * 8;
    } else {
      mcu = slot;
      comp = 0;
      cx = mcu * 8;
    }
  } else {
    const int s = slot - T::kLumaSlots;
    plane = 1 + s / T::kChromaSlots;
    mcu = s - (plane - 1) * T::kChromaSlots;
    comp = T::kBpm - 3 + plane;
    cx = mcu * T::kMcuW;
  }
  // this lane's quantizer divisors and zigzag destinations, in registers
  float tq[8];
  int zo[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    tq[k] = plane > 0 ? qt.chrom[8 * k + j] : qt.lum[8 * k + j];
    zo[k] = (mcu * T::kBpm + comp) * kOutPitch + kZigzagPos[8 * k + j];
  }
  // where the lane's row of samples starts
  const uint8_t* src8 = plane == 0 ? luma + (ry + j) * kPlanePitch + cx
                                   : chroma + (plane - 1) * T::kChromaBytes + j * kPlanePitch + cx;
  const uint16_t* src16 = reinterpret_cast<const uint16_t*>(chroma + (plane > 0 ? plane - 1 : 0) *
                                                                         T::kChromaBytes) +
                          j * kSumPitch + cx / 2;
  float* blk = fblk + slot * kBlockPitch;

  int buf = 0;
  TilePos next = tile_pos<MODE>(blockIdx.x, n_mcu_x, n_tiles_x, tiles_per_img);
  if (blockIdx.x < n_tiles) stage_tile<MODE>(imgs, h, w, c, next, sm + lay.raw, rowoffs);
  for (uint32_t t = blockIdx.x; t < n_tiles; t += gridDim.x, buf ^= 1) {
    const TilePos p = next;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // this tile's rows are in; the last tile's work is done
    if (t + gridDim.x < n_tiles) {
      next = tile_pos<MODE>(t + gridDim.x, n_mcu_x, n_tiles_x, tiles_per_img);
      stage_tile<MODE>(imgs, h, w, c, next, sm + lay.raw + (buf ^ 1) * T::kRows * rp,
                       rowoffs + (buf ^ 1) * T::kRows);
    }
    const int64_t x0 = p.mx0 * T::kMcuW;
    const int last = static_cast<int>(w - 1 - x0 < kTileW - 1 ? w - 1 - x0 : kTileW - 1);
    convert_tile<MODE>(sm + lay.raw + buf * T::kRows * rp, rowoffs + buf * T::kRows, rp, c, last,
                       luma, chroma);
    __syncthreads();

    // row pass on row j of the block
    float v[8];
    if (plane > 0 && (MODE == k420 || MODE == k422)) {
      // the chroma mean: (sum * 0.25 or 0.5) - 128, as the plain version rounds it
      constexpr float kMean = MODE == k420 ? 0.25f : 0.5f;
      const uint4 s = *reinterpret_cast<const uint4*>(src16);
      const uint32_t words[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float sum = static_cast<float>((words[k >> 1] >> (16 * (k & 1))) & 0xFFFFu);
        v[k] = __fsub_rn(__fmul_rn(sum, kMean), 128.0f);
      }
    } else {
      const uint2 s = *reinterpret_cast<const uint2*>(src8);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = shifted_byte(k < 4 ? s.x : s.y, k & 3);
    }
    aan_1d<1>(v);
#pragma unroll
    for (int k = 0; k < 8; ++k) blk[9 * j + k] = v[k];
    __syncwarp();

    // column pass on column j, then quantize and zigzag into the tile
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = blk[9 * k + j];
    aan_1d<1>(v);
    if (mcu < p.n_mcus) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if constexpr (RAW) {
          otile[zo[k]] = v[k];
        } else {
          // IEEE division, then roundf: round half away from zero (Rust f32::round)
          otile[zo[k]] = static_cast<int16_t>(static_cast<int>(roundf(__fdiv_rn(v[k], tq[k]))));
        }
      }
    }
    __syncthreads();

    // the tile's blocks are one contiguous range of the scan order; a block
    // is 8 (int16) or 16 (f32) 16-byte words
    constexpr int kShift = RAW ? 4 : 3;
    constexpr int kPitchWords = kOutPitch * static_cast<int>(sizeof(OutT<RAW>)) / 16;
    const int64_t first_block = p.img * nblocks + (p.my * n_mcu_x + p.mx0) * T::kBpm;
    int4* dst = reinterpret_cast<int4*>(out + first_block * 64);
    const int4* src = reinterpret_cast<const int4*>(otile);
    for (int k = tid; k < (p.n_mcus * T::kBpm) << kShift; k += T::kThreads)
      dst[k] = src[(k >> kShift) * kPitchWords + (k & ((1 << kShift) - 1))];
  }
}

__global__ void __launch_bounds__(128) dct8x8_aan_kernel(const float* __restrict__ in,
                                                         float* __restrict__ out, int64_t n) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const float4* src = reinterpret_cast<const float4*>(in + gid * 64);
  float x[64];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float4 v = src[k];
    x[4 * k] = v.x;
    x[4 * k + 1] = v.y;
    x[4 * k + 2] = v.z;
    x[4 * k + 3] = v.w;
  }
  dct8x8_aan(x);
  float4* dst = reinterpret_cast<float4*>(out + gid * 64);
#pragma unroll
  for (int k = 0; k < 16; ++k) dst[k] = make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

constexpr int kThreads = 128;
constexpr int kMaxChannels = 16;  // a tile's two raw buffers then take at most 65 KB
constexpr int kMaxDevices = 64;

inline unsigned grid_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

// CTAs of coeffs_kernel<MODE, RAW> that fit on one SM at c channels (after
// raising its shared-memory limit where the tile needs more than 48 KB).
template <int MODE, bool RAW>
cudaError_t ctas_per_sm(int c, int* per_sm) {
  const int smem = Smem<MODE, RAW>(c).total;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(coeffs_kernel<MODE, RAW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, coeffs_kernel<MODE, RAW>, Tile<MODE>::kThreads,
                                                       smem);
}

template <int MODE, bool RAW>
cudaError_t launch_coeffs(const uint8_t* imgs, int64_t batch, int64_t h, int64_t w, int c,
                          const QTables& qt, OutT<RAW>* out, cudaStream_t s) {
  using T = Tile<MODE>;
  const int64_t n_mcu_x = (w + T::kMcuW - 1) / T::kMcuW, n_mcu_y = (h + T::kRows - 1) / T::kRows;
  const int64_t n_tiles_x = (n_mcu_x + T::kMcus - 1) / T::kMcus;
  const int64_t tiles_per_img = n_tiles_x * n_mcu_y;
  const int smem = Smem<MODE, RAW>(c).total;
  if (c > kMaxChannels || batch * tiles_per_img > 0x7FFFFFFF) return cudaErrorInvalidValue;
  // CTAs that fit on the card at once, per device and channel count
  static int resident[kMaxDevices][kMaxChannels + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev][c] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = ctas_per_sm<MODE, RAW>(c, &per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[dev][c] = sms * per_sm;
  }
  const int64_t n_tiles = batch * tiles_per_img;
  const unsigned grid = static_cast<unsigned>(n_tiles < resident[dev][c] ? n_tiles : resident[dev][c]);
  coeffs_kernel<MODE, RAW><<<grid, T::kThreads, smem, s>>>(
      imgs, h, w, c, n_mcu_x, static_cast<uint32_t>(n_tiles_x), static_cast<uint32_t>(tiles_per_img),
      static_cast<uint32_t>(n_tiles), n_mcu_x * n_mcu_y * T::kBpm, qt, out);
  return cudaGetLastError();
}

}  // namespace pixo

extern "C" {

// imgs: [batch, h, w, c] uint8 on the device (c = 1 for gray, 3 or more
// otherwise, at most kMaxChannels = 16);
// lum/chrom: natural-order [64] f32 in HOST memory (passed by value to the
// kernel); out: [batch, nblocks, 64] int16 on the device, 16-byte aligned.
// Returns cudaGetLastError() after the launch.
int pixo_coeffs(const uint8_t* imgs, int64_t batch, int64_t h, int64_t w, int32_t c,
                int32_t mode, const float* lum, const float* chrom, int16_t* out,
                void* stream) {
  using namespace pixo;
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  QTables qt;
  std::memcpy(qt.lum, lum, sizeof(qt.lum));
  std::memcpy(qt.chrom, chrom, sizeof(qt.chrom));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kGray: return static_cast<int>(launch_coeffs<kGray, false>(imgs, batch, h, w, c, qt, out, s));
    case k444: return static_cast<int>(launch_coeffs<k444, false>(imgs, batch, h, w, c, qt, out, s));
    case k420: return static_cast<int>(launch_coeffs<k420, false>(imgs, batch, h, w, c, qt, out, s));
    case k422: return static_cast<int>(launch_coeffs<k422, false>(imgs, batch, h, w, c, qt, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The RAW variant: imgs as pixo_coeffs takes them; out: [batch, nblocks, 64]
// f32 zigzag DCT on the device, 16-byte aligned.
int pixo_dct_zz(const uint8_t* imgs, int64_t batch, int64_t h, int64_t w, int32_t c, int32_t mode,
                float* out, void* stream) {
  using namespace pixo;
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  QTables qt;  // not read by the RAW variant
  std::memset(&qt, 0, sizeof(qt));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kGray: return static_cast<int>(launch_coeffs<kGray, true>(imgs, batch, h, w, c, qt, out, s));
    case k444: return static_cast<int>(launch_coeffs<k444, true>(imgs, batch, h, w, c, qt, out, s));
    case k420: return static_cast<int>(launch_coeffs<k420, true>(imgs, batch, h, w, c, qt, out, s));
    case k422: return static_cast<int>(launch_coeffs<k422, true>(imgs, batch, h, w, c, qt, out, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// CTAs of the coefficient kernel (raw = 0) or its RAW variant (raw = 1) an
// SM holds at c channels, into *per_sm: the occupancy check of the
// variant's larger tile. Returns the CUDA error.
int pixo_coeffs_ctas_per_sm(int32_t mode, int32_t c, int32_t raw, int32_t* per_sm) {
  using namespace pixo;
  if (c <= 0 || c > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  switch (mode * 2 + (raw != 0)) {
    case 2 * kGray: err = ctas_per_sm<kGray, false>(c, per_sm); break;
    case 2 * kGray + 1: err = ctas_per_sm<kGray, true>(c, per_sm); break;
    case 2 * k444: err = ctas_per_sm<k444, false>(c, per_sm); break;
    case 2 * k444 + 1: err = ctas_per_sm<k444, true>(c, per_sm); break;
    case 2 * k420: err = ctas_per_sm<k420, false>(c, per_sm); break;
    case 2 * k420 + 1: err = ctas_per_sm<k420, true>(c, per_sm); break;
    case 2 * k422: err = ctas_per_sm<k422, false>(c, per_sm); break;
    case 2 * k422 + 1: err = ctas_per_sm<k422, true>(c, per_sm); break;
    default: break;
  }
  return static_cast<int>(err);
}

// in/out: [n, 8, 8] f32 on the device, 16-byte aligned.
int pixo_dct8x8_aan(const float* in, float* out, int64_t n, void* stream) {
  using namespace pixo;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dct8x8_aan_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* pixo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
