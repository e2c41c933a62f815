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
// Its f32 sibling, dct_zz_kernel, is the same chain up to the unquantized
// DCT in zigzag order (pixo_dct_zz, [B, nblocks, 64] f32): the trellis
// quantizer's front end, replacing jpeg/encoder.py::_device_dct_zz of the
// JAX package (which runs dct8x8_aan_pallas's function). It shares the
// tiles, the block slots and the butterfly. Its bound is bytes, its output
// twice the int16 bytes; like the coefficient kernel it was held back by
// the instructions each SM issues, the conversion above all, so its design
// spends fewer (chip_smoke.py --coeffs-parts dct_zz takes it apart):
//
// - a card-sized grid (SMs x kZzThreadsPerSm / the tile's threads, or the
//   occupancy where it is less: 3 CTAs an SM at 4:2:0) in which each CTA
//   walks one contiguous share of the batch's tiles, the shares differing
//   by at most one tile (ops/kernels.py::dct_zz_plan), with cursors that
//   step from tile to tile instead of two divisions a tile;
// - a ring of kZzStages input stages filled by warp 0: lane r asks for row
//   r with one bulk copy (cp.async.bulk, the row's whole 16-byte granules)
//   that completes on the stage's mbarrier, and copies the bytes at its two
//   ends itself; the other warps spend no instructions on the loads;
// - tile i + 1 is converted while tile i goes through the passes, into the
//   other of two sets of planes, so a tile takes one barrier;
// - the conversion computes ycc()'s integers as byte dot products, four
//   pixels of a row a thread (with three channels and a row offset that is
//   a multiple of 4, three aligned words), into full-resolution chroma
//   planes: at 4:2:0 and 4:2:2 the chroma blocks' lanes sum each sample's
//   pixels in the row pass;
// - the column pass writes the zigzag f32 values into an unpadded tile of 64
//   floats a block, the tile's blocks being one contiguous range of the
//   output, and one thread sends the tile with one bulk copy (cp.async.bulk,
//   shared to global) from one of two buffers, so no other thread stores to
//   global memory. A warp's four blocks store the same zigzag row at once,
//   four to a bank: a rotation by the block's place in its warp halves that
//   but cost more in selects than it saved (tests/test_torch_dct_zz_plan.py
//   models both).
//
// The third entry point, pixo_dct8x8_aan, is the standalone [N, 8, 8] f32
// DCT: the direct counterpart of dct8x8_aan_pallas, sharing the butterfly.
// Its bound is bytes (512 a block); eight lanes take a block as the
// coefficient kernel does: lane j loads row j with two 16-byte loads (a
// warp reads four blocks, 1 KB, contiguous), the block passes through a
// padded shared tile between the passes and once more so that each lane
// stores two 16-byte pieces that, lane by lane, tile whole 128-byte lines.

#include <cstdint>
#include <cstring>

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

// Byte offsets in the dynamic shared memory: the buffers of staged raw
// rows (stages of them) and their row offsets, the blocks between the two
// DCT passes, the tile's output (otile_bytes), and `planes` sets of the
// luma plane and the two chroma planes (chroma_bytes each). Every offset is
// a multiple of 16.
__host__ __device__ inline int raw_pitch(int c) { return kTileW * c + 32; }

template <int MODE>
struct Smem {
  using T = Tile<MODE>;
  int raw, fblk, otile, luma, chroma, plane_bytes, rowoff, total;
  __host__ __device__ Smem(int c, int stages, int otile_bytes, int chroma_bytes, int planes = 1) {
    raw = 0;
    fblk = raw + stages * T::kRows * raw_pitch(c);
    otile = fblk + T::kBlocks * kBlockPitch * 4;
    luma = otile + otile_bytes;
    chroma = luma + T::kRows * kPlanePitch;
    plane_bytes = T::kRows * kPlanePitch + 2 * chroma_bytes;  // a set of planes, luma then chroma
    rowoff = luma + planes * plane_bytes;
    total = rowoff + stages * T::kRows * 4;
  }
};

// dct_zz_kernel's ring of input stages, and the threads an SM its plan
// sizes the grid by (ops/kernels.py::DCT_ZZ_THREADS_PER_SM)
constexpr int kZzStages = 2;
constexpr int kZzThreadsPerSm = 1152;

// The int16 kernel: two stages, a padded int16 tile. dct_zz_kernel:
// kZzStages stages, two unpadded f32 tiles of 64 floats a block (one's
// bulk copy overlaps the next tile) and two sets of planes.
template <int MODE>
__host__ __device__ inline Smem<MODE> coeffs_smem(int c) {
  return Smem<MODE>(c, 2, Tile<MODE>::kBlocks * kOutPitch * 2, Tile<MODE>::kChromaBytes);
}

// dct_zz_kernel's chroma planes at 4:2:0 and 4:2:2: every pixel's Cb and Cr
// as uint8 (the sums are the row pass's), rows of kZzChromaPitch bytes so
// that a lane's 16 pixels are one aligned 16-byte load; 4:4:4 as the
// coefficient kernel's.
constexpr int kZzChromaPitch = kTileW + 16;
template <int MODE>
__host__ __device__ constexpr int zz_chroma_bytes() {
  return MODE == k420 || MODE == k422 ? Tile<MODE>::kRows * kZzChromaPitch : Tile<MODE>::kChromaBytes;
}
template <int MODE>
__host__ __device__ inline Smem<MODE> zz_smem(int c) {
  return Smem<MODE>(c, kZzStages, 2 * Tile<MODE>::kBlocks * 64 * 4, zz_chroma_bytes<MODE>(), 2);
}
// dct_zz_kernel's shared memory: its layout, then a mbarrier a stage
template <int MODE>
inline int zz_smem_bytes(int c) {
  return zz_smem<MODE>(c).total + 8 * kZzStages;
}

// CTAs an SM dct_zz_kernel's plan takes: gray 9, 4:4:4 3, 4:2:0 3, 4:2:2 4
template <int MODE>
__host__ __device__ constexpr int zz_plan_ctas() {
  return kZzThreadsPerSm / Tile<MODE>::kThreads;
}

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

// dct_zz_kernel's conversion: ycc()'s fixed-point BT.601 as byte dot
// products (IDP4A), exact. Y's weights 77, 150 and 29 are unsigned bytes
// and sum to 256, so Y needs no clamp; Cb's and Cr's 128 is 127 + 1 (signed
// bytes), and ((x >> 8) + 128) = (x + 32768) >> 8 lies in [1, 256], so
// only 256 is clamped. A pixel's bytes come from two aligned 32-bit loads
// and a funnel shift instead of three byte loads (the conversion was a
// fifth of the f32 variant's time, --coeffs-parts dct_zz).
__device__ __forceinline__ int dp4a_us(uint32_t a, uint32_t b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// R, G and B of the pixel at byte `at` of a 16-byte aligned row, as bytes
// 0-2 of a word (byte 3, the next byte of the row, is weighted 0).
__device__ __forceinline__ uint32_t pixel_word(const uint8_t* row, int at) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + (at >> 2);
  return __funnelshift_r(w[0], w[1], 8 * (at & 3));
}

__device__ __forceinline__ Ycc ycc_word(uint32_t p) {
  const int y = static_cast<int>(__dp4a(p, 0x001D964Du, 128u) >> 8);
  const int cb = dp4a_us(p, 0x007FABD5u, dp4a_us(p, 0x00010000u, 32896)) >> 8;  // -43, -85, 127; + b
  const int cr = dp4a_us(p, 0x00EB957Fu, dp4a_us(p, 0x00000001u, 32896)) >> 8;  // 127, -107, -21; + r
  return {y, cb < 255 ? cb : 255, cr < 255 ? cr : 255};
}

// dct_zz_kernel's conversion, with ycc_word: gray takes convert_tile; the
// colour modes write every pixel's Y, Cb and Cr into uint8 planes (at 4:2:0
// and 4:2:2 the chroma sums are the row pass's, zz_chroma_row), four
// pixels of a row a thread: with three channels and a row offset that is a
// multiple of 4, the four pixels are three aligned words, else each pixel
// is two loads and a funnel shift; each plane takes one word store.
template <int MODE>
__device__ __forceinline__ void convert_words(const uint8_t* raw, const int* rowoff, int rp, int c,
                                              int last, uint8_t* luma, uint8_t* chroma) {
  using T = Tile<MODE>;
  constexpr int kPitch = MODE == k420 || MODE == k422 ? kZzChromaPitch : kPlanePitch;
  if (MODE == kGray) {
    convert_tile<MODE>(raw, rowoff, rp, c, last, luma, chroma);
    return;
  }
  for (int q = threadIdx.x; q < T::kRows * (kTileW / 4); q += T::kThreads) {
    const int r = q / (kTileW / 4), x = 4 * (q - r * (kTileW / 4));
    const uint8_t* row = raw + r * rp;
    const int off = rowoff[r];
    uint32_t px[4];
    if (c == 3 && (off & 3) == 0 && x + 3 <= last) {
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(row + off) + 3 * (x / 4);
      const uint32_t w0 = wp[0], w1 = wp[1], w2 = wp[2];
      px[0] = w0;
      px[1] = __funnelshift_r(w0, w1, 24);
      px[2] = __funnelshift_r(w1, w2, 16);
      px[3] = w2 >> 8;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) px[e] = pixel_word(row, off + (x + e < last ? x + e : last) * c);
    }
    uint32_t y = 0, cb = 0, cr = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const Ycc v = ycc_word(px[e]);
      y |= static_cast<uint32_t>(v.y) << (8 * e);
      cb |= static_cast<uint32_t>(v.cb) << (8 * e);
      cr |= static_cast<uint32_t>(v.cr) << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(luma + r * kPlanePitch + x) = y;
    *reinterpret_cast<uint32_t*>(chroma + r * kPitch + x) = cb;
    *reinterpret_cast<uint32_t*>(chroma + zz_chroma_bytes<MODE>() + r * kPitch + x) = cr;
  }
}

// Lane j's row of a 4:2:0 or 4:2:2 chroma block in dct_zz_kernel: the sums
// of each sample's 2x2 (rows 2j and 2j + 1 of the plane) or 1x2 (row j)
// pixels, as byte dot products, then (sum * 0.25 or 0.5) - 128 as the
// plain version rounds it. src: the block's first pixel of the lane's
// first row, 16-byte aligned.
template <int MODE>
__device__ __forceinline__ void zz_chroma_row(const uint8_t* src, float* v) {
  constexpr float kMean = MODE == k420 ? 0.25f : 0.5f;
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint4 b = MODE == k420 ? *reinterpret_cast<const uint4*>(src + kZzChromaPitch) : make_uint4(0, 0, 0, 0);
  const uint32_t wa[4] = {a.x, a.y, a.z, a.w}, wb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t pair = (k & 1) ? 0x01010000u : 0x00000101u;  // pixels 2k and 2k + 1
    const uint32_t sum = __dp4a(wa[k >> 1], pair, __dp4a(wb[k >> 1], pair, 0u));
    v[k] = __fsub_rn(__fmul_rn(static_cast<float>(sum), kMean), 128.0f);
  }
}

// Where block slot `slot` of a tile takes its samples, fixed for a kernel's
// whole loop: its MCU in the tile, its plane (0 luma, 1 Cb, 2 Cr), its place
// in the MCU's scan order, and its sample origin (row ry, column cx).
struct Slot {
  int mcu, plane, comp, ry, cx;
};

template <int MODE>
__device__ __forceinline__ Slot slot_of(int slot) {
  using T = Tile<MODE>;
  Slot s;
  s.ry = 0;
  if (slot < T::kLumaSlots) {
    s.plane = 0;
    if (MODE == k420) {
      s.mcu = slot >> 2;
      s.comp = slot & 3;
      s.ry = (s.comp >> 1) * 8;
      s.cx = s.mcu * 16 + (s.comp & 1) * 8;
    } else if (MODE == k422) {
      s.mcu = slot >> 1;
      s.comp = slot & 1;
      s.cx = s.mcu * 16 + s.comp * 8;
    } else {
      s.mcu = slot;
      s.comp = 0;
      s.cx = s.mcu * 8;
    }
  } else {
    const int q = slot - T::kLumaSlots;
    s.plane = 1 + q / T::kChromaSlots;
    s.mcu = q - (s.plane - 1) * T::kChromaSlots;
    s.comp = T::kBpm - 3 + s.plane;
    s.cx = s.mcu * T::kMcuW;
  }
  return s;
}

// A persistent loop over tiles: while a CTA converts and transforms one
// tile, the copy of its next tile's rows is in flight. It writes the
// quantized int16 coefficients in zigzag order.
template <int MODE>
__global__ void __launch_bounds__(Tile<MODE>::kThreads) coeffs_kernel(
    const uint8_t* __restrict__ imgs, int64_t h, int64_t w, int c, int64_t n_mcu_x,
    uint32_t n_tiles_x, uint32_t tiles_per_img, uint32_t n_tiles, int64_t nblocks, QTables qt,
    int16_t* __restrict__ out) {
  using T = Tile<MODE>;
  extern __shared__ int4 smem[];
  const Smem<MODE> lay = coeffs_smem<MODE>(c);
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem);
  const int rp = raw_pitch(c);
  float* fblk = reinterpret_cast<float*>(sm + lay.fblk);
  int16_t* otile = reinterpret_cast<int16_t*>(sm + lay.otile);
  uint8_t* luma = sm + lay.luma;
  uint8_t* chroma = sm + lay.chroma;
  int* rowoffs = reinterpret_cast<int*>(sm + lay.rowoff);

  const int tid = threadIdx.x, slot = tid >> 3, j = tid & 7;
  const Slot sl = slot_of<MODE>(slot);
  const int mcu = sl.mcu, plane = sl.plane;
  // this lane's quantizer divisors and zigzag destinations, in registers
  float tq[8];
  int zo[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    tq[k] = plane > 0 ? qt.chrom[8 * k + j] : qt.lum[8 * k + j];
    zo[k] = (mcu * T::kBpm + sl.comp) * kOutPitch + kZigzagPos[8 * k + j];
  }
  // where the lane's row of samples starts
  const uint8_t* src8 = plane == 0 ? luma + (sl.ry + j) * kPlanePitch + sl.cx
                                   : chroma + (plane - 1) * T::kChromaBytes + j * kPlanePitch + sl.cx;
  const uint16_t* src16 = reinterpret_cast<const uint16_t*>(chroma + (plane > 0 ? plane - 1 : 0) *
                                                                         T::kChromaBytes) +
                          j * kSumPitch + sl.cx / 2;
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
        // IEEE division, then roundf: round half away from zero (Rust f32::round)
        otile[zo[k]] = static_cast<int16_t>(static_cast<int>(roundf(__fdiv_rn(v[k], tq[k]))));
      }
    }
    __syncthreads();

    // the tile's blocks are one contiguous range of the scan order; a block
    // is 8 16-byte words
    constexpr int kShift = 3;
    constexpr int kPitchWords = kOutPitch * 2 / 16;
    const int64_t first_block = p.img * nblocks + (p.my * n_mcu_x + p.mx0) * T::kBpm;
    int4* dst = reinterpret_cast<int4*>(out + first_block * 64);
    const int4* src = reinterpret_cast<const int4*>(otile);
    for (int k = tid; k < (p.n_mcus * T::kBpm) << kShift; k += T::kThreads)
      dst[k] = src[(k >> kShift) * kPitchWords + (k & ((1 << kShift) - 1))];
  }
}

// Sends `bytes` (a multiple of 16) of shared memory at src to global memory
// at dst (both 16-byte aligned) with one bulk copy, as a bulk group of the
// calling thread.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(s),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The mbarrier of a stage of dct_zz_kernel's ring: one arrival (lane 0 of
// warp 0, once the stage's rows are asked for) and the bytes of the rows'
// bulk copies.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Tile p's pixel rows into raw, laid out as stage_tile lays them (byte g of
// a row at raw + r * pitch + g - (the row's first byte rounded down to 16),
// its offset into rowoff), by warp 0: lane r takes row r, one bulk copy of
// the row's whole 16-byte granules that completes on bar, and single bytes
// for the granules at its two ends. Rows past the image's last row repeat
// it.
template <int MODE>
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ imgs, int64_t h, int64_t w, int c,
                                           const TilePos& p, uint8_t* raw, int* rowoff, uint64_t* bar) {
  using T = Tile<MODE>;
  const int lane = threadIdx.x & 31;
  if (lane < T::kRows) {
    const int64_t x0 = p.mx0 * T::kMcuW, y0 = p.my * T::kRows;
    const int64_t xend = x0 + kTileW < w ? x0 + kTileW : w;
    const int64_t y = y0 + lane < h ? y0 + lane : h - 1;
    const uintptr_t first = reinterpret_cast<uintptr_t>(imgs + ((p.img * h + y) * w + x0) * c);
    const uintptr_t last = first + static_cast<uintptr_t>((xend - x0) * c), g0 = first & ~uintptr_t{15};
    const uintptr_t lo = (first + 15) & ~uintptr_t{15}, hi = last & ~uintptr_t{15};
    const uintptr_t mid_lo = lo < last ? lo : last, mid_hi = hi > mid_lo ? hi : mid_lo;
    uint8_t* row = raw + lane * raw_pitch(c);  // byte g lands at row[g - g0]
    rowoff[lane] = static_cast<int>(first & 15);
    if (mid_hi > mid_lo) {
      const unsigned bytes = static_cast<unsigned>(mid_hi - mid_lo);
      asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
              smem_addr(row + (mid_lo - g0))),
          "l"(mid_lo), "r"(bytes), "r"(smem_addr(bar))
          : "memory");
    }
    for (uintptr_t g = first; g < mid_lo; ++g) row[g - g0] = __ldg(reinterpret_cast<const uint8_t*>(g));
    for (uintptr_t g = mid_hi; g < last; ++g) row[g - g0] = __ldg(reinterpret_cast<const uint8_t*>(g));
  }
  __syncwarp();
  if (lane == 0) asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar)) : "memory");
}

// The next tile of a walk in tile order (images, MCU rows, runs of MCUs).
template <int MODE>
__device__ __forceinline__ void next_tile(TilePos& p, int64_t n_mcu_x, int64_t n_mcu_y) {
  using T = Tile<MODE>;
  p.mx0 += T::kMcus;
  if (p.mx0 >= n_mcu_x) {
    p.mx0 = 0;
    if (++p.my == n_mcu_y) {
      p.my = 0;
      ++p.img;
    }
  }
  p.n_mcus = static_cast<int>(n_mcu_x - p.mx0 < T::kMcus ? n_mcu_x - p.mx0 : T::kMcus);
}

// The f32 zigzag DCT: each CTA walks its share of the tiles with
// kZzStages - 1 tiles' rows in flight, and sends each tile's output with
// one bulk copy from one of two buffers (see the head of this file).
template <int MODE>
__global__ void __launch_bounds__(Tile<MODE>::kThreads, zz_plan_ctas<MODE>()) dct_zz_kernel(
    const uint8_t* __restrict__ imgs, int64_t h, int64_t w, int c, int64_t n_mcu_x,
    uint32_t n_tiles_x, uint32_t tiles_per_img, uint32_t n_tiles, int64_t nblocks,
    float* __restrict__ out) {
  using T = Tile<MODE>;
  extern __shared__ int4 smem[];
  const Smem<MODE> lay = zz_smem<MODE>(c);
  uint8_t* const sm = reinterpret_cast<uint8_t*>(smem);
  const int rp = raw_pitch(c), stage_bytes = T::kRows * rp;
  float* fblk = reinterpret_cast<float*>(sm + lay.fblk);
  float* otile = reinterpret_cast<float*>(sm + lay.otile);
  int* rowoffs = reinterpret_cast<int*>(sm + lay.rowoff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.total);  // kZzStages mbarriers

  const int tid = threadIdx.x, slot = tid >> 3, j = tid & 7;
  const Slot sl = slot_of<MODE>(slot);
  int zo[8];  // the lane's zigzag destinations in the tile
#pragma unroll
  for (int k = 0; k < 8; ++k) zo[k] = (sl.mcu * T::kBpm + sl.comp) * 64 + kZigzagPos[8 * k + j];
  // where the lane's row of samples starts in the first set of planes: its
  // luma or 4:4:4 chroma row, or the first of the chroma pixel rows it sums
  constexpr bool kSums = MODE == k420 || MODE == k422;
  const int src = sl.plane == 0 ? lay.luma + (sl.ry + j) * kPlanePitch + sl.cx
                                : lay.chroma + (sl.plane - 1) * zz_chroma_bytes<MODE>() +
                                      (kSums ? (MODE == k420 ? 2 * j : j) * kZzChromaPitch : j * kPlanePitch) +
                                      sl.cx;
  float* blk = fblk + slot * kBlockPitch;

  // this CTA's tiles [t0, t0 + count): one contiguous share of shares that
  // differ by at most one tile (ops/kernels.py::dct_zz_plan)
  const uint32_t q = n_tiles / gridDim.x, r = n_tiles - q * gridDim.x;
  const uint32_t t0 = blockIdx.x * q + (blockIdx.x < r ? blockIdx.x : r);
  const uint32_t count = q + (blockIdx.x < r ? 1u : 0u);
  const int64_t n_mcu_y = tiles_per_img / n_tiles_x;
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < kZzStages; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + k)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // cursors: tile i (its passes), tile i + 1 (its conversion), and the
  // tile the next staging asks for
  TilePos p = tile_pos<MODE>(t0, n_mcu_x, n_tiles_x, tiles_per_img), conv = p, ahead = p;
  for (int k = 0; k < kZzStages; ++k) {
    if (k > 0) next_tile<MODE>(ahead, n_mcu_x, n_mcu_y);
    if (tid < 32 && static_cast<uint32_t>(k) < count)
      stage_rows<MODE>(imgs, h, w, c, ahead, sm + lay.raw + k * stage_bytes, rowoffs + k * T::kRows, bars + k);
  }
  // tile i + 1 is converted while tile i is transformed: a tile takes one
  // barrier, and a warp's conversion and passes overlap other warps'
  const auto convert = [&](uint32_t t, const TilePos& at) {
    const int stage = static_cast<int>(t % kZzStages);
    mbar_wait(bars + stage, (t / kZzStages) & 1);
    const int64_t x0 = at.mx0 * T::kMcuW;
    const int last = static_cast<int>(w - 1 - x0 < kTileW - 1 ? w - 1 - x0 : kTileW - 1);
    uint8_t* luma = sm + lay.luma + (t & 1) * lay.plane_bytes;
    convert_words<MODE>(sm + lay.raw + stage * stage_bytes, rowoffs + stage * T::kRows, rp, c, last, luma,
                        luma + T::kRows * kPlanePitch);
  };
  const auto restage = [&](uint32_t t) {  // tile t + kZzStages, into the stage tile t took
    next_tile<MODE>(ahead, n_mcu_x, n_mcu_y);
    if (tid < 32 && t + kZzStages < count) {
      const int ns = static_cast<int>(t % kZzStages);
      stage_rows<MODE>(imgs, h, w, c, ahead, sm + lay.raw + ns * stage_bytes, rowoffs + ns * T::kRows, bars + ns);
    }
  };
  convert(0, conv);
  __syncthreads();
  restage(0);
  for (uint32_t i = 0; i < count; ++i) {
    float* ot = otile + (i & 1) * (T::kBlocks * 64);
    // the passes of tile i
    const uint8_t* src8 = sm + src + (i & 1) * lay.plane_bytes;
    float v[8];
    if (kSums && sl.plane > 0) {
      zz_chroma_row<MODE>(src8, v);
    } else {
      const uint2 s = *reinterpret_cast<const uint2*>(src8);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = shifted_byte(k < 4 ? s.x : s.y, k & 3);
    }
    aan_1d<1>(v);
#pragma unroll
    for (int k = 0; k < 8; ++k) blk[9 * j + k] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = blk[9 * k + j];
    aan_1d<1>(v);
    if (sl.mcu < p.n_mcus) {
#pragma unroll
      for (int k = 0; k < 8; ++k) ot[zo[k]] = v[k];
    }
    // the conversion of tile i + 1
    next_tile<MODE>(conv, n_mcu_x, n_mcu_y);
    if (i + 1 < count) convert(i + 1, conv);
    // tile i - 1's bulk copy has read the other tile buffer, tile i + 1's
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the tile, to the bulk copy
    __syncthreads();  // tile i is in ot, tile i + 1 in its planes, stage (i + 1) % kZzStages is free
    if (tid == 0) {
      // the tile's blocks are one contiguous range of the scan order
      const int64_t first_block = p.img * nblocks + (p.my * n_mcu_x + p.mx0) * T::kBpm;
      bulk_store(out + first_block * 64, ot, p.n_mcus * T::kBpm * 64 * 4);
    }
    next_tile<MODE>(p, n_mcu_x, n_mcu_y);
    restage(i + 1);
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

constexpr int kAanThreads = 256;
constexpr int kAanBlocks = kAanThreads / 8;  // blocks a CTA takes at a time, eight lanes each

// The standalone DCT over groups of kAanBlocks blocks, a grid-stride loop.
__global__ void __launch_bounds__(kAanThreads) dct8x8_aan_kernel(const float* __restrict__ in,
                                                                float* __restrict__ out, int64_t n) {
  __shared__ float tile[kAanBlocks * kBlockPitch];
  const int slot = threadIdx.x >> 3, j = threadIdx.x & 7;
  float* blk = tile + slot * kBlockPitch;
  // lane j stores the block's floats 4j.. and 32 + 4j..: rows j / 2 and
  // 4 + j / 2 from column 4 (j & 1)
  const int o = 9 * (j >> 1) + 4 * (j & 1);
  for (int64_t g = blockIdx.x; g * kAanBlocks < n; g += gridDim.x) {
    const int64_t b = g * kAanBlocks + slot;
    float v[8];
    if (b < n) {
      const float4* src = reinterpret_cast<const float4*>(in + b * 64 + 8 * j);
      const float4 lo = src[0], hi = src[1];
      v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
      v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = 0.0f;
    }
    aan_1d<1>(v);
#pragma unroll
    for (int k = 0; k < 8; ++k) blk[9 * j + k] = v[k];
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = blk[9 * k + j];
    aan_1d<1>(v);
#pragma unroll
    for (int k = 0; k < 8; ++k) blk[9 * k + j] = v[k];
    __syncwarp();
    if (b < n) {
      float4* dst = reinterpret_cast<float4*>(out + b * 64);
      dst[j] = make_float4(blk[o], blk[o + 1], blk[o + 2], blk[o + 3]);
      dst[8 + j] = make_float4(blk[o + 36], blk[o + 37], blk[o + 38], blk[o + 39]);
    }
    __syncwarp();  // the block is read before the next group's row pass writes it
  }
}

constexpr int kMaxChannels = 16;  // a tile's raw stages then take at most 133 KB
constexpr int kMaxDevices = 64;

// Sets KERNEL's shared-memory limit where `smem` passes 48 KB, then gives
// the CTAs of `threads` that fit on one SM.
template <typename KERNEL>
cudaError_t occupancy(KERNEL kernel, int threads, int smem, int* per_sm) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

// CTAs of coeffs_kernel<MODE> (raw false) or dct_zz_kernel<MODE> (raw true)
// that fit on one SM at c channels.
template <int MODE>
cudaError_t ctas_per_sm(int c, bool raw, int* per_sm) {
  return raw ? occupancy(dct_zz_kernel<MODE>, Tile<MODE>::kThreads, zz_smem_bytes<MODE>(c), per_sm)
             : occupancy(coeffs_kernel<MODE>, Tile<MODE>::kThreads, coeffs_smem<MODE>(c).total, per_sm);
}

// The CTAs a launch of the coefficient kernel (raw false: its occupancy) or
// of dct_zz_kernel (raw true: its occupancy, at most zz_plan_ctas) keeps on
// the current card at c channels, queried once a device, mode and channel
// count.
template <int MODE>
cudaError_t resident_ctas(int c, bool raw, int* ctas) {
  static int resident[2][kMaxDevices][kMaxChannels + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int& cached = resident[raw][dev][c];
  if (cached == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = ctas_per_sm<MODE>(c, raw, &per_sm);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if (raw) per_sm = per_sm < zz_plan_ctas<MODE>() ? per_sm : zz_plan_ctas<MODE>();
    cached = sms * per_sm;
  }
  *ctas = cached;
  return cudaSuccess;
}

template <int MODE>
cudaError_t launch_coeffs(const uint8_t* imgs, int64_t batch, int64_t h, int64_t w, int c,
                          const QTables* qt, void* out, cudaStream_t s) {
  using T = Tile<MODE>;
  const int64_t n_mcu_x = (w + T::kMcuW - 1) / T::kMcuW, n_mcu_y = (h + T::kRows - 1) / T::kRows;
  const int64_t n_tiles_x = (n_mcu_x + T::kMcus - 1) / T::kMcus;
  const int64_t tiles_per_img = n_tiles_x * n_mcu_y;
  if (c > kMaxChannels || batch * tiles_per_img > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const bool raw = qt == nullptr;
  int ctas = 0;
  const cudaError_t err = resident_ctas<MODE>(c, raw, &ctas);
  if (err != cudaSuccess) return err;
  const int64_t n_tiles = batch * tiles_per_img;
  const unsigned grid = static_cast<unsigned>(n_tiles < ctas ? n_tiles : ctas);
  const int64_t nblocks = n_mcu_x * n_mcu_y * T::kBpm;
  if (raw)
    dct_zz_kernel<MODE><<<grid, T::kThreads, zz_smem_bytes<MODE>(c), s>>>(
        imgs, h, w, c, n_mcu_x, static_cast<uint32_t>(n_tiles_x), static_cast<uint32_t>(tiles_per_img),
        static_cast<uint32_t>(n_tiles), nblocks, static_cast<float*>(out));
  else
    coeffs_kernel<MODE><<<grid, T::kThreads, coeffs_smem<MODE>(c).total, s>>>(
        imgs, h, w, c, n_mcu_x, static_cast<uint32_t>(n_tiles_x), static_cast<uint32_t>(tiles_per_img),
        static_cast<uint32_t>(n_tiles), nblocks, *qt, static_cast<int16_t*>(out));
  return cudaGetLastError();
}

// Runs launch_coeffs<mode>; qt null launches dct_zz_kernel.
cudaError_t launch_mode(int mode, const uint8_t* imgs, int64_t batch, int64_t h, int64_t w, int c,
                        const QTables* qt, void* out, cudaStream_t s) {
  switch (mode) {
    case kGray: return launch_coeffs<kGray>(imgs, batch, h, w, c, qt, out, s);
    case k444: return launch_coeffs<k444>(imgs, batch, h, w, c, qt, out, s);
    case k420: return launch_coeffs<k420>(imgs, batch, h, w, c, qt, out, s);
    case k422: return launch_coeffs<k422>(imgs, batch, h, w, c, qt, out, s);
    default: return cudaErrorInvalidValue;
  }
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
  return static_cast<int>(launch_mode(mode, imgs, batch, h, w, c, &qt, out, static_cast<cudaStream_t>(stream)));
}

// The f32 zigzag DCT: imgs as pixo_coeffs takes them; out: [batch, nblocks,
// 64] f32 on the device, 16-byte aligned.
int pixo_dct_zz(const uint8_t* imgs, int64_t batch, int64_t h, int64_t w, int32_t c, int32_t mode,
                float* out, void* stream) {
  using namespace pixo;
  if (batch <= 0 || h <= 0 || w <= 0 || c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_mode(mode, imgs, batch, h, w, c, nullptr, out, static_cast<cudaStream_t>(stream)));
}

// CTAs of the coefficient kernel (raw = 0) or of dct_zz_kernel (raw = 1) an
// SM holds at c channels, into *per_sm. Returns the CUDA error.
int pixo_coeffs_ctas_per_sm(int32_t mode, int32_t c, int32_t raw, int32_t* per_sm) {
  using namespace pixo;
  if (c <= 0 || c > kMaxChannels) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kGray: return static_cast<int>(ctas_per_sm<kGray>(c, raw != 0, per_sm));
    case k444: return static_cast<int>(ctas_per_sm<k444>(c, raw != 0, per_sm));
    case k420: return static_cast<int>(ctas_per_sm<k420>(c, raw != 0, per_sm));
    case k422: return static_cast<int>(ctas_per_sm<k422>(c, raw != 0, per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// in/out: [n, 8, 8] f32 on the device, 16-byte aligned.
int pixo_dct8x8_aan(const float* in, float* out, int64_t n, void* stream) {
  using namespace pixo;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static int resident[kMaxDevices];  // CTAs the card holds at once
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = occupancy(dct8x8_aan_kernel, kAanThreads, 0, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  const int64_t groups = (n + kAanBlocks - 1) / kAanBlocks;
  const unsigned grid = static_cast<unsigned>(groups < resident[dev] ? groups : resident[dev]);
  dct8x8_aan_kernel<<<grid, kAanThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* pixo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
