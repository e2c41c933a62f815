// Separable Lanczos3 resize kernel for Hopper (sm_90a).
//
// Replaces the jit-compiled _lanczos_pass pair of the JAX package's
// ops/resize_kernels.py (:154, under resize_lanczos3_batch :146); that
// package has no Pallas kernel for the resize and leaves the two passes to
// XLA as a lax.scan over the taps. For [batch, h, w, c] uint8 images and the
// tap tables of lanczos_taps for each axis (starts [dst] int32, weights
// [dst, k] f32, windows right-padded with zero weights to a k that is a
// multiple of 4) it computes the horizontal pass into a uint8 intermediate
// [batch, h, dst_w, c], then the vertical pass into [batch, dst_h, dst_w, c].
//
// What decides the bytes, and so the design: every output is a serial f32
// accumulation acc = acc + px * w over its window's taps in index order from
// +0.0, the source index clamped to the axis, then rounded half away from
// zero (roundf), clamped to 0..255 and stored as uint8; the intermediate
// between the passes is uint8 too (pixo resize.rs:459-513). A product with
// the dense weight matrix, a tree reduction over the taps or an FMA would
// round elsewhere, so one thread walks the taps of its outputs in order and
// the file is built with -fmad=false (the multiply and the add are written
// as __fmul_rn and __fadd_rn as well). A padded zero-weight tap adds +0.0,
// which changes no sum, so every window runs its table's full k taps.
//
// What bounds it on the card: the bytes it must move (the source read once,
// the result written once) are 0.0047 ms at a thumbnail chunk; the taps cost
// more in instruction throughput: a multiply and an add per tap and sample, which
// no reordering may merge, and the byte's conversion to f32. A byte becomes
// an f32 by a byte permute into 2^23's mantissa and an exact subtraction, or
// a half (into 1024's) once and then one half-to-f32 add; not through the
// conversion unit (a quarter of the f32 rate). The intermediate
// (batch * h * dst_w * c bytes, written by the first launch and read by the
// second) is this design's own traffic on top of the bound; it stays in the
// 50 MB L2 for a chunk of thumbnails. Two launches on one stream:
//
// - horizontal, tiled route: a thread block takes a tile of `cols` output
//   columns and walks groups of 4 * `quads` source rows. It stages the
//   tile's weights once, tap-major ([k][cols]: a tap is one conflict-free
//   shared-memory read a warp); it copies the tile's source span [min
//   start, max start + k) of each row of a group with 16-byte cp.async, the
//   next group's copy in flight while this one is computed, then lays it out
//   as 32-byte slots, one a source pixel, that hold the pixel's channels of
//   four rows as exact halves (each byte converted once): a thread takes one
//   output column of four rows and reads one slot and one weight a tap
//   (index clamping is done once, at the layout). It stores its C bytes of
//   each row from registers (staging them for word stores measured 5 us
//   slower at a thumbnail chunk on the H100: a barrier more a group).
//   `ops/kernels.py::resize_plan` picks `cols`, `quads` and the span's
//   room from the shape; a tile whose span outruns that room (a table whose
//   starts are not those of lanczos_taps) reads its pixels from global
//   memory instead, in the same order;
// - horizontal, direct route, where even one window does not fit in shared
//   memory: a thread block an output column, a thread a source row, the
//   weights a broadcast load;
// - vertical: a thread 16 consecutive bytes of an output row (4 or 1 where
//   the row's length does not allow 16), so a warp reads contiguous bytes of
//   each source row of its window and a tap's address is worked out once for
//   16 samples; the taps go in fours, each four's loads in flight during the
//   arithmetic of the four before.

#include <climits>
#include <cstdint>

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace pixo {

constexpr int kResizeThreads = 256;
// The dynamic shared memory a tile may take: the 227 KB a thread block may
// have on sm_90, less 1 KB for its static variables.
constexpr int kResizeMaxSmem = 232448 - 1024;

__host__ __device__ inline int64_t align16(int64_t x) { return (x + 15) & ~int64_t{15}; }

// The horizontal tile's shared memory, mirrored by ops/kernels.py::resize_smem:
// the weights [k][cols] f32, the slots [quads][span] of 32 bytes (two planes
// of 16, a pair of rows each; a plane is 2 slots longer than the span, so
// that the four planes of a layout step fall on different banks) and 4 *
// quads rows of the source span as copied (16-byte chunks from the one
// holding the span's first byte).
__host__ __device__ inline int64_t raw_stride(int64_t span, int c) { return align16(span * c + 32); }
__host__ __device__ inline int64_t tile_smem(int64_t cols, int64_t quads, int64_t span, int64_t k,
                                             int c) {
  return 4 * k * cols + 32 * quads * (span + 2) + 4 * quads * raw_stride(span, c);
}

// Where slot s of a row quad lies: the low 3 bits of its index are crossed
// with the next 3, so that the 8 threads of a 16-byte read phase, whose
// windows start `scale` slots apart, fall on distinct bank groups for a
// scale of 1, 2 or 4 (a span is a multiple of 8 slots).
__device__ __forceinline__ int slot_at(int s) { return s ^ ((s >> 3) & 7); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ uint8_t round_clamp_u8(float acc) {
  return static_cast<uint8_t>(fminf(fmaxf(roundf(acc), 0.0f), 255.0f));
}

// Byte `b` of `word` as an f32, exactly: the byte becomes the low mantissa
// bits of 2^23, and 2^23 is taken away again.
template <int B>
__device__ __forceinline__ float byte_f32(uint32_t word) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, 0x7540u | B)), 8388608.0f);
}

__device__ __forceinline__ float tap(float acc, float px, float w) {
  return __fadd_rn(acc, __fmul_rn(px, w));
}

// A pixel's C channels (a word, byte c channel c) as four exact halves: the
// byte becomes the low mantissa bits of 1024 and 1024 is taken away again.
__device__ __forceinline__ uint2 pixel_halves(uint32_t word) {
  const uint32_t lo = __byte_perm(word, 0x64006400u, 0x7150u);  // 0x64 b1 0x64 b0
  const uint32_t hi = __byte_perm(word, 0x64006400u, 0x7352u);  // 0x64 b3 0x64 b2
  const __half2 k1024 = __float2half2_rn(1024.0f);
  const __half2 l = __hsub2(*reinterpret_cast<const __half2*>(&lo), k1024);
  const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&hi), k1024);
  return make_uint2(*reinterpret_cast<const uint32_t*>(&l), *reinterpret_cast<const uint32_t*>(&h));
}

__device__ __forceinline__ float half_lo(uint32_t pair) {
  return __low2float(*reinterpret_cast<const __half2*>(&pair));
}

__device__ __forceinline__ float half_hi(uint32_t pair) {
  return __high2float(*reinterpret_cast<const __half2*>(&pair));
}

// One tap of one row: `c01` and `c23` hold its channels as halves.
template <int C>
__device__ __forceinline__ void tap_row(float (&acc)[C], uint32_t c01, uint32_t c23, float w) {
  acc[0] = tap(acc[0], half_lo(c01), w);
  if (C > 1) acc[1 % C] = tap(acc[1 % C], half_hi(c01), w);
  if (C > 2) acc[2 % C] = tap(acc[2 % C], half_lo(c23), w);
  if (C > 3) acc[3 % C] = tap(acc[3 % C], half_hi(c23), w);
}

// One tap of four rows: plane `a` holds rows 0 and 1, plane `b` rows 2 and 3.
template <int C>
__device__ __forceinline__ void tap_slot(float (&acc)[4][C], uint4 a, uint4 b, float w) {
  tap_row<C>(acc[0], a.x, a.y, w);
  tap_row<C>(acc[1], a.z, a.w, w);
  tap_row<C>(acc[2], b.x, b.y, w);
  tap_row<C>(acc[3], b.z, b.w, w);
}

// Pixel `p` (clamped to the row) of `row`, C channels packed into a word.
template <int C>
__device__ __forceinline__ uint32_t pixel_word(const uint8_t* row, int p, int w) {
  const uint8_t* q = row + static_cast<int64_t>(min(max(p, 0), w - 1)) * C;
  uint32_t word = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) word |= static_cast<uint32_t>(__ldg(q + c)) << (8 * c);
  return word;
}

// src: [rows, w, C] (rows = batch * h), `src_end` one past its last byte;
// out: [rows, dw, C]. Grid: x the column tiles, y the row groups (each block
// `groups_per_block` groups of 4 * quads rows). Block: cols * quads threads.
// The copy of group g + 1's rows is in flight while group g is computed.
template <int C>
__global__ void __launch_bounds__(kResizeThreads) resize_lanczos3_h_kernel(
    const uint8_t* __restrict__ src, const uint8_t* src_end, int64_t rows, int w,
    const int32_t* __restrict__ starts, const float* __restrict__ weights, int k, int dw,
    int cols, int quads, int span_cap, int64_t groups_per_block, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group_rows = 4 * quads;
  const int rstride = static_cast<int>(raw_stride(span_cap, C));
  float* ws = reinterpret_cast<float*>(smem);
  uint4* slots = reinterpret_cast<uint4*>(smem + 4 * k * cols);
  const int plane = span_cap + 2;  // slots a plane
  uint8_t* raw = smem + 4 * k * cols + 32 * quads * plane;
  __shared__ int s_lo, s_hi;

  const int nthreads = cols * quads, tid = threadIdx.x;
  const int j = tid % cols, q = tid / cols;
  const int j0 = blockIdx.x * cols, ncols = min(cols, dw - j0);

  // The tile's weights, tap-major: read as the contiguous [ncols][k] block.
  for (int e = tid; e < ncols * k; e += nthreads) {
    const int jl = e / k;
    ws[(e - jl * k) * cols + jl] = __ldg(weights + static_cast<int64_t>(j0) * k + e);
  }
  if (tid == 0) {
    s_lo = INT_MAX;
    s_hi = INT_MIN;
  }
  __syncthreads();
  const int start = j < ncols ? __ldg(starts + j0 + j) : INT_MAX;
  if (tid < cols) {  // the tile's span over its starts, whatever their order
    const int lo = __reduce_min_sync(0xFFFFFFFFu, start);
    const int hi = __reduce_max_sync(0xFFFFFFFFu, j < ncols ? start : INT_MIN);
    if ((tid & 31) == 0) {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
  }
  __syncthreads();
  const int lo = s_lo;
  const int64_t span = static_cast<int64_t>(s_hi) + k - lo;
  const bool staged = span <= span_cap;
  // the pixels of a row that the span holds, clamped to the row
  const int pl = max(lo, 0);
  const int ph = static_cast<int>(min(static_cast<int64_t>(lo) + span, static_cast<int64_t>(w)));
  const int row_bytes = (ph - pl) * C;
  const int chunks = (15 + row_bytes + 15) >> 4;  // 16-byte chunks that cover a row's span

  // this thread's row of a group in the slot layout, and its first slot
  const int lay_row = tid & (group_rows - 1);
  const int s_first = tid >> (31 - __clz(group_rows)), s_step = nthreads / group_rows;

  const int64_t groups = (rows + group_rows - 1) / group_rows;
  const int64_t g0 = blockIdx.y * groups_per_block;
  const int64_t g_end = min(groups, g0 + groups_per_block);

  // Starts the copy of group g's spans: 16-byte chunks, aligned in memory,
  // from the one that holds a row's first span byte; a chunk that reaches
  // past the tensor is copied byte by byte. Bytes outside a row's span are
  // not read again.
  auto stage = [&](int64_t g) {
    const int64_t r0 = g * group_rows;
    const int nrows = static_cast<int>(min(static_cast<int64_t>(group_rows), rows - r0));
    for (int e = tid; e < nrows * chunks; e += nthreads) {
      const int kk = e / chunks, ci = e - kk * chunks;
      const uint8_t* first = src + ((r0 + kk) * w + pl) * C;
      const uint8_t* a = first - (reinterpret_cast<uintptr_t>(first) & 15) + 16 * ci;
      uint8_t* d = raw + kk * rstride + 16 * ci;
      if (a >= src && a + 16 <= src_end) {
        cp_async16(d, a);
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) d[b] = a + b >= src && a + b < src_end ? a[b] : 0;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (staged && g0 < g_end) stage(g0);

  for (int64_t g = g0; g < g_end; ++g) {
    const int64_t r0 = g * group_rows;
    const int nrows = static_cast<int>(min(static_cast<int64_t>(group_rows), rows - r0));
    float acc[4][C];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;

    if (staged) {
      asm volatile("cp.async.wait_group 0;\n" ::);
      __syncthreads();
      // The slots: slot s of quad r / 4 holds pixel clamp(lo + s) of its four
      // rows as halves, each byte converted once. A thread keeps one row
      // (cols is a multiple of 4) and walks its slots; the slots of rows past
      // the tensor are left as they are.
      if (lay_row < nrows) {
        const uint8_t* first = src + ((r0 + lay_row) * w + pl) * C;
        const uint8_t* b = raw + lay_row * rstride + (reinterpret_cast<uintptr_t>(first) & 15) - pl * C;
        uint2* dst = reinterpret_cast<uint2*>(slots + (lay_row >> 1) * plane) + (lay_row & 1);
        for (int s = s_first; s < span; s += s_step) {
          const uint8_t* px = b + min(max(lo + s, 0), w - 1) * C;
          uint32_t word = 0;
#pragma unroll
          for (int c = 0; c < C; ++c) word |= static_cast<uint32_t>(px[c]) << (8 * c);
          dst[slot_at(s) * 2] = pixel_halves(word);
        }
      }
      __syncthreads();
      if (g + 1 < g_end) stage(g + 1);  // the copies are laid out: the next group's may start
      if (j < ncols) {
        const uint4* pa = slots + 2 * q * plane;  // rows 0 and 1 of the quad
        const uint4* pb = pa + plane;  // rows 2 and 3
        const int first = start - lo;
        for (int i = 0; i < k; i += 4) {
          uint4 a[4], b[4];
          float wv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int at = slot_at(first + i + u);
            a[u] = pa[at];
            b[u] = pb[at];
            wv[u] = ws[(i + u) * cols + j];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) tap_slot<C>(acc, a[u], b[u], wv[u]);
        }
      }
    } else if (j < ncols) {
      // The span outruns the plan's room: the same taps, pixels from global memory.
      const uint8_t* row[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) row[r] = src + min(r0 + 4 * q + r, rows - 1) * w * C;
      for (int i = 0; i < k; ++i) {
        const uint2 h0 = pixel_halves(pixel_word<C>(row[0], start + i, w));
        const uint2 h1 = pixel_halves(pixel_word<C>(row[1], start + i, w));
        const uint2 h2 = pixel_halves(pixel_word<C>(row[2], start + i, w));
        const uint2 h3 = pixel_halves(pixel_word<C>(row[3], start + i, w));
        tap_slot<C>(acc, make_uint4(h0.x, h0.y, h1.x, h1.y), make_uint4(h2.x, h2.y, h3.x, h3.y),
                    ws[i * cols + j]);
      }
    }

    // The results from registers: the C bytes of each of four rows.
    if (j < ncols) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (4 * q + r >= nrows) break;
        uint8_t* o = out + ((r0 + 4 * q + r) * dw + j0 + j) * C;
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = round_clamp_u8(acc[r][c]);
      }
    }
  }
}

// The direct route: src [rows, w, C]; out [rows, dw, C]. Grid: x the output
// columns, y the rows in blocks of kResizeThreads.
template <int C>
__global__ void __launch_bounds__(kResizeThreads) resize_lanczos3_h_direct_kernel(
    const uint8_t* __restrict__ src, int64_t rows, int w, const int32_t* __restrict__ starts,
    const float* __restrict__ weights, int k, int dw, uint8_t* __restrict__ out) {
  const int jj = blockIdx.x;
  const int64_t r = static_cast<int64_t>(blockIdx.y) * kResizeThreads + threadIdx.x;
  if (r >= rows) return;
  const uint8_t* row = src + r * w * C;
  const float4* wr = reinterpret_cast<const float4*>(weights + static_cast<int64_t>(jj) * k);
  const int start = __ldg(starts + jj);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int i = 0; i < k; i += 4) {
    const float4 w4 = __ldg(wr + i / 4);
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
    uint32_t px[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) px[u] = pixel_word<C>(row, start + i + u, w);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      acc[0] = tap(acc[0], byte_f32<0>(px[u]), wv[u]);
      if (C > 1) acc[1 % C] = tap(acc[1 % C], byte_f32<1>(px[u]), wv[u]);
      if (C > 2) acc[2 % C] = tap(acc[2 % C], byte_f32<2>(px[u]), wv[u]);
      if (C > 3) acc[3 % C] = tap(acc[3 % C], byte_f32<3>(px[u]), wv[u]);
    }
  }
  uint8_t* o = out + (r * dw + jj) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = round_clamp_u8(acc[c]);
}

// V bytes of a source row from `p`: one load of V bytes (V = 1, 4 or 16).
template <int V>
struct Granule {
  uint32_t w[V / 4 > 0 ? V / 4 : 1];
  __device__ __forceinline__ void load(const uint8_t* p) {
    if (V == 16) {
      const uint4 g = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = g.x, w[V / 4 > 1 ? 1 : 0] = g.y, w[V / 4 > 2 ? 2 : 0] = g.z, w[V / 4 > 3 ? 3 : 0] = g.w;
    } else if (V == 4) {
      w[0] = __ldg(reinterpret_cast<const uint32_t*>(p));
    } else {
      w[0] = __ldg(p);
    }
  }
};

// src: [batch, h, n] (n = dw * c bytes a row); out: [batch, dh, n]. A thread
// takes V consecutive bytes of an output row (V = 16 or 4 needs n % V == 0
// and both buffers V-byte aligned). k is a multiple of 4 and the weights are
// 16-byte aligned: the taps go in fours, each four's loads started before the
// arithmetic of the four before it.
template <int V>
__global__ void __launch_bounds__(kResizeThreads) resize_lanczos3_v_kernel(
    const uint8_t* __restrict__ src, int64_t batch, int h, int64_t n,
    const int32_t* __restrict__ starts, const float* __restrict__ weights, int k, int dh,
    uint8_t* __restrict__ out) {
  constexpr int W = V / 4 > 0 ? V / 4 : 1;  // words a granule
  const int64_t per_row = n / V;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kResizeThreads + threadIdx.x;
  if (t >= batch * dh * per_row) return;
  // 32-bit divisions where they do: a 64-bit one is a subroutine of some 70 instructions
  int64_t r, col, img;
  if (t <= 0xFFFFFFFFll) {
    const uint32_t t32 = static_cast<uint32_t>(t), pr = static_cast<uint32_t>(per_row);
    const uint32_t r32 = t32 / pr;
    r = r32;
    col = t32 - r32 * pr;
    img = r32 / static_cast<uint32_t>(dh);
  } else {
    r = t / per_row;
    col = t - r * per_row;
    img = r / dh;
  }
  col *= V;
  const int dy = static_cast<int>(r - img * dh);
  const uint8_t* base = src + img * h * n + col;
  const float4* wr = reinterpret_cast<const float4*>(weights + static_cast<int64_t>(dy) * k);
  const int start = __ldg(starts + dy);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  Granule<V> px[4];
  float4 w4 = __ldg(wr);
#pragma unroll
  for (int u = 0; u < 4; ++u) px[u].load(base + static_cast<int64_t>(min(max(start + u, 0), h - 1)) * n);
  for (int i = 0; i < k; i += 4) {
    const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
    Granule<V> cur[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cur[u] = px[u];
    if (i + 4 < k) {  // the next four taps' loads, in flight during this four's arithmetic
      w4 = __ldg(wr + i / 4 + 1);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        px[u].load(base + static_cast<int64_t>(min(max(start + i + 4 + u, 0), h - 1)) * n);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int m = 0; m < W; ++m) {
        const uint32_t word = cur[u].w[m];
        acc[4 * m] = tap(acc[4 * m], byte_f32<0>(word), wv[u]);
        if (V >= 4) {
          acc[(4 * m + 1) % V] = tap(acc[(4 * m + 1) % V], byte_f32<1>(word), wv[u]);
          acc[(4 * m + 2) % V] = tap(acc[(4 * m + 2) % V], byte_f32<2>(word), wv[u]);
          acc[(4 * m + 3) % V] = tap(acc[(4 * m + 3) % V], byte_f32<3>(word), wv[u]);
        }
      }
    }
  }
  uint8_t* o = out + r * n + col;
  if (V >= 4) {
    uint32_t words[W];
#pragma unroll
    for (int m = 0; m < W; ++m) {
      words[m] = 0;
#pragma unroll
      for (int v = 0; v < 4; ++v)
        words[m] |= static_cast<uint32_t>(round_clamp_u8(acc[(4 * m + v) % V])) << (8 * v);
    }
    if (V == 16)
      *reinterpret_cast<uint4*>(o) = make_uint4(words[0], words[W > 1 ? 1 : 0], words[W > 2 ? 2 : 0],
                                                 words[W > 3 ? 3 : 0]);
    else
      *reinterpret_cast<uint32_t*>(o) = words[0];
  } else {
    o[0] = round_clamp_u8(acc[0]);
  }
}

inline bool grid_for(int64_t threads, unsigned* blocks) {
  const int64_t b = (threads + kResizeThreads - 1) / kResizeThreads;
  if (b < 1 || b > 0x7FFFFFFF) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

// The thread blocks of a tile of `threads` threads and `smem` bytes that the
// card keeps in flight at once (its SMs times the blocks an SM holds),
// looked up once per size.
template <int C>
cudaError_t resident_blocks(int threads, int64_t smem, int64_t* blocks) {
  static int dev_sms = 0, last_threads = 0;
  static int64_t last_smem = -1, last_blocks = 0;
  cudaError_t err;
  if (dev_sms == 0) {
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    dev_sms = sms;
  }
  if (smem != last_smem || threads != last_threads) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resize_lanczos3_h_kernel<C>,
                                                        threads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    last_smem = smem;
    last_threads = threads;
    last_blocks = static_cast<int64_t>(dev_sms) * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = last_blocks;
  return cudaSuccess;
}

template <int C>
cudaError_t launch_horizontal(const uint8_t* in, int64_t total, int64_t rows, int w,
                              const int32_t* sxp, const float* wxp, int kx, int dw, int cols,
                              int quads, int span, uint8_t* mid, cudaStream_t s) {
  if (cols == 0) {  // the direct route
    const int64_t yb = (rows + kResizeThreads - 1) / kResizeThreads;
    if (yb > 65535) return cudaErrorInvalidValue;
    resize_lanczos3_h_direct_kernel<C><<<dim3(dw, static_cast<unsigned>(yb)), kResizeThreads, 0, s>>>(
        in, rows, w, sxp, wxp, kx, dw, mid);
    return cudaGetLastError();
  }
  const int64_t smem = tile_smem(cols, quads, span, kx, C);
  const int threads = cols * quads;
  const int64_t groups = (rows + 4 * quads - 1) / (4 * quads);
  const int64_t tiles = (dw + cols - 1) / cols;
  cudaError_t err;
  if (smem > 48 * 1024 &&  // above the default, asked for at each launch of such a tile
      (err = cudaFuncSetAttribute(resize_lanczos3_h_kernel<C>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  int64_t target;
  if ((err = resident_blocks<C>(threads, smem, &target)) != cudaSuccess) return err;
  int64_t per_block = (groups * tiles + target - 1) / target;  // one wave of blocks
  per_block = per_block > (groups + 65534) / 65535 ? per_block : (groups + 65534) / 65535;
  const int64_t yb = (groups + per_block - 1) / per_block;
  resize_lanczos3_h_kernel<C><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(yb)), threads,
                                static_cast<size_t>(smem), s>>>(
      in, in + total, rows, w, sxp, wxp, kx, dw, cols, quads, span, per_block, mid);
  return cudaGetLastError();
}

}  // namespace pixo

extern "C" {

// src: [batch, h, w, c] uint8 on the device, c 1 to 4, at any byte offset.
// sx [dw] int32 and wx [dw, kx] f32, sy [dh] int32 and wy [dh, ky] f32: the
// tap tables of each axis on the device, kx and ky multiples of 4, the
// weights 16-byte aligned. tmp: [batch, h, dw, c] uint8 scratch; out:
// [batch, dh, dw, c] uint8; both on the device. cols, quads, span: the
// horizontal pass's tile (ops/kernels.py::resize_plan; cols 0 takes the
// direct route). Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for a shape or plan it does not take.
int pixo_resize_lanczos3(const void* src, int64_t batch, int64_t h, int64_t w, int32_t c,
                         const void* sx, const void* wx, int32_t kx, int64_t dw, const void* sy,
                         const void* wy, int32_t ky, int64_t dh, void* tmp, void* out,
                         int32_t cols, int32_t quads, int32_t span, void* stream) {
  using namespace pixo;
  const int64_t limit = 1 << 24;  // resize.py's MAX_RESIZE_DIMENSION: indices stay in int32
  if (batch < 1 || h < 1 || w < 1 || dw < 1 || dh < 1 || kx < 4 || ky < 4 || kx % 4 ||
      ky % 4 || c < 1 || c > 4 || h > limit || w > limit || dw > limit || dh > limit ||
      reinterpret_cast<uintptr_t>(wx) % 16 || reinterpret_cast<uintptr_t>(wy) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cols != 0 && (!(cols == 32 || cols == 64 || cols == 128) ||
                    !(quads == 1 || quads == 2 || quads == 4 || quads == 8) ||
                    cols * quads > kResizeThreads || span < kx || span % 8 ||
                    tile_smem(cols, quads, span, kx, c) > kResizeMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* mid = static_cast<uint8_t*>(tmp);
  uint8_t* res = static_cast<uint8_t*>(out);
  const int32_t* sxp = static_cast<const int32_t*>(sx);
  const int32_t* syp = static_cast<const int32_t*>(sy);
  const float* wxp = static_cast<const float*>(wx);
  const float* wyp = static_cast<const float*>(wy);

  const int64_t rows = batch * h, total = rows * w * c;
  const int wi = static_cast<int>(w), dwi = static_cast<int>(dw);
  cudaError_t err;
  switch (c) {
    case 1:
      err = launch_horizontal<1>(in, total, rows, wi, sxp, wxp, kx, dwi, cols, quads, span, mid, s);
      break;
    case 2:
      err = launch_horizontal<2>(in, total, rows, wi, sxp, wxp, kx, dwi, cols, quads, span, mid, s);
      break;
    case 3:
      err = launch_horizontal<3>(in, total, rows, wi, sxp, wxp, kx, dwi, cols, quads, span, mid, s);
      break;
    default:
      err = launch_horizontal<4>(in, total, rows, wi, sxp, wxp, kx, dwi, cols, quads, span, mid, s);
      break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t n = dw * c;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(mid) | reinterpret_cast<uintptr_t>(res);
  const int v = n % 16 == 0 && aligned % 16 == 0 ? 16 : n % 4 == 0 && aligned % 4 == 0 ? 4 : 1;
  unsigned blocks;
  if (!grid_for(batch * dh * (n / v), &blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const int hi = static_cast<int>(h), dhi = static_cast<int>(dh);
  if (v == 16)
    resize_lanczos3_v_kernel<16><<<blocks, kResizeThreads, 0, s>>>(mid, batch, hi, n, syp, wyp, ky, dhi, res);
  else if (v == 4)
    resize_lanczos3_v_kernel<4><<<blocks, kResizeThreads, 0, s>>>(mid, batch, hi, n, syp, wyp, ky, dhi, res);
  else
    resize_lanczos3_v_kernel<1><<<blocks, kResizeThreads, 0, s>>>(mid, batch, hi, n, syp, wyp, ky, dhi, res);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
