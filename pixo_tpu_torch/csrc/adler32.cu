// Adler-32 on the card, for Hopper (sm_90a).
//
// Replaces the JAX package's compress/checksums.py::adler32_jnp (:89), whose
// 2048-byte chunk sums and weighted sums are carried by a lax.scan. No path
// of either package calls it: it is the device counterpart of zlib's
// adler32 and equals it bit for bit.
//
// A run of m bytes d[0..m) acts on the state (a, b) as a <- a + s and
// b <- b + m * a + w, with s = sum d[i] and w = sum (m - i) * d[i], all mod
// 65521. Two runs in order combine as s = s1 + s2, w = w1 + w2 + m2 * s1,
// m = m1 + m2, an associative (not commutative) operation, so the stream
// reduces as a tree in order:
//
// - adler_segments_kernel: a CTA a 16 KiB segment, a thread 64 contiguous
//   bytes (four 16-byte loads), whose s and w come from byte dot products
//   (__dp4a with 1s and with the weights 0..3); the threads combine in order
//   by shuffles down the warp, then thread 0 combines the warps in order.
// - adler_combine_kernel: one CTA combines the segments in order, 256 at a
//   time, and applies the whole to the start value.
//
// What bounds it: the bytes, read once (16 MiB in 5 us at 3.35 TB/s); the
// segments' triples are 12 bytes each.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kAdlerThreads = 256;
constexpr int kAdlerBytes = 64;  // a thread's contiguous bytes
constexpr int64_t kAdlerSegment = kAdlerThreads * kAdlerBytes;
constexpr uint32_t kAdlerMod = 65521;

struct Run {
  uint32_t s, w, m;  // each mod 65521
};

__device__ __forceinline__ Run combine(Run l, Run r) {
  return {(l.s + r.s) % kAdlerMod,
          static_cast<uint32_t>((static_cast<uint64_t>(l.w) + r.w + static_cast<uint64_t>(r.m) * l.s) % kAdlerMod),
          (l.m + r.m) % kAdlerMod};
}

// The runs of a CTA's threads combined in thread order; the result in thread 0.
__device__ Run combine_block(Run v) {
  __shared__ Run warps[kAdlerThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {  // lane L (a multiple of 2 off) holds [L, L + 2 off)
    Run r;
    r.s = __shfl_down_sync(0xffffffffu, v.s, off);
    r.w = __shfl_down_sync(0xffffffffu, v.w, off);
    r.m = __shfl_down_sync(0xffffffffu, v.m, off);
    if (lane + off < 32) v = combine(v, r);
  }
  if (lane == 0) warps[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kAdlerThreads / 32; w++) v = combine(v, warps[w]);
  __syncthreads();
  return v;
}

// The s and w of the 4 bytes of word x at offset q from the start of a run
// of len bytes: weights len - q - b for byte b.
__device__ __forceinline__ void add_word(uint32_t x, int q, int len, int& s, int& w) {
  const int sum = static_cast<int>(__dp4a(x, 0x01010101u, 0u));
  s += sum;
  w += (len - q) * sum - static_cast<int>(__dp4a(x, 0x03020100u, 0u));
}

__global__ void __launch_bounds__(kAdlerThreads) adler_segments_kernel(const uint8_t* __restrict__ d,
                                                                      int64_t n, Run* __restrict__ segs) {
  const int64_t start = blockIdx.x * kAdlerSegment + static_cast<int64_t>(threadIdx.x) * kAdlerBytes;
  const int len = start >= n ? 0 : (n - start < kAdlerBytes ? static_cast<int>(n - start) : kAdlerBytes);
  int s = 0, w = 0;  // at most 255 * 64 * 65 / 2 for w
  if (len == kAdlerBytes) {
    const uint4* p = reinterpret_cast<const uint4*>(d + start);
    uint4 v[kAdlerBytes / 16];
#pragma unroll
    for (int i = 0; i < kAdlerBytes / 16; i++) v[i] = __ldg(p + i);
#pragma unroll
    for (int i = 0; i < kAdlerBytes / 16; i++) {
      add_word(v[i].x, 16 * i, len, s, w);
      add_word(v[i].y, 16 * i + 4, len, s, w);
      add_word(v[i].z, 16 * i + 8, len, s, w);
      add_word(v[i].w, 16 * i + 12, len, s, w);
    }
  } else {
    for (int i = 0; i < len; i++) {
      s += d[start + i];
      w += (len - i) * d[start + i];
    }
  }
  const Run r = combine_block({static_cast<uint32_t>(s) % kAdlerMod, static_cast<uint32_t>(w) % kAdlerMod,
                               static_cast<uint32_t>(len)});
  if (threadIdx.x == 0) segs[blockIdx.x] = r;
}

__global__ void __launch_bounds__(kAdlerThreads) adler_combine_kernel(const Run* __restrict__ segs,
                                                                     int64_t nsegs, uint32_t adler,
                                                                     uint32_t* __restrict__ out) {
  Run total = {0, 0, 0};
  for (int64_t base = 0; base < nsegs; base += kAdlerThreads) {
    const int64_t i = base + threadIdx.x;
    const Run part = combine_block(i < nsegs ? segs[i] : Run{0, 0, 0});
    if (threadIdx.x == 0) total = combine(total, part);
  }
  if (threadIdx.x == 0) {
    const uint64_t a0 = adler & 0xffffu, b0 = adler >> 16;
    const uint64_t a = (a0 + total.s) % kAdlerMod;
    const uint64_t b = (b0 + total.m * a0 + total.w) % kAdlerMod;
    *out = static_cast<uint32_t>((b << 16) | a);
  }
}

}  // namespace pixo

extern "C" {

// uint32 words of the scratch pixo_adler32 takes at n bytes: three a
// segment, then the result.
int64_t pixo_adler32_scratch_words(int64_t n) {
  using namespace pixo;
  return 3 * ((n + kAdlerSegment - 1) / kAdlerSegment) + 1;
}

// data: [n] uint8 on the device, n >= 1, 16-byte aligned; scratch:
// pixo_adler32_scratch_words(n) uint32 words, its last the checksum of data
// continued from adler.
int pixo_adler32(const uint8_t* data, int64_t n, uint32_t adler, uint32_t* scratch, void* stream) {
  using namespace pixo;
  if (n <= 0 || (reinterpret_cast<uintptr_t>(data) & 15)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t nsegs = (n + kAdlerSegment - 1) / kAdlerSegment;
  Run* segs = reinterpret_cast<Run*>(scratch);
  adler_segments_kernel<<<static_cast<unsigned>(nsegs), kAdlerThreads, 0, s>>>(data, n, segs);
  adler_combine_kernel<<<1, kAdlerThreads, 0, s>>>(segs, nsegs, adler, scratch + 3 * nsegs);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
