// Device PNG unfilter, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/png_unfilter.py::unfilter_device_batch
// (:29), a jit lax.scan over the anti-diagonal wavefront; it has no Pallas
// kernel. No path of either package calls it: the PNG decode reconstructs
// its rows with the host library's png_unfilter, which it equals bit for
// bit.
//
// Byte (y, x) needs a = out(y, x - bpp), b = out(y - 1, x) and
// c = out(y - 1, x - bpp) (0 outside the image), then out = raw + pred mod
// 256 with pred by the row's filter: 0, a, b, (a + b) >> 1 on the unwrapped
// bytes, or Paeth (ties to a, then b, then c). Ids outside 0-4 take no
// predictor, as in the JAX function.
//
// Design: a thread a row, a CTA an image. Each row runs one step behind the
// row above: at step t, thread r of a band reconstructs byte x = t - r of
// its row, so the byte above, out(y - 1, x), was made by thread r - 1 at step
// t - 1. A row's last bpp outputs, and the last bpp bytes it read from the
// row above (c is the b of bpp steps ago), stay in registers, a byte each in
// one word (32 bits up to bpp 4, else 64; bpp is a template parameter). A
// step's output goes to shared memory, in two buffers by the step's parity,
// read by the row below at the next step: one barrier a step. A band holds
// up to 1024 rows (the CTA's threads); taller images run their bands in
// turn, each after the one above, whose last row the band's first thread
// reads back from global memory.
//
// Neighbouring threads work on rows far apart, so a byte access a step
// would touch a cache line a thread. Each thread reads its row in aligned
// 16-byte words instead (RowStream): cp.async brings them into a ring of
// four 16-byte slots of shared memory. The loads are issued and waited for
// only at the start of every 16 steps, by every thread at once, each thread
// sending the word that its next 16 steps may reach and waiting for all but
// that one: a warp tracks its outstanding copies as one, so a wait (or a
// register load) at a step where only some lanes need a word would stall
// the warp on the copies its other lanes issued a step before. A thread
// stages its outputs in an 8-byte slot of shared memory, stored as one
// aligned 8-byte word when the word is whole (byte by byte only at the
// row's ends, where a word is shared with the neighbouring row). An aligned
// word that holds a byte of the tensor lies in the tensor's 16-byte aligned
// allocation, so reading all of it is safe; words that hold no byte of the
// row are never read. The band row that reads the band above reads it with
// plain loads (RowReader): one thread, whose own loads alone fill its
// registers.
//
// What bounds it: this schedule's critical path, RB + H - 1 dependent steps
// a band (the function's own is a pixel a step, ceil(RB / bpp) + H - 1, as
// the bpp bytes of a pixel are independent), each a barrier, a shared-memory round trip and the predictor, for
// which every warp of the CTA issues its step's instructions; the bytes
// (each filtered byte read once, each output written once) take far less at
// the H100's 3.35 TB/s. A CTA an image keeps B of the 132 SMs busy. The
// predictor is computed without a branch: lanes of a warp hold rows of any
// filter, and branches on the id ran each filter's path in turn.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kUnfilterBand = 1024;  // rows a CTA reconstructs at once, a thread each

// The row's predictor, without a branch (the lanes of a warp take rows of
// any filter): each candidate masked by its id's test.
__device__ __forceinline__ int predictor(int f, int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  const int bc = pb <= pc ? b : c;
  const int paeth = (pa <= pb) & (pa <= pc) ? a : bc;
  return (a & -(f == 1)) | (b & -(f == 2)) | (((a + b) >> 1) & -(f == 3)) | (paeth & -(f == 4));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

constexpr int kPeriod = 16;  // steps between two issues of the ring's copies
constexpr int kRing = 4;     // 16-byte slots a thread's ring holds (a power of 2)

// A row read byte by byte through aligned 16-byte words that cp.async
// brings into a ring of kRing shared-memory slots, word k into slot k % kRing.
// ``advance`` runs at the start of every kPeriod steps in every thread of
// the CTA: the 16 steps ahead read words kA and kA + 1 (kA the word of the
// first step's byte), so it sends the next word not yet sent if that is at
// most kA + 2, and waits for every copy but that one. Issued this way, at
// least kA + 3 words are sent when a period starts, and kA + 1 went a
// period before.
struct RowStream {
  const uint8_t* words;  // the aligned word that holds the row's first byte
  uint8_t* slots;        // the thread's kRing * 16 bytes of shared memory
  int count;             // the aligned words that hold bytes of the row (0: no row)
  int sent;              // the words sent
  int lead;              // the row's first byte within its word

  __device__ __forceinline__ void start(const uint8_t* row, int64_t rb, uint8_t* ring, bool live) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // the band before may still fill the ring
    const uintptr_t a = reinterpret_cast<uintptr_t>(row);
    words = reinterpret_cast<const uint8_t*>(a & ~static_cast<uintptr_t>(15));
    lead = static_cast<int>(a & 15);
    count = live ? static_cast<int>((lead + rb + 15) >> 4) : 0;
    slots = ring;
    sent = count < 2 ? count : 2;
    for (int k = 0; k < sent; k++) cp_async16(slots + 16 * k, words + 16 * k);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // At the start of a period whose first step reaches byte x (below 0: the
  // row has not started). Every thread of the CTA calls it.
  __device__ __forceinline__ void advance(int x) {
    const int first = x < 0 ? 0 : (lead + x) >> 4;
    if (sent < count && sent <= first + 2) {
      cp_async16(slots + 16 * (sent & (kRing - 1)), words + 16 * static_cast<int64_t>(sent));
      sent++;
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }

  // Byte x of the row, 0 <= x < rb, in a period whose words have come.
  __device__ __forceinline__ int byte(int x) const {
    const int q = lead + x;
    return slots[16 * ((q >> 4) & (kRing - 1)) + (q & 15)];
  }
};

// A row read byte by byte through aligned 16-byte words in registers: the
// word of the current byte and the next one, loaded a word ahead. For one
// thread of a warp only: another lane's load into the same register would
// stall this lane's next read.
struct RowReader {
  const uint4* words;
  int count;
  int k;  // the index of cur
  int lead;
  uint4 cur, nxt;  // words k and k + 1 (zero past the row)

  __device__ __forceinline__ void start(const uint8_t* row, int64_t rb) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(row);
    words = reinterpret_cast<const uint4*>(a & ~static_cast<uintptr_t>(15));
    lead = static_cast<int>(a & 15);
    count = static_cast<int>((lead + rb + 15) >> 4);
    k = 0;
    cur = words[0];
    nxt = count > 1 ? words[1] : make_uint4(0, 0, 0, 0);
  }

  __device__ __forceinline__ int byte(int x) {
    const int q = lead + x;
    if ((q >> 4) != k) {
      cur = nxt;
      k++;
      if (k + 1 < count) nxt = words[k + 1];
    }
    const int p = static_cast<int>(q & 15);
    const uint32_t w = (p & 8) ? ((p & 4) ? cur.w : cur.z) : ((p & 4) ? cur.y : cur.x);
    return static_cast<int>((w >> (8 * (p & 3))) & 0xff);
  }
};

// Dynamic shared memory a thread takes: its ring, its output slot and its
// two bytes of the last outputs.
constexpr int kSmemPerThread = 16 * kRing + 8 + 2;

// BPP: the bytes a pixel, the left neighbour's distance (its history fits
// a 32-bit word up to 4). Steps, bytes and words of a row are int: the C
// entry takes rows shorter than 2^31 - 2048 bytes.
template <int BPP>
__global__ void __launch_bounds__(kUnfilterBand)
    unfilter_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ filters, int64_t h,
                    int rb, uint8_t* out) {
  using History = typename std::conditional<(BPP <= 4), uint32_t, uint64_t>::type;
  constexpr int kShift = 8 * (BPP - 1);
  extern __shared__ __align__(16) uint8_t smem[];
  const int threads = blockDim.x;
  const int r = threadIdx.x;
  uint8_t* ring = smem + 16 * kRing * r;                              // the thread's input words
  uint2* stage = reinterpret_cast<uint2*>(smem + 16 * kRing * threads);  // each row's output word being filled
  uint8_t* last = reinterpret_cast<uint8_t*>(stage + threads);        // [2][threads]: each row's output
  uint8_t* slot = reinterpret_cast<uint8_t*>(stage + r);              // at the step of that parity
  const int64_t image = blockIdx.x;
  const uint8_t* src_image = rows + image * h * rb;
  uint8_t* dst_image = out + image * h * rb;

  for (int64_t y0 = 0; y0 < h; y0 += kUnfilterBand) {
    const int n = static_cast<int>(h - y0 < kUnfilterBand ? h - y0 : kUnfilterBand);
    const int64_t y = y0 + r;
    const bool live = r < n;
    // the band's first row reads the row above from the band before, which
    // this CTA stored before the barrier that ended that band (plain loads,
    // through a pointer the kernel writes: not the read-only path)
    const bool above = live && r == 0 && y0 > 0;
    RowStream raw;
    RowReader up_row;
    raw.start(src_image + (live ? y : 0) * rb, rb, ring, live);
    if (above) up_row.start(dst_image + (y0 - 1) * rb, rb);
    uint8_t* dst = dst_image + (live ? y : 0) * rb;
    const int dlead = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 7);
    const int f = live ? filters[image * h + y] : 0;
    History own = 0, up = 0;  // the last BPP outputs, and bytes read above, newest in the low byte
    const int steps = rb + n - 1;
    // steps and periods are the same for every thread: each reaches every barrier
    for (int t0 = 0; t0 < steps; t0 += kPeriod) {
      raw.advance(t0 - r);
      const int t1 = t0 + kPeriod < steps ? t0 + kPeriod : steps;
      for (int t = t0; t < t1; t++) {
        const int x = t - r;
        if (live && x >= 0 && x < rb) {
          const int byte = raw.byte(x);
          const int b = y == 0 ? 0 : (above ? up_row.byte(x) : last[((t - 1) & 1) * threads + r - 1]);
          const int a = static_cast<int>((own >> kShift) & 0xff);
          const int c = static_cast<int>((up >> kShift) & 0xff);
          const uint8_t v = static_cast<uint8_t>(byte + predictor(f, a, b, c));
          last[(t & 1) * threads + r] = v;
          own = (own << 8) | v;
          up = (up << 8) | static_cast<History>(b);
          const int p = static_cast<int>((dlead + x) & 7);  // v's place in its aligned output word
          slot[p] = v;
          if (p == 7 || x == rb - 1) {  // the word is done: store what of it is this row's
            uint8_t* word = dst + x - p;
            if (p == 7 && x >= 7) {
              *reinterpret_cast<uint2*>(word) = stage[r];
            } else {
              for (int j = x < p ? p - x : 0; j <= p; j++) word[j] = slot[j];
            }
          }
        }
        __syncthreads();
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Launches unfilter_kernel<BPP>, its shared-memory limit raised first where
// the launch takes more than the default 48 KB (once a device).
template <int BPP>
cudaError_t launch_unfilter(const uint8_t* rows, const int32_t* filters, int64_t b, int64_t h, int rb,
                            uint8_t* out, int threads, cudaStream_t stream) {
  const int smem = threads * kSmemPerThread;
  if (smem > 48 * 1024) {
    static bool raised[kMaxDevices];  // set twice by racing threads: harmless
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || !raised[dev]) {
      err = cudaFuncSetAttribute(unfilter_kernel<BPP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kUnfilterBand * kSmemPerThread);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) raised[dev] = true;
    }
  }
  unfilter_kernel<BPP><<<static_cast<unsigned>(b), threads, smem, stream>>>(rows, filters, h, rb, out);
  return cudaGetLastError();
}

}  // namespace pixo

extern "C" {

// rows: [b, h, rb] uint8 on the device, contiguous, at any byte offset;
// filters: [b, h] int32; out: [b, h, rb] uint8, not overlapping rows. One
// launch of b CTAs of a thread a row (at most kUnfilterBand, in whole
// warps); bpp 1 to 8; rb below 2^31 - 2048.
int pixo_unfilter(const uint8_t* rows, const int32_t* filters, int64_t b, int64_t h, int64_t rb, int bpp,
                  uint8_t* out, void* stream) {
  using namespace pixo;
  if (b < 1 || b > 0x7fffffffll || h < 1 || rb < 1 || rb > 0x7fffffffll - 2 * kUnfilterBand || bpp < 1 ||
      bpp > 8 || rows == nullptr || filters == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rounded = (h < kUnfilterBand ? h : kUnfilterBand) + 31;
  const int threads = static_cast<int>(rounded - rounded % 32);
  const int w = static_cast<int>(rb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bpp) {
    case 1: return static_cast<int>(launch_unfilter<1>(rows, filters, b, h, w, out, threads, s));
    case 2: return static_cast<int>(launch_unfilter<2>(rows, filters, b, h, w, out, threads, s));
    case 3: return static_cast<int>(launch_unfilter<3>(rows, filters, b, h, w, out, threads, s));
    case 4: return static_cast<int>(launch_unfilter<4>(rows, filters, b, h, w, out, threads, s));
    case 5: return static_cast<int>(launch_unfilter<5>(rows, filters, b, h, w, out, threads, s));
    case 6: return static_cast<int>(launch_unfilter<6>(rows, filters, b, h, w, out, threads, s));
    case 7: return static_cast<int>(launch_unfilter<7>(rows, filters, b, h, w, out, threads, s));
    default: return static_cast<int>(launch_unfilter<8>(rows, filters, b, h, w, out, threads, s));
  }
}

}  // extern "C"
