// Fused merge-apply over a round's flat f32 merge buckets, hand-written
// for Hopper (sm_90a): every bucket of the round in one launch.
//
// Replaces kubeml_tpu/ops/pallas/fused_merge.py:_kernel (the Pallas TPU
// kernel behind fused_avg_select / fused_sgd_select, which the bucketed
// and error-feedback merges of parallel/merge.py call once per bucket).
// After the buckets' lane sums it computes, for each bucket (a segment of
// the table below):
//
//   avg mode:  out = raw_count > 0 ? s / count            : ref
//   sgd mode:  out = raw_count > 0 ? ref - lr * (s / count) : ref
//
// Math contract (the reference's _lax_apply chain): an IEEE division
// rounded to nearest, then (sgd) a product and a difference rounded
// separately. nvcc contracts `ref - lr * avg` into one FMA by default
// (--fmad=true), which the reference chain does not do, so every step is an
// explicit round-to-nearest intrinsic (__fdiv_rn, __fmul_rn, __fsub_rn).
// The guard is a select: with raw_count == 0 (or NaN) the output is `ref`
// bit for bit, whatever `s` holds (NaN included). count and raw_count are
// read from device memory, as the TPU kernel read them from SMEM, so the
// host never waits on the lane sums that produced them.
//
// What bounds it: device-memory bytes. avg mode needs one input an
// element, s when raw_count > 0 and ref when not, and writes one output:
// 8 bytes an element. sgd mode reads s and ref and writes out: 12. The
// 1-3 flops an element are nothing at 3.35 TB/s. What held the first
// version (one grid-stride launch per bucket) back was the launches: each
// paid the card's ramp and tail however small its bucket. A large bucket
// streams at ~2.6 TB/s with either version (16,777,216 elements, H100
// 80GB HBM3 at 700 W; PERF.md), so there the read+write stream itself is
// the limit, not the bytes in flight.
//
// Design:
//   * One launch per table of up to kMaxSegments segments {s, ref, out, n},
//     passed by value as a __grid_constant__ kernel parameter, so the
//     table needs no copy to the device. A longer list of buckets is cut
//     into tables by the caller, one launch each.
//   * A persistent grid (3 blocks on each SM in avg mode, 2 in sgd) walks
//     fixed chunks of kChunk elements; chunk c of the table lies in the first
//     segment whose chunk prefix sum exceeds c (a binary search over the
//     table), so a chunk never spans two segments.
//   * One thread of each block feeds a ring of shared-memory stages with
//     1-D TMA bulk copies (cp.async.bulk ... mbarrier::complete_tx), each
//     stage completed on its own mbarrier: 3-4 chunks of 16 KB an operand
//     in flight per block and no registers held for them. avg mode loads
//     the one operand it needs.
//   * The block computes from shared memory and writes 16-byte
//     evict-first stores (st.global.cs): the output is not read again in
//     the merge. (A bulk-copy store of each stage measured no faster
//     L2-cold and 33-48 % slower warm at the small plans on an H100 80GB
//     HBM3 at 700 W; PERF.md.)
//   * The register path: a segment whose s, ref or out is not 16-byte
//     aligned is read and written a float at a time, and so is the last
//     n mod 4 elements of an aligned one (bulk copies move multiples of 16
//     bytes). Any n works; the TPU kernel padded the bucket to an (8, 128)
//     tiling, nothing here needs padding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSegments = 64;
constexpr int kThreads = 256;
constexpr int kChunk = 4096;      // elements: 16 KB an operand

constexpr int kAvg = 0;
constexpr int kSgd = 1;

struct Segment {
  const float* s;
  const float* ref;
  float* out;
  long long n;
};

struct Table {
  Segment seg[kMaxSegments];
  long long chunk_end[kMaxSegments];  // chunks of segments 0..i together
  int count;
};

template <int MODE>
__host__ __device__ constexpr int operands() { return MODE == kSgd ? 2 : 1; }
template <int MODE>
__host__ __device__ constexpr int stages() { return MODE == kSgd ? 3 : 4; }
// blocks a persistent grid puts on each SM: as many as their stages fit
// (3 x 64 KB avg, 2 x 96 KB sgd, of the SM's 228 KB)
template <int MODE>
__host__ __device__ constexpr int blocks_per_sm() {
  return MODE == kSgd ? 2 : 3;
}
template <int MODE>
__host__ __device__ constexpr int smem_bytes() {
  return stages<MODE>() * operands<MODE>() * kChunk *
         static_cast<int>(sizeof(float));
}

// One chunk's place: its operands (op[1] unused in avg mode), its output,
// its length and how many of its elements the bulk copies move.
struct Piece {
  const float* op[2];
  float* out;
  int n;
  int vec;
};

__device__ __forceinline__ Piece piece(const Table& t, long long c,
                                       int mode, bool live) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (c < t.chunk_end[mid]) hi = mid; else lo = mid + 1;
  }
  const Segment& g = t.seg[lo];
  const long long first = (c - (lo ? t.chunk_end[lo - 1] : 0)) * kChunk;
  const long long left = g.n - first;
  Piece p;
  if (mode == kSgd) {
    p.op[0] = g.s + first;
    p.op[1] = g.ref + first;
  } else {
    p.op[0] = (live ? g.s : g.ref) + first;
    p.op[1] = nullptr;
  }
  p.out = g.out + first;
  p.n = left < kChunk ? static_cast<int>(left) : kChunk;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(g.s) |
                         reinterpret_cast<uintptr_t>(g.ref) |
                         reinterpret_cast<uintptr_t>(g.out);
  p.vec = (bits & 15) == 0 ? (p.n & ~3) : 0;
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <int MODE>
__device__ __forceinline__ float apply(float s, float r, float count,
                                       bool live, float lr) {
  const float avg = __fdiv_rn(s, count);
  const float val = MODE == kSgd ? __fsub_rn(r, __fmul_rn(lr, avg)) : avg;
  return live ? val : r;
}

// avg mode holds one operand `x` (s when live, ref when not)
template <int MODE>
__device__ __forceinline__ float apply_loaded(float x, float r, float count,
                                              bool live, float lr) {
  if constexpr (MODE == kSgd) {
    return apply<kSgd>(x, r, count, live, lr);
  } else {
    return live ? __fdiv_rn(x, count) : x;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    fused_merge_kernel(const __grid_constant__ Table t,
                       const float* __restrict__ count_p,
                       const float* __restrict__ raw_p, float lr) {
  constexpr int S = stages<MODE>();
  constexpr int OPS = operands<MODE>();
  extern __shared__ __align__(128) float smem[];  // [S][OPS][kChunk]
  __shared__ __align__(8) uint64_t full[S];

  const float count = *count_p;
  const bool live = *raw_p > 0.0f;  // NaN counts as dropped, as in where()
  const long long total = t.chunk_end[t.count - 1];
  const long long mine =
      (total - blockIdx.x + gridDim.x - 1) / gridDim.x;  // blockIdx < total

  auto issue = [&](long long j) {  // thread 0: chunk j of this block
    const int st = static_cast<int>(j % S);
    const Piece p = piece(t, blockIdx.x + j * gridDim.x, MODE, live);
    const uint32_t bytes = static_cast<uint32_t>(p.vec) * 4u;
    mbar_expect(&full[st], bytes * OPS);  // 0 bytes: completes at once
    if (bytes) {
      for (int o = 0; o < OPS; ++o) {
        bulk_load(smem + (st * OPS + o) * kChunk, p.op[o], bytes, &full[st]);
      }
    }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < S; ++st) mbar_init(&full[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (long long j = 0; j < S && j < mine; ++j) issue(j);
  }

  for (long long j = 0; j < mine; ++j) {
    const int st = static_cast<int>(j % S);
    const Piece p = piece(t, blockIdx.x + j * gridDim.x, MODE, live);
    const float* buf = smem + st * OPS * kChunk;
    mbar_wait(&full[st], static_cast<uint32_t>((j / S) & 1));
    const float4* x4 = reinterpret_cast<const float4*>(buf);
    const float4* r4 = reinterpret_cast<const float4*>(buf + kChunk);
    for (int v = threadIdx.x; v < (p.vec >> 2); v += kThreads) {
      const float4 a = x4[v];
      const float4 b = OPS == 2 ? r4[v] : a;
      float4 o;
      o.x = apply_loaded<MODE>(a.x, b.x, count, live, lr);
      o.y = apply_loaded<MODE>(a.y, b.y, count, live, lr);
      o.z = apply_loaded<MODE>(a.z, b.z, count, live, lr);
      o.w = apply_loaded<MODE>(a.w, b.w, count, live, lr);
      __stcs(reinterpret_cast<float4*>(p.out) + v, o);
    }
    for (int e = p.vec + threadIdx.x; e < p.n; e += kThreads) {
      const float a = p.op[0][e];
      const float b = OPS == 2 ? p.op[1][e] : a;
      p.out[e] = apply_loaded<MODE>(a, b, count, live, lr);
    }
    __syncthreads();  // every thread is done with stage st
    if (threadIdx.x == 0 && j + S < mine) issue(j + S);
  }
}

constexpr int kMaxDevices = 64;

template <int MODE>
cudaError_t launch(const Table& t, const float* count, const float* raw,
                   float lr, cudaStream_t st) {
  // per device: the SM count, and the opt-in to more than 48 KB of
  // dynamic shared memory, once
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(fused_merge_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<MODE>());
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev] = n;
  }
  const long long total = t.chunk_end[t.count - 1];
  const long long cap =
      static_cast<long long>(sms[dev]) * blocks_per_sm<MODE>();
  const unsigned blocks = static_cast<unsigned>(total < cap ? total : cap);
  fused_merge_kernel<MODE>
      <<<blocks, kThreads, smem_bytes<MODE>(), st>>>(t, count, raw, lr);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int kubeml_fused_merge_max_segments() { return kMaxSegments; }

// segments: a host array of n_segments records {s, ref, out, n} (1 <=
// n_segments <= kMaxSegments, every n > 0), each s, ref and out an [n] f32
// array on the current device (out must not overlap any s or ref);
// count, raw_count: one f32 each in device memory; lr is read in sgd mode
// (mode 1) only.
// One launch. Returns cudaGetLastError() after it, or
// cudaErrorInvalidValue for a table the kernel does not take.
int kubeml_fused_merge(const void* segments, int n_segments,
                       const void* count, const void* raw_count, float lr,
                       int mode, void* stream) {
  if (n_segments < 1 || n_segments > kMaxSegments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t;
  const Segment* segs = static_cast<const Segment*>(segments);
  long long chunks = 0;
  for (int i = 0; i < n_segments; ++i) {
    if (segs[i].n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    t.seg[i] = segs[i];
    chunks += (segs[i].n + kChunk - 1) / kChunk;
    t.chunk_end[i] = chunks;
  }
  for (int i = n_segments; i < kMaxSegments; ++i) {
    t.seg[i] = Segment{nullptr, nullptr, nullptr, 0};
    t.chunk_end[i] = chunks;
  }
  t.count = n_segments;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cp = static_cast<const float*>(count);
  const float* wp = static_cast<const float*>(raw_count);
  const cudaError_t err = mode == kSgd ? launch<kSgd>(t, cp, wp, lr, st)
                                       : launch<kAvg>(t, cp, wp, lr, st);
  return static_cast<int>(err);
}

}  // extern "C"
