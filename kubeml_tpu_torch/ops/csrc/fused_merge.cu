// Fused merge-apply over one flat f32 merge bucket, hand-written for Hopper
// (sm_90a).
//
// Replaces kubeml_tpu/ops/pallas/fused_merge.py:_kernel (the Pallas TPU
// kernel behind fused_avg_select / fused_sgd_select, called once per bucket
// by the bucketed and error-feedback merges of parallel/merge.py). After a
// bucket's lane sum it computes, in one pass over the bucket:
//
//   avg mode:  out = raw_count > 0 ? s / count            : ref
//   sgd mode:  out = raw_count > 0 ? ref - lr * (s / count) : ref
//
// Math contract (the reference's _lax_apply chain): an IEEE division
// rounded to nearest, then (sgd) a product and a difference rounded
// separately. nvcc contracts `ref - lr * avg` into one FMA by default
// (--fmad=true), which the reference chain does not do, so every step is an
// explicit round-to-nearest intrinsic (__fdiv_rn, __fmul_rn, __fsub_rn).
// The guard is a select: with raw_count == 0 the output is `ref` bit for
// bit, whatever `s` holds (NaN included). count and raw_count are read
// from device memory, as the TPU kernel read them from SMEM, so the host
// never waits on the lane sum that produced them.
//
// What bounds it: device-memory bytes. Each element reads 8 bytes (s, ref)
// and writes 4; the three flops per element are nothing at 3.35 TB/s.
// Design: 16-byte (float4) loads and stores when all three pointers are
// 16-byte aligned, a grid-stride loop over the float4s, and a scalar tail
// (and a scalar path for unaligned views) so any N works. The TPU kernel
// padded the bucket to an (8, 128) tiling; nothing here needs padding.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 16;  // 16 blocks per SM at most

constexpr int kAvg = 0;
constexpr int kSgd = 1;

template <int MODE>
__device__ __forceinline__ float apply(float s, float r, float count,
                                       bool live, float lr) {
  const float avg = __fdiv_rn(s, count);
  const float val = MODE == kSgd ? __fsub_rn(r, __fmul_rn(lr, avg)) : avg;
  return live ? val : r;
}

template <int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
    fused_merge_kernel(const float* __restrict__ s,
                       const float* __restrict__ ref,
                       const float* __restrict__ count_p,
                       const float* __restrict__ raw_p, float lr,
                       float* __restrict__ out, long long n) {
  const float count = *count_p;
  const bool live = *raw_p > 0.0f;  // NaN counts as dropped, as in where()
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long tail = 0;
  if constexpr (VEC) {
    const long long n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* r4 = reinterpret_cast<const float4*>(ref);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (long long j = first; j < n4; j += stride) {
      const float4 a = s4[j];
      const float4 b = r4[j];
      float4 o;
      o.x = apply<MODE>(a.x, b.x, count, live, lr);
      o.y = apply<MODE>(a.y, b.y, count, live, lr);
      o.z = apply<MODE>(a.z, b.z, count, live, lr);
      o.w = apply<MODE>(a.w, b.w, count, live, lr);
      o4[j] = o;
    }
    tail = n4 << 2;
  }
  for (long long j = tail + first; j < n; j += stride) {
    out[j] = apply<MODE>(s[j], ref[j], count, live, lr);
  }
}

template <int MODE>
cudaError_t launch(const float* s, const float* ref, const float* count,
                   const float* raw, float lr, float* out, long long n,
                   cudaStream_t st) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(ref) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vec = (bits & 15) == 0;
  const long long items = vec ? (n >> 2) + (n & 3) : n;
  long long blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < 1 ? 1 : (blocks > kMaxBlocks ? kMaxBlocks : blocks);
  if (vec) {
    fused_merge_kernel<MODE, true><<<static_cast<unsigned>(blocks), kThreads,
                                     0, st>>>(s, ref, count, raw, lr, out, n);
  } else {
    fused_merge_kernel<MODE, false><<<static_cast<unsigned>(blocks),
                                      kThreads, 0, st>>>(s, ref, count, raw,
                                                         lr, out, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// s, ref, out: [n] f32, contiguous, on the current device (out must not
// alias ref or s); count, raw_count: one f32 each in device memory; lr is
// read in sgd mode (mode 1) only. Returns cudaGetLastError() after the
// launch.
int kubeml_fused_merge(const void* s, const void* ref, const void* count,
                       const void* raw_count, float lr, void* out,
                       long long n, int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sp = static_cast<const float*>(s);
  const float* rp = static_cast<const float*>(ref);
  const float* cp = static_cast<const float*>(count);
  const float* wp = static_cast<const float*>(raw_count);
  float* op = static_cast<float*>(out);
  const cudaError_t err =
      mode == kSgd ? launch<kSgd>(sp, rp, cp, wp, lr, op, n, st)
                   : launch<kAvg>(sp, rp, cp, wp, lr, op, n, st);
  return static_cast<int>(err);
}

}  // extern "C"
