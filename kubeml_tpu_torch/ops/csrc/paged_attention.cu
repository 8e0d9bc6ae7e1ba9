// Paged attention for the serving programs, hand-written for Hopper (sm_90a).
//
// Replaces kubeml_tpu/ops/pallas/paged_attention.py:_pa_kernel (the Pallas
// TPU kernel called by build_paged_decode_step and build_paged_prefill_step).
// It computes, for every slot s and head h, the attention of the slot's
// queries q[s, :, h, :] ([T, D]; T = 1 for decode, T = chunk for prefill)
// over the slot's context of C = Pmax * G tokens, read page by page through
// the page table: page j of slot s is k_pages[tables[s, j]] ([G, H, D]).
//
// Math contract (the reference chain of ops/attention.py):
//   scores = (q . k) accumulated in f32, times 1/sqrt(D) (f32), plus the
//   caller's additive f32 bias [S, 1, T, C]; a full-row f32 softmax (max,
//   exp, sum, divide); weights rounded to the compute dtype; PV accumulated
//   in f32; output written in q's dtype. int8 pages are dequantized with the
//   reference expression: float(x) * scale[page], rounded to the compute
//   dtype.
//
// What bounds it: device-memory bytes. Per call it reads the K and V pages
// of every slot's whole context (2 * S * C * H * D * itemsize) plus the bias
// (S * T * C * 4); its arithmetic is 4 * S * H * T * C * D operations, far
// below the card's rate at T <= 16. Design, first version: one thread block
// per (head, slot), so no [S, C, H, D] context is ever materialised. The
// block walks its own page-table row twice (scores, then PV), staging a tile
// of `tile_pages` pages' [G, D] slices in shared memory per round with 16-byte
// loads, so each thread keeps several loads in flight and every K/V byte is
// read from device memory once per block; the [T, C] score rows stay in
// shared memory between the walks. A TPU grid step carried its page into
// VMEM scratch; here the page loop is a loop inside the block.
//
// Later work: wgmma/TMA tiles for the QK and PV products, a split over pages
// (split-K with a second reduction pass) so that more than S * H blocks fill
// the 132 SMs, and double-buffered tiles so loads overlap the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kTileTokens = 256;  // context tokens staged per round

// pages staged per round: kTileTokens of context, at least one page
int tile_pages_for(int G, int Pmax) {
  const int tp = kTileTokens / G;
  return tp < 1 ? 1 : (tp > Pmax ? Pmax : tp);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an f32 value to the compute dtype QT, returned widened to f32
template <typename QT>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

template <typename QT>
__device__ __forceinline__ QT from_float(float x) {
  if constexpr (std::is_same<QT, __nv_bfloat16>::value) {
    return __float2bfloat16(x);
  } else {
    return x;
  }
}

// one page element as a compute-dtype value held in f32
template <typename QT, typename PT>
__device__ __forceinline__ float page_value(PT x, float scale) {
  if constexpr (std::is_same<PT, int8_t>::value) {
    return round_to<QT>(static_cast<float>(x) * scale);
  } else {
    return to_float(x);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage pages pids[j0 .. j0+np) of head h into dst as [np*G, D+1] f32 rows
// of compute-dtype values (the +1 keeps row-strided reads free of bank
// conflicts). Each thread moves 16-byte vectors (D * sizeof(PT) is a
// multiple of 16; the wrapper checks), issuing kUnroll loads before it
// converts any, so several loads are in flight per thread.
template <typename QT, typename PT>
__device__ __forceinline__ void stage_tile(
    float* dst, const PT* __restrict__ pages, const float* __restrict__ scales,
    const int* pids, int j0, int np, int h, int H, int D, int G) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int kVec = 16 / static_cast<int>(sizeof(PT));
  constexpr int kUnroll = 8;
  const int vpr = D / kVec;  // vectors per token row
  const int n = np * G * vpr;
  const int stride = blockDim.x;
  for (int base = threadIdx.x; base < n; base += stride * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * stride;
      if (i < n) {
        const int r = i / vpr, vc = i - r * vpr;  // token row in the tile
        const int jp = r / G, g = r - jp * G;
        const PT* src = pages
            + ((static_cast<size_t>(pids[j0 + jp]) * G + g) * H + h) * D
            + vc * kVec;
        raw[u] = __ldg(reinterpret_cast<const uint4*>(src));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * stride;
      if (i < n) {
        const int r = i / vpr, vc = i - r * vpr;
        const float scale = kQuant ? scales[pids[j0 + r / G]] : 0.0f;
        const PT* e = reinterpret_cast<const PT*>(&raw[u]);
        float* o = dst + r * (D + 1) + vc * kVec;
#pragma unroll
        for (int k = 0; k < kVec; ++k) o[k] = page_value<QT, PT>(e[k], scale);
      }
    }
  }
}

template <typename QT, typename PT>
__global__ void __launch_bounds__(kThreads)
pa_kernel(const QT* __restrict__ q, const PT* __restrict__ k_pages,
          const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
          const float* __restrict__ v_scale,
          const int32_t* __restrict__ tables, const float* __restrict__ bias,
          QT* __restrict__ out, int T, int H, int D, int G, int Pmax, int P,
          int tile_pages, float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int C = Pmax * G;
  const int O = T * D;                          // outputs of this block
  const int nsplit = max(1, static_cast<int>(blockDim.x) / O);
  float* sc = smem;                             // [T, C] scores, weights
  float* sq = sc + T * C;                       // [T, D] queries
  float* sacc = sq + O;                         // [nsplit, O] PV partials
  float* skv = sacc + max(O, static_cast<int>(blockDim.x));  // one tile
  int* pids = reinterpret_cast<int*>(skv + tile_pages * G * (D + 1));
  const int tid = threadIdx.x;
  const int ld = D + 1;
  const int32_t* row = tables + static_cast<size_t>(s) * Pmax;
  const float* brow = bias + static_cast<size_t>(s) * T * C;

  // the slot's page ids, once; an out-of-range id reads the null page,
  // like the reference's clamped gather
  for (int j = tid; j < Pmax; j += blockDim.x)
    pids[j] = min(max(row[j], 0), P - 1);

  for (int i = tid; i < O; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    sq[i] = to_float(q[((static_cast<size_t>(s) * T + t) * H + h) * D + d]);
  }
  for (int i = tid; i < nsplit * O; i += blockDim.x) sacc[i] = 0.0f;

  // walk 1: scores[t, c] = (q[t] . k[c]) * scale + bias[t, c]
  for (int j0 = 0; j0 < Pmax; j0 += tile_pages) {
    const int rows = min(tile_pages, Pmax - j0) * G;
    __syncthreads();  // every reader of the previous tile is done
    stage_tile<QT, PT>(skv, k_pages, k_scale, pids, j0, rows / G, h, H, D, G);
    __syncthreads();
    for (int i = tid; i < T * rows; i += blockDim.x) {
      const int t = i / rows, r = i - t * rows;
      const float* kr = skv + r * ld;
      const float* qr = sq + t * D;
      // four independent partial sums keep four shared-memory loads in
      // flight per thread (one block per SM leaves few warps to hide them)
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int d = 0;
      for (; d + 4 <= D; d += 4) {
        a0 = fmaf(qr[d], kr[d], a0);
        a1 = fmaf(qr[d + 1], kr[d + 1], a1);
        a2 = fmaf(qr[d + 2], kr[d + 2], a2);
        a3 = fmaf(qr[d + 3], kr[d + 3], a3);
      }
      for (; d < D; ++d) a0 = fmaf(qr[d], kr[d], a0);
      const float acc = (a0 + a1) + (a2 + a3);
      const int c = j0 * G + r;
      // scale, then add the bias: two roundings, as the reference does
      sc[t * C + c] = __fadd_rn(__fmul_rn(acc, scale), brow[t * C + c]);
    }
  }
  __syncthreads();

  // full-row f32 softmax, one warp per row; the weights are rounded to the
  // compute dtype (the reference's weights.astype(q.dtype))
  const int lane = tid & 31;
  for (int t = tid >> 5; t < T; t += blockDim.x >> 5) {
    float* r = sc + t * C;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, r[c]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float e = expf(r[c] - m);
      r[c] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int c = lane; c < C; c += 32) r[c] = round_to<QT>(r[c] / sum);
  }

  // walk 2: out[t, d] = sum_c w[t, c] * v[c, d], accumulated in f32. Work
  // item i = (group, output): when a block has more threads than outputs
  // (decode), `nsplit` groups each sum every nsplit-th context row
  for (int j0 = 0; j0 < Pmax; j0 += tile_pages) {
    const int rows = min(tile_pages, Pmax - j0) * G;
    __syncthreads();
    stage_tile<QT, PT>(skv, v_pages, v_scale, pids, j0, rows / G, h, H, D, G);
    __syncthreads();
    for (int i = tid; i < nsplit * O; i += blockDim.x) {
      const int grp = i / O, o = i - grp * O;
      const int t = o / D, d = o - t * D;
      const float* w = sc + t * C + j0 * G;
      const float* vd = skv + d;
      float a0 = sacc[i], a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int r = grp;
      for (; r + 3 * nsplit < rows; r += 4 * nsplit) {
        a0 = fmaf(w[r], vd[r * ld], a0);
        a1 = fmaf(w[r + nsplit], vd[(r + nsplit) * ld], a1);
        a2 = fmaf(w[r + 2 * nsplit], vd[(r + 2 * nsplit) * ld], a2);
        a3 = fmaf(w[r + 3 * nsplit], vd[(r + 3 * nsplit) * ld], a3);
      }
      for (; r < rows; r += nsplit) a0 = fmaf(w[r], vd[r * ld], a0);
      sacc[i] = (a0 + a1) + (a2 + a3);
    }
  }
  __syncthreads();

  for (int o = tid; o < O; o += blockDim.x) {
    float v = 0.0f;
    for (int grp = 0; grp < nsplit; ++grp) v += sacc[grp * O + o];
    const int t = o / D, d = o - t * D;
    out[((static_cast<size_t>(s) * T + t) * H + h) * D + d] = from_float<QT>(v);
  }
}

// Shared memory one block needs (4-byte words): scores [T, C], queries
// [T, D], PV partials [max(T*D, threads)], one tile [tile_pages*G, D+1],
// the slot's page ids [Pmax]. The Python wrapper reads it through
// kubeml_paged_attention_smem_bytes and checks it against the card's limit
// before launching.
size_t smem_bytes(int T, int D, int G, int Pmax) {
  const size_t O = static_cast<size_t>(T) * D;
  const int tile_pages = tile_pages_for(G, Pmax);
  return 4 * (static_cast<size_t>(T) * Pmax * G + O
              + (O > kThreads ? O : static_cast<size_t>(kThreads))
              + static_cast<size_t>(tile_pages) * G * (D + 1) + Pmax);
}

template <typename QT, typename PT>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scale, const void* v_scale,
                   const void* tables, const void* bias, void* out, int S,
                   int T, int H, int D, int G, int Pmax, int P,
                   cudaStream_t stream) {
  auto kernel = pa_kernel<QT, PT>;
  const int tile_pages = tile_pages_for(G, Pmax);
  const size_t smem = smem_bytes(T, D, G, Pmax);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // the reference's 1 / sqrt(float32(D)): sqrt rounded to f32, then the
  // reciprocal rounded to f32
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  dim3 grid(H, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const float*>(bias),
      static_cast<QT*>(out), T, H, D, G, Pmax, P, tile_pages, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [S, T, H, D] (f32 or bf16), k_pages/v_pages [P, G, H, D] (q's dtype, or
// int8 with quantized != 0), k_scale/v_scale [P] f32, tables [S, Pmax] i32,
// bias [S, 1, T, C] f32, out [S, T, H, D] in q's dtype. All contiguous, on
// the current device; D * sizeof(page element) a multiple of 16; at most
// kubeml_paged_attention_smem_bytes(T, D, G, Pmax) bytes of shared memory
// per block. Returns cudaGetLastError() after the launch.
int kubeml_paged_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* tables,
                           const void* bias, void* out, int S, int T, int H,
                           int D, int G, int Pmax, int P, int q_bf16,
                           int quantized, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_bf16) {
    err = quantized
              ? launch<__nv_bfloat16, int8_t>(q, k_pages, v_pages, k_scale,
                                              v_scale, tables, bias, out, S,
                                              T, H, D, G, Pmax, P, st)
              : launch<__nv_bfloat16, __nv_bfloat16>(
                    q, k_pages, v_pages, k_scale, v_scale, tables, bias, out,
                    S, T, H, D, G, Pmax, P, st);
  } else {
    err = quantized
              ? launch<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                      tables, bias, out, S, T, H, D, G, Pmax,
                                      P, st)
              : launch<float, float>(q, k_pages, v_pages, k_scale, v_scale,
                                     tables, bias, out, S, T, H, D, G, Pmax,
                                     P, st);
  }
  return static_cast<int>(err);
}

// Shared memory (bytes) one block of kubeml_paged_attention launches with.
size_t kubeml_paged_attention_smem_bytes(int T, int D, int G, int Pmax) {
  return smem_bytes(T, D, G, Pmax);
}

}  // extern "C"
