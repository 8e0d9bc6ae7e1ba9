// Flash attention for the training path, forward and backward, hand-written
// for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of kubeml_tpu/ops/pallas/
// flash_attention.py (driven there by _fa_forward / _fa_backward):
//   fa_fwd_kernel <- _fa_kernel          online-softmax forward; emits out, m, l
//   fa_dkv_kernel <- _fa_bwd_dkv_kernel  dK, dV with the Q loop inside the block
//   fa_dq_kernel  <- _fa_bwd_dq_kernel   dQ with the KV loop inside the block
// on [B, T, H, D] tensors (f32 or bf16), a [B, T] f32 keep-mask over the keys
// and a causal flag. Row statistics m, l and delta are f32 [B*H, 1, T].
//
// Math contract (the reference's _block_scores and kernel bodies):
//   s = (q . k accumulated in f32) * scale, then + (1 - keep[k]) * NEG_INF,
//   then + NEG_INF above the diagonal when causal: two separate f32 additive
//   terms, NEG_INF = -1e9, never -inf (a fully masked row is uniform over its
//   keys, never NaN). The running max starts at NEG_INF. m and l are kept
//   apart (never lse = m + log l, which loses log l at NEG_INF scale).
//   Forward: p = exp(s - m_new), l = l * exp(m_prev - m_new) + rowsum(p),
//   acc = acc * exp(m_prev - m_new) + bf16(p) . v, out = acc / max(l, 1e-30).
//   Backward: p = exp(s - m) / l, ds = p * (dO . v - delta) * scale,
//   dV += p . dO, dK += ds . q, dQ += ds . k, with p and ds rounded to the
//   input dtype before each product and f32 accumulators.
//   KV tiles wholly above the diagonal are skipped, as the reference's `run`
//   predicate skips them; with the keep-mask that matters only for a query
//   row none of whose own causal keys is kept AND that has kept keys later
//   (left padding), whose keys in skipped tiles then drop out of its uniform
//   row, as they do in the reference's skipped blocks.
//   Columns past T (a ragged last tile) are no keys at all: p = 0.
//
// What bounds it on this card: at the training path's shape (B=8, T=512,
// H=4, D=64, bf16, causal) the forward must move ~8.5 MB (q, k, v, out, m, l:
// 2.5 us at 3.35 TB/s) and do ~1.1 GFLOP (1.1 us on the tensor cores), so an
// ideal kernel is bound by bytes; the backward likewise (3.8 us dK/dV, 3.2 us
// dQ). These kernels are 13-30x above that: each block loads a tile, waits,
// then computes, with only 4-8 warps per SM to hide the wait, and the causal
// blocks carry unequal work.
//
// Design: a CUDA block has no sequential grid axis to carry (acc, m, l) in,
// so each block loops over the other sequence axis inside itself: the forward
// and dQ own one (b*h, 64-row Q tile) and walk the KV tiles; dK/dV owns one
// (b*h, 64-row KV tile) and walks the Q tiles. No atomics, so every result is
// deterministic. Two paths compute the same contract:
//   - bf16 with head_dim 16/32/64/128 (the training path): products on the
//     tensor cores with mma.sync (below, "tensor-core path");
//   - f32 (and other bf16 head dims): f32 FMAs from shared memory. Tiles are
//     staged as f32 rows of D + 1 words (bank-conflict free row and column
//     walks) with 16-byte loads; 256 threads form a 16 x 16 grid and each
//     owns a 4 x 4 micro-tile of every [64, 64] product (rows ty + 16 i,
//     columns tx + 16 j), so each staged value is read once per four FMAs.
//     Head dims up to 128 are two 64-wide column chunks. f32 keeps the tight
//     on-card checks exact to 2e-5; TF32 tensor cores would not.
//
// Later work: double-buffered tiles (cp.async or TMA) so loads overlap the
// products, wgmma with warp specialisation, and a split of the dK/dV walk so
// causal blocks carry equal work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;              // rows of a Q tile and of a KV tile
constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kMaxD = 128;             // head_dim limit
constexpr int kChunks = kMaxD / kTile; // 64-wide column chunks of a head
constexpr int kLdp = kTile + 1;        // row stride of [64, 64] score tiles
constexpr float kNegInf = -1e9f;       // the reference's NEG_INF

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an f32 value to T, returned widened to f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __bfloat162float(__float2bfloat16(x));
  } else {
    return x;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16(x);
  } else {
    return x;
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

// Stage rows [r0, r0 + kTile) of head h of sequence b of x [B, T, H, D] into
// dst as [kTile, D + 1] f32 rows; rows past T are zeros. 16-byte loads
// (D * sizeof(T) is a multiple of 16; the wrapper checks).
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ x,
                                           int b, int h, int r0, int T_,
                                           int H, int D) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int vpr = D / kVec;
  const int ld = D + 1;
  for (int i = threadIdx.x; i < kTile * vpr; i += blockDim.x) {
    const int r = i / vpr, vc = i - r * vpr;
    const int t = r0 + r;
    float* o = dst + r * ld + vc * kVec;
    if (t < T_) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(b) * T_ + t) * H + h) * D + vc * kVec));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k) o[k] = to_float(e[k]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) o[k] = 0.0f;
    }
  }
}

// dst[i] = v[base + r0 + i] for rows inside T, `fill` past it
__device__ __forceinline__ void stage_vec(float* dst,
                                          const float* __restrict__ v,
                                          size_t base, int r0, int T_,
                                          float fill) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int t = r0 + i;
    dst[i] = t < T_ ? v[base + t] : fill;
  }
}

// the pad term (1 - keep) * NEG_INF of a KV tile's columns, in f32 as the
// reference computes it
__device__ __forceinline__ void stage_pad(float* dst,
                                          const float* __restrict__ mask,
                                          int b, int k0, int T_) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    const int t = k0 + i;
    dst[i] = t < T_ ? __fmul_rn(__fsub_rn(1.0f,
                                          mask[static_cast<size_t>(b) * T_ + t]),
                                kNegInf)
                    : 0.0f;
  }
}

// acc[i][j] += sum_{kk < K} A(row_i, kk) * B(kk, col_j) for this thread's rows
// row_i = ty + 16 i and columns col_j = j0 + tx + 16 j, where
// A(r, kk) = a[r * a_r + kk * a_k] and B(kk, c) = b[kk * b_k + c * b_c] live in
// shared memory. Columns at or past n read column n - 1 (callers drop them).
__device__ __forceinline__ void tile_mma(float (&acc)[4][4], const float* a,
                                         int a_r, int a_k, const float* b,
                                         int b_k, int b_c, int K, int j0,
                                         int n) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* ap[4];
  const float* bp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ap[i] = a + (ty + 16 * i) * a_r;
#pragma unroll
  for (int j = 0; j < 4; ++j) bp[j] = b + min(j0 + tx + 16 * j, n - 1) * b_c;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ap[i][kk * a_k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bp[j][kk * b_k];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the reference's score: scaled product, pad term, causal term — three f32
// roundings, never contracted
__device__ __forceinline__ float score(float dot, float scale, float pad,
                                       int causal, int qi, int kj) {
  float s = __fadd_rn(__fmul_rn(dot, scale), pad);
  if (causal) s = __fadd_rn(s, qi >= kj ? 0.0f : kNegInf);
  return s;
}

// write this thread's [4, 4 x kChunks] micro-tile of rows r0 + ty + 16 i into
// y [B, T, H, D] (rows inside T, columns inside D), divided by div[i]
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ y,
                                           const float (&acc)[kChunks][4][4],
                                           const float (&div)[4], int b, int h,
                                           int r0, int T_, int H, int D) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = r0 + ty + 16 * i;
    if (t >= T_) continue;
    T* row = y + ((static_cast<size_t>(b) * T_ + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = c * kTile + tx + 16 * j;
        if (d < D) row[d] = from_float<T>(__fdiv_rn(acc[c][i][j], div[i]));
      }
  }
}

// ------------------------------------------------------------------ forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ mask,
              T* __restrict__ out, float* __restrict__ m_out,
              float* __restrict__ l_out, int T_, int H, int D, int causal,
              float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sq = smem;                  // [kTile, ld] this block's queries
  float* sk = sq + kTile * ld;       // [kTile, ld] one KV tile
  float* sv = sk + kTile * ld;
  float* sp = sv + kTile * ld;       // [kTile, kLdp] scores, then p
  float* spad = sp + kTile * kLdp;   // [kTile] pad terms of the KV tile
  float* sm = spad + kTile;          // [kTile] running max
  float* sl = sm + kTile;            // [kTile] running sum
  float* sa = sl + kTile;            // [kTile] this tile's rescale factor
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  stage_rows<T>(sq, q, b, h, q0, T_, H, D);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    sm[i] = kNegInf;
    sl[i] = 0.0f;
  }
  float acc[kChunks][4][4] = {};

  const int n_kv = (T_ + kTile - 1) / kTile;
  const int kv_end = causal ? min(n_kv, static_cast<int>(blockIdx.x) + 1)
                            : n_kv;
  for (int jt = 0; jt < kv_end; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();  // every reader of the previous tile is done
    stage_rows<T>(sk, k, b, h, k0, T_, H, D);
    stage_rows<T>(sv, v, b, h, k0, T_, H, D);
    stage_pad(spad, mask, b, k0, T_);
    __syncthreads();

    float s[4][4] = {};
    tile_mma(s, sq, ld, 1, sk, 1, ld, D, 0, kTile);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        sp[r * kLdp + c] =
            k0 + c < T_ ? score(s[i][j], scale, spad[c], causal, q0 + r, k0 + c)
                        : -INFINITY;
      }
    __syncthreads();

    // online softmax, one warp per row; p is rounded to v's dtype for PV,
    // the row sum takes the unrounded p (as the reference does)
    for (int r = warp; r < kTile; r += kThreads / 32) {
      float* row = sp + r * kLdp;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float sum = warp_sum(p0 + p1);
      row[lane] = round_to<T>(p0);
      row[lane + 32] = round_to<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sa[r] = alpha;
        sl[r] = __fadd_rn(__fmul_rn(sl[r], alpha), sum);
        sm[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * kTile >= D) continue;
      float o[4][4] = {};
      tile_mma(o, sp, kLdp, 1, sv, ld, 1, kTile, c * kTile, D);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = sa[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[c][i][j] = __fadd_rn(__fmul_rn(acc[c][i][j], alpha), o[i][j]);
      }
    }
  }
  __syncthreads();

  float l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = fmaxf(sl[ty + 16 * i], 1e-30f);
  store_rows<T>(out, acc, l, b, h, q0, T_, H, D);
  const size_t base = static_cast<size_t>(bh) * T_;
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    if (q0 + i < T_) {
      m_out[base + q0 + i] = sm[i];
      l_out[base + q0 + i] = fmaxf(sl[i], 1e-30f);
    }
  }
}

// ---------------------------------------------------------------- dK and dV
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ mask,
              const T* __restrict__ g, const float* __restrict__ m_rows,
              const float* __restrict__ l_rows,
              const float* __restrict__ delta, T* __restrict__ dk,
              T* __restrict__ dv, int T_, int H, int D, int causal,
              float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sk = smem;                  // [kTile, ld] this block's keys
  float* sv = sk + kTile * ld;       // [kTile, ld] ... and values
  float* sq = sv + kTile * ld;       // [kTile, ld] one Q tile
  float* sg = sq + kTile * ld;       // [kTile, ld] its output gradient
  float* sp = sg + kTile * ld;       // [kTile, kLdp] p (rounded)
  float* sds = sp + kTile * kLdp;    // [kTile, kLdp] ds (rounded)
  float* spad = sds + kTile * kLdp;  // [kTile] pad terms of the keys
  float* smr = spad + kTile;         // [kTile] m of the Q tile's rows
  float* slr = smr + kTile;          // [kTile] l
  float* sdr = slr + kTile;          // [kTile] delta
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * T_;

  stage_rows<T>(sk, k, b, h, k0, T_, H, D);
  stage_rows<T>(sv, v, b, h, k0, T_, H, D);
  stage_pad(spad, mask, b, k0, T_);
  float dk_acc[kChunks][4][4] = {};
  float dv_acc[kChunks][4][4] = {};

  const int n_q = (T_ + kTile - 1) / kTile;
  // causal: only Q tiles that reach this KV tile's first column
  for (int it = causal ? blockIdx.x : 0; it < n_q; ++it) {
    const int q0 = it * kTile;
    __syncthreads();
    stage_rows<T>(sq, q, b, h, q0, T_, H, D);
    stage_rows<T>(sg, g, b, h, q0, T_, H, D);
    stage_vec(smr, m_rows, base, q0, T_, 0.0f);
    stage_vec(slr, l_rows, base, q0, T_, 1.0f);
    stage_vec(sdr, delta, base, q0, T_, 0.0f);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_mma(s, sq, ld, 1, sk, 1, ld, D, 0, kTile);   // [q row, key]
    tile_mma(dp, sg, ld, 1, sv, 1, ld, D, 0, kTile);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float p = 0.0f;
        if (k0 + c < T_)
          p = __fdiv_rn(expf(score(s[i][j], scale, spad[c], causal, q0 + r,
                                   k0 + c) - smr[r]),
                        slr[r]);
        const float ds =
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], sdr[r])), scale);
        sp[r * kLdp + c] = round_to<T>(p);
        sds[r * kLdp + c] = round_to<T>(ds);
      }
    __syncthreads();

    // dV[key, d] += sum_r p[r, key] dO[r, d]; dK[key, d] += sum_r ds[r, key] q[r, d]
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * kTile >= D) continue;
      tile_mma(dv_acc[c], sp, 1, kLdp, sg, ld, 1, kTile, c * kTile, D);
      tile_mma(dk_acc[c], sds, 1, kLdp, sq, ld, 1, kTile, c * kTile, D);
    }
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<T>(dk, dk_acc, one, b, h, k0, T_, H, D);
  store_rows<T>(dv, dv_acc, one, b, h, k0, T_, H, D);
}

// ----------------------------------------------------------------------- dQ
template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ mask,
             const T* __restrict__ g, const float* __restrict__ m_rows,
             const float* __restrict__ l_rows,
             const float* __restrict__ delta, T* __restrict__ dq, int T_,
             int H, int D, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* sq = smem;                  // [kTile, ld] this block's queries
  float* sg = sq + kTile * ld;       // [kTile, ld] ... their output gradient
  float* sk = sg + kTile * ld;       // [kTile, ld] one KV tile
  float* sv = sk + kTile * ld;
  float* sds = sv + kTile * ld;      // [kTile, kLdp] ds (rounded)
  float* spad = sds + kTile * kLdp;  // [kTile] pad terms of the KV tile
  float* smr = spad + kTile;         // [kTile] m, l, delta of this block's rows
  float* slr = smr + kTile;
  float* sdr = slr + kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bh) * T_;

  stage_rows<T>(sq, q, b, h, q0, T_, H, D);
  stage_rows<T>(sg, g, b, h, q0, T_, H, D);
  stage_vec(smr, m_rows, base, q0, T_, 0.0f);
  stage_vec(slr, l_rows, base, q0, T_, 1.0f);
  stage_vec(sdr, delta, base, q0, T_, 0.0f);
  float acc[kChunks][4][4] = {};

  const int n_kv = (T_ + kTile - 1) / kTile;
  const int kv_end = causal ? min(n_kv, static_cast<int>(blockIdx.x) + 1)
                            : n_kv;
  for (int jt = 0; jt < kv_end; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();
    stage_rows<T>(sk, k, b, h, k0, T_, H, D);
    stage_rows<T>(sv, v, b, h, k0, T_, H, D);
    stage_pad(spad, mask, b, k0, T_);
    __syncthreads();

    float s[4][4] = {}, dp[4][4] = {};
    tile_mma(s, sq, ld, 1, sk, 1, ld, D, 0, kTile);
    tile_mma(dp, sg, ld, 1, sv, 1, ld, D, 0, kTile);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float p = 0.0f;
        if (k0 + c < T_)
          p = __fdiv_rn(expf(score(s[i][j], scale, spad[c], causal, q0 + r,
                                   k0 + c) - smr[r]),
                        slr[r]);
        sds[r * kLdp + c] = round_to<T>(
            __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i][j], sdr[r])), scale));
      }
    __syncthreads();

    // dQ[r, d] += sum_key ds[r, key] k[key, d]
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c * kTile >= D) continue;
      tile_mma(acc[c], sds, kLdp, 1, sk, ld, 1, kTile, c * kTile, D);
    }
  }

  const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
  store_rows<T>(dq, acc, one, b, h, q0, T_, H, D);
}

// ------------------------------------------------- tensor-core path (bf16)
// bf16 inputs with head_dim 16, 32, 64 or 128 run their products on the
// tensor cores: mma.sync m16n8k16 (bf16 operands, f32 accumulators). A
// block is 4 warps over a 64-row tile; each warp owns 16 rows and keeps its
// [16, 64] score block and its [16, D] accumulators in registers in the
// mma's documented fragment layout (lane = 4 * g + t holds rows g and g + 8,
// columns 2t and 2t + 1 of every 8-wide n-tile), so the row max and sum
// are quad shuffles and a score block, rounded to bf16 — the reference's
// cast point — is directly the A operand of the next product. Tiles are
// staged in shared memory as bf16 rows of D + 8 elements (conflict-free
// 32-bit fragment loads); the right-hand operands of P.V, dS.K, P^T.dO and
// dS^T.Q are read from those same row-major tiles, transposed on the fly by
// ldmatrix.trans.

constexpr int kMmaThreads = 128;       // 4 warps, 16 rows each
constexpr int kPadE = 8;               // bf16 elements of row padding
using bf16 = __nv_bfloat16;

bool mma_head_dim(int D) { return D == 16 || D == 32 || D == 64 || D == 128; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two f32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the B fragment (16 x 8, k x n) of rows k0..k0+15, columns n0..n0+7 of a
// row-major tile, loaded transposed: lanes 0..15 name the 16 rows
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1,
                                              const bf16* row) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n][.] += sum_k X[r0 + row][k] * Y[8 n + col][k] over k < K: the warp's
// 16 rows of row-major X times NT 8-row slabs of row-major Y, both with k
// contiguous (row strides ldx, ldy in elements)
template <int NT, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const bf16* x,
                                         int ldx, int r0, const bf16* y,
                                         int ldy) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    const bf16* px = x + (r0 + g) * ldx + k0 + 2 * t;
    const uint32_t a[4] = {ld32(px), ld32(px + 8 * ldx), ld32(px + 8),
                           ld32(px + 8 * ldx + 8)};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const bf16* py = y + (8 * n + g) * ldy + k0 + 2 * t;
      mma16816(acc[n], a, ld32(py), ld32(py + 8));
    }
  }
}

// acc[n][.] += sum_k bf16(p)[row][k] * Y[k][8 n + col] over the 64 columns k
// of the warp's register score block p, Y a row-major [64, 8 NT] tile
template <int NT>
__device__ __forceinline__ void warp_mma_p(float (&acc)[NT][4],
                                           const float (&p)[8][4],
                                           const bf16* y, int ldy) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, y + (16 * j + (lane & 15)) * ldy + 8 * n);
      mma16816(acc[n], a, b0, b1);
    }
  }
}

// rows [r0, r0 + kTile) of head h of x [B, T, H, D] into dst as bf16 rows of
// stride ld (rows past T are zeros)
template <int D>
__device__ __forceinline__ void stage_bf16(bf16* dst, int ld,
                                           const bf16* __restrict__ x, int b,
                                           int h, int r0, int T_, int H) {
  constexpr int vpr = D / 8;
  for (int i = threadIdx.x; i < kTile * vpr; i += blockDim.x) {
    const int r = i / vpr, vc = i - r * vpr, t = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < T_)
      v = __ldg(reinterpret_cast<const uint4*>(
          x + ((static_cast<size_t>(b) * T_ + t) * H + h) * D + vc * 8));
    *reinterpret_cast<uint4*>(dst + r * ld + vc * 8) = v;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// write the warp's [16, D] register block (rows r0 + g, r0 + g + 8 of the
// tile starting at tile row t0), each row divided by div[i], as bf16
template <int D>
__device__ __forceinline__ void store_mma(bf16* __restrict__ y,
                                          const float (&acc)[D / 8][4],
                                          const float (&div)[2], int b, int h,
                                          int t0, int r0, int T_, int H) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = t0 + r0 + g + 8 * i;
    if (row >= T_) continue;
    bf16* out = y + ((static_cast<size_t>(b) * T_ + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + 8 * n) =
          pack_bf16(__fdiv_rn(acc[n][2 * i], div[i]),
                    __fdiv_rn(acc[n][2 * i + 1], div[i]));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const float* __restrict__ mask,
           bf16* __restrict__ out, float* __restrict__ m_out,
           float* __restrict__ l_out, int T_, int H, int causal,
           float scale) {
  constexpr int LD = D + kPadE;
  extern __shared__ float smem[];
  float* spad = smem;                                // [kTile]
  bf16* sq = reinterpret_cast<bf16*>(spad + kTile);  // [kTile, LD]
  bf16* sk = sq + kTile * LD;                        // [kTile, LD]
  bf16* sv = sk + kTile * LD;                        // [kTile, LD]
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);

  stage_bf16<D>(sq, LD, q, b, h, q0, T_, H);
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int n_kv = (T_ + kTile - 1) / kTile;
  const int kv_end = causal ? min(n_kv, static_cast<int>(blockIdx.x) + 1)
                            : n_kv;
  for (int jt = 0; jt < kv_end; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();
    stage_bf16<D>(sk, LD, k, b, h, k0, T_, H);
    stage_bf16<D>(sv, LD, v, b, h, k0, T_, H);
    stage_pad(spad, mask, b, k0, T_);
    __syncthreads();

    float s[8][4] = {};
    warp_mma<8, D>(s, sq, LD, r0, sk, LD);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * n + 2 * t + (e & 1);
        s[n][e] = k0 + c < T_ ? score(s[n][e], scale, spad[c], causal,
                                      q0 + r0 + g + 8 * i, k0 + c)
                              : -INFINITY;
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), quad_sum(sum[i]));
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = __fmul_rn(o[n][e], alpha[e >> 1]);
    warp_mma_p<D / 8>(o, s, sv, LD);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaxf(l[i], 1e-30f);
  store_mma<D>(out, o, l, b, h, q0, r0, T_, H);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + r0 + g + 8 * i;
      if (row < T_) {
        m_out[static_cast<size_t>(bh) * T_ + row] = m[i];
        l_out[static_cast<size_t>(bh) * T_ + row] = l[i];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const float* __restrict__ mask,
          const bf16* __restrict__ g_out, const float* __restrict__ m_rows,
          const float* __restrict__ l_rows, const float* __restrict__ delta,
          bf16* __restrict__ dq, int T_, int H, int causal, float scale) {
  constexpr int LD = D + kPadE;
  extern __shared__ float smem[];
  float* spad = smem;                                // [kTile]
  bf16* sq = reinterpret_cast<bf16*>(spad + kTile);  // [kTile, LD] x 4
  bf16* sg = sq + kTile * LD;
  bf16* sk = sg + kTile * LD;
  bf16* sv = sk + kTile * LD;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const size_t base = static_cast<size_t>(bh) * T_;

  stage_bf16<D>(sq, LD, q, b, h, q0, T_, H);
  stage_bf16<D>(sg, LD, g_out, b, h, q0, T_, H);
  float mr[2], lr[2], dr[2];   // m, l, delta of this lane's two rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + 8 * i;
    const bool in = row < T_;
    mr[i] = in ? m_rows[base + row] : 0.0f;
    lr[i] = in ? l_rows[base + row] : 1.0f;
    dr[i] = in ? delta[base + row] : 0.0f;
  }
  float acc[D / 8][4] = {};
  const int n_kv = (T_ + kTile - 1) / kTile;
  const int kv_end = causal ? min(n_kv, static_cast<int>(blockIdx.x) + 1)
                            : n_kv;
  for (int jt = 0; jt < kv_end; ++jt) {
    const int k0 = jt * kTile;
    __syncthreads();
    stage_bf16<D>(sk, LD, k, b, h, k0, T_, H);
    stage_bf16<D>(sv, LD, v, b, h, k0, T_, H);
    stage_pad(spad, mask, b, k0, T_);
    __syncthreads();

    float s[8][4] = {}, dp[8][4] = {};
    warp_mma<8, D>(s, sq, LD, r0, sk, LD);
    warp_mma<8, D>(dp, sg, LD, r0, sv, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, c = 8 * n + 2 * t + (e & 1);
        float p = 0.0f;
        if (k0 + c < T_)
          p = __fdiv_rn(expf(score(s[n][e], scale, spad[c], causal,
                                   q0 + r0 + g + 8 * i, k0 + c) - mr[i]),
                        lr[i]);
        s[n][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[n][e], dr[i])), scale);
      }
    warp_mma_p<D / 8>(acc, s, sk, LD);
  }
  const float one[2] = {1.0f, 1.0f};
  store_mma<D>(dq, acc, one, b, h, q0, r0, T_, H);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
fa_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const float* __restrict__ mask,
           const bf16* __restrict__ g_out, const float* __restrict__ m_rows,
           const float* __restrict__ l_rows, const float* __restrict__ delta,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int T_, int H,
           int causal, float scale) {
  constexpr int LD = D + kPadE;
  extern __shared__ float smem[];
  float* spad = smem;                                // [kTile] of the keys
  float* smr = spad + kTile;                         // [kTile] m, l, delta
  float* slr = smr + kTile;                          //   of the Q tile rows
  float* sdr = slr + kTile;
  bf16* sk = reinterpret_cast<bf16*>(sdr + kTile);   // [kTile, LD] x 4
  bf16* sv = sk + kTile * LD;
  bf16* sq = sv + kTile * LD;
  bf16* sg = sq + kTile * LD;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int k0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (threadIdx.x >> 5);
  const size_t base = static_cast<size_t>(bh) * T_;

  stage_bf16<D>(sk, LD, k, b, h, k0, T_, H);
  stage_bf16<D>(sv, LD, v, b, h, k0, T_, H);
  stage_pad(spad, mask, b, k0, T_);
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  const int n_q = (T_ + kTile - 1) / kTile;
  for (int it = causal ? blockIdx.x : 0; it < n_q; ++it) {
    const int q0 = it * kTile;
    __syncthreads();
    stage_bf16<D>(sq, LD, q, b, h, q0, T_, H);
    stage_bf16<D>(sg, LD, g_out, b, h, q0, T_, H);
    stage_vec(smr, m_rows, base, q0, T_, 0.0f);
    stage_vec(slr, l_rows, base, q0, T_, 1.0f);
    stage_vec(sdr, delta, base, q0, T_, 0.0f);
    __syncthreads();

    // transposed blocks: rows are this warp's keys, columns the Q tile's rows
    float p[8][4] = {}, ds[8][4] = {};
    warp_mma<8, D>(p, sk, LD, r0, sq, LD);
    warp_mma<8, D>(ds, sv, LD, r0, sg, LD);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + 8 * (e >> 1), c = 8 * n + 2 * t + (e & 1);
        float pv = 0.0f;
        if (k0 + key < T_)
          pv = __fdiv_rn(expf(score(p[n][e], scale, spad[key], causal,
                                    q0 + c, k0 + key) - smr[c]),
                         slr[c]);
        p[n][e] = pv;
        ds[n][e] = __fmul_rn(__fmul_rn(pv, __fsub_rn(ds[n][e], sdr[c])),
                             scale);
      }
    warp_mma_p<D / 8>(dv_acc, p, sg, LD);
    warp_mma_p<D / 8>(dk_acc, ds, sq, LD);
  }
  const float one[2] = {1.0f, 1.0f};
  store_mma<D>(dk, dk_acc, one, b, h, k0, r0, T_, H);
  store_mma<D>(dv, dv_acc, one, b, h, k0, r0, T_, H);
}

// Shared memory (bytes) of one block of each kernel: 0 forward, 1 dK/dV,
// 2 dQ, on the FMA path or (bf16 with a tensor-core head_dim) the mma path.
// The Python wrapper reads it through kubeml_flash_smem_bytes and checks it
// against the card's limit before launching.
size_t smem_bytes(int kernel, int D, bool bf16_in) {
  if (bf16_in && mma_head_dim(D)) {
    const size_t rows = static_cast<size_t>(kTile) * (D + kPadE) * 2;
    switch (kernel) {
      case 0: return 4 * kTile + 3 * rows;
      case 1: return 16 * kTile + 4 * rows;
      default: return 4 * kTile + 4 * rows;
    }
  }
  const size_t rows = static_cast<size_t>(kTile) * (D + 1);
  const size_t sq = static_cast<size_t>(kTile) * kLdp;
  switch (kernel) {
    case 0: return 4 * (3 * rows + sq + 4 * kTile);
    case 1: return 4 * (4 * rows + 2 * sq + 4 * kTile);
    default: return 4 * (4 * rows + sq + 4 * kTile);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

dim3 grid_for(int B, int T_, int H) {
  return dim3((T_ + kTile - 1) / kTile, B * H);
}

// one launch: the kernel's shared-memory opt-in, then the launch itself
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, int B, int T_,
                   int H, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid_for(B, T_, H), threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

#define KUBEML_MMA_DISPATCH(D, CALL) \
  switch (D) {                       \
    case 16: return CALL(16);        \
    case 32: return CALL(32);        \
    case 64: return CALL(64);        \
    default: return CALL(128);       \
  }

cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       const void* mask, void* out, void* m, void* l, int B,
                       int T_, int H, int D, int causal, float scale,
                       bool bf16_in, cudaStream_t st) {
  const size_t smem = smem_bytes(0, D, bf16_in);
  const float* msk = static_cast<const float*>(mask);
  float* mo = static_cast<float*>(m);
  float* lo = static_cast<float*>(l);
  if (bf16_in && mma_head_dim(D)) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v);
    bf16* ob = static_cast<bf16*>(out);
#define KUBEML_FWD(DD)                                                      \
  launch(fa_fwd_mma<DD>, kMmaThreads, smem, B, T_, H, st, qb, kb, vb, msk, \
         ob, mo, lo, T_, H, causal, scale)
    KUBEML_MMA_DISPATCH(D, KUBEML_FWD)
#undef KUBEML_FWD
  }
  if (bf16_in)
    return launch(fa_fwd_kernel<bf16>, kThreads, smem, B, T_, H, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), msk, static_cast<bf16*>(out),
                  mo, lo, T_, H, D, causal, scale);
  return launch(fa_fwd_kernel<float>, kThreads, smem, B, T_, H, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), msk, static_cast<float*>(out),
                mo, lo, T_, H, D, causal, scale);
}

cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* mask, const void* g, const void* m,
                       const void* l, const void* delta, void* dk, void* dv,
                       int B, int T_, int H, int D, int causal, float scale,
                       bool bf16_in, cudaStream_t st) {
  const size_t smem = smem_bytes(1, D, bf16_in);
  const float *msk = static_cast<const float*>(mask),
              *mr = static_cast<const float*>(m),
              *lr = static_cast<const float*>(l),
              *dr = static_cast<const float*>(delta);
  if (bf16_in && mma_head_dim(D)) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *gb = static_cast<const bf16*>(g);
    bf16 *dkb = static_cast<bf16*>(dk), *dvb = static_cast<bf16*>(dv);
#define KUBEML_DKV(DD)                                                      \
  launch(fa_dkv_mma<DD>, kMmaThreads, smem, B, T_, H, st, qb, kb, vb, msk, \
         gb, mr, lr, dr, dkb, dvb, T_, H, causal, scale)
    KUBEML_MMA_DISPATCH(D, KUBEML_DKV)
#undef KUBEML_DKV
  }
  if (bf16_in)
    return launch(fa_dkv_kernel<bf16>, kThreads, smem, B, T_, H, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), msk,
                  static_cast<const bf16*>(g), mr, lr, dr,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), T_, H, D,
                  causal, scale);
  return launch(fa_dkv_kernel<float>, kThreads, smem, B, T_, H, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), msk,
                static_cast<const float*>(g), mr, lr, dr,
                static_cast<float*>(dk), static_cast<float*>(dv), T_, H, D,
                causal, scale);
}

cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* mask, const void* g, const void* m,
                      const void* l, const void* delta, void* dq, int B,
                      int T_, int H, int D, int causal, float scale,
                      bool bf16_in, cudaStream_t st) {
  const size_t smem = smem_bytes(2, D, bf16_in);
  const float *msk = static_cast<const float*>(mask),
              *mr = static_cast<const float*>(m),
              *lr = static_cast<const float*>(l),
              *dr = static_cast<const float*>(delta);
  if (bf16_in && mma_head_dim(D)) {
    const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
               *vb = static_cast<const bf16*>(v), *gb = static_cast<const bf16*>(g);
    bf16* dqb = static_cast<bf16*>(dq);
#define KUBEML_DQ(DD)                                                      \
  launch(fa_dq_mma<DD>, kMmaThreads, smem, B, T_, H, st, qb, kb, vb, msk, \
         gb, mr, lr, dr, dqb, T_, H, causal, scale)
    KUBEML_MMA_DISPATCH(D, KUBEML_DQ)
#undef KUBEML_DQ
  }
  if (bf16_in)
    return launch(fa_dq_kernel<bf16>, kThreads, smem, B, T_, H, st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), msk,
                  static_cast<const bf16*>(g), mr, lr, dr,
                  static_cast<bf16*>(dq), T_, H, D, causal, scale);
  return launch(fa_dq_kernel<float>, kThreads, smem, B, T_, H, st,
                static_cast<const float*>(q), static_cast<const float*>(k),
                static_cast<const float*>(v), msk,
                static_cast<const float*>(g), mr, lr, dr,
                static_cast<float*>(dq), T_, H, D, causal, scale);
}

}  // namespace

extern "C" {

// q, k, v, out [B, T, H, D] (f32, or bf16 with bf16 != 0), mask [B, T] f32,
// m, l [B*H, 1, T] f32. All contiguous on the current device; D a multiple of
// 16 / sizeof(element) and at most 128. Returns cudaGetLastError() after the
// launch.
int kubeml_flash_fwd(const void* q, const void* k, const void* v,
                     const void* mask, void* out, void* m, void* l, int B,
                     int T, int H, int D, int causal, float scale, int bf16,
                     void* stream) {
  return static_cast<int>(launch_fwd(q, k, v, mask, out, m, l, B, T, H, D,
                                     causal, scale, bf16 != 0,
                                     static_cast<cudaStream_t>(stream)));
}

// As kubeml_flash_fwd, plus g (the output gradient, like q), delta [B*H, 1, T]
// f32 (rowsum(g * out)); writes dk, dv (like k, v).
int kubeml_flash_bwd_dkv(const void* q, const void* k, const void* v,
                         const void* mask, const void* g, const void* m,
                         const void* l, const void* delta, void* dk, void* dv,
                         int B, int T, int H, int D, int causal, float scale,
                         int bf16, void* stream) {
  return static_cast<int>(launch_dkv(q, k, v, mask, g, m, l, delta, dk, dv, B,
                                     T, H, D, causal, scale, bf16 != 0,
                                     static_cast<cudaStream_t>(stream)));
}

// As kubeml_flash_bwd_dkv; writes dq (like q).
int kubeml_flash_bwd_dq(const void* q, const void* k, const void* v,
                        const void* mask, const void* g, const void* m,
                        const void* l, const void* delta, void* dq, int B,
                        int T, int H, int D, int causal, float scale,
                        int bf16, void* stream) {
  return static_cast<int>(launch_dq(q, k, v, mask, g, m, l, delta, dq, B, T,
                                    H, D, causal, scale, bf16 != 0,
                                    static_cast<cudaStream_t>(stream)));
}

// Shared memory (bytes) one block of kernel 0 (forward), 1 (dK/dV) or
// 2 (dQ) launches with at head_dim D and the given input dtype.
size_t kubeml_flash_smem_bytes(int kernel, int D, int bf16) {
  return smem_bytes(kernel, D, bf16 != 0);
}

}  // extern "C"
