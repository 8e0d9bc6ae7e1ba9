// Flash attention for the training path, forward and backward, hand-written
// for Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of kubeml_tpu/ops/pallas/
// flash_attention.py (driven there by _fa_forward / _fa_backward):
//   fa_fwd_wgmma, fa_fwd_kernel  <- _fa_kernel          online-softmax
//                                    forward; emits out, m, l
//   fa_dkv_wgmma, fa_dkv_kernel  <- _fa_bwd_dkv_kernel  dK, dV with the Q
//                                    loop inside the block
//   fa_dq_wgmma, fa_dq_kernel    <- _fa_bwd_dq_kernel   dQ with the KV loop
//                                    inside the block
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
// What bounds them on this card: at the training path's shape (B=8, T=512,
// H=4, D=64, bf16, causal) an ideal kernel is bound by bytes: the forward
// must move ~8.5 MB (q, k, v, out, m, l: 2.5 us at 3.35 TB/s) against ~1.1
// GFLOP of products (1.1 us on the tensor cores); dK/dV 3.8 us of bytes
// against 2.2 us of products, dQ 3.2 us against 1.6 us. The kernels are
// further from those bounds than a library would be: all three bf16 kernels
// hide their loads behind the products and give every causal block equal
// work; what is left is the per-element epilogue between two dependent
// rounds of products (scores, then the accumulating products): within a
// warpgroup the tensor cores wait for it, and only the other warpgroup of
// the block (one block per SM) can fill that wait.
//
// Design: a CUDA block has no sequential grid axis to carry (acc, m, l) in,
// so each block loops over the other sequence axis inside itself: the forward
// and dQ own a 64-row Q tile and walk the KV tiles; dK/dV owns a 64-row KV
// tile and walks the Q tiles. No atomics, so every result is deterministic.
// Two paths compute the same contract:
//   - bf16 with head_dim 16/32/64/128 (the training path): wgmma, a cp.async
//     ring per warpgroup and balanced causal blocks, forward and backward
//     alike (below, "backward, tensor cores" and "forward, tensor cores");
//   - f32 (and other bf16 head dims): f32 FMAs from shared memory. Tiles are
//     staged as f32 rows of D + 1 words (bank-conflict free row and column
//     walks) with 16-byte loads; 256 threads form a 16 x 16 grid and each
//     owns a 4 x 4 micro-tile of every [64, 64] product (rows ty + 16 i,
//     columns tx + 16 j), so each staged value is read once per four FMAs.
//     Head dims up to 128 are two 64-wide column chunks. f32 keeps the tight
//     on-card checks exact to 2e-5; TF32 tensor cores would not.
//
// Later work: the next step's scores issued before this step's epilogue
// (registers allow it at head_dim <= 64), and TMA in place of cp.async once
// its host-side tensor map is measured against the host-bound training
// step.

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
constexpr float kLog2e = 1.4426950408889634f;

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

// ------------------------------------------------ tensor cores (bf16)
using bf16 = __nv_bfloat16;

bool mma_head_dim(int D) { return D == 16 || D == 32 || D == 64 || D == 128; }

// two f32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ------------------------------------------- backward (bf16, tensor cores)
// Replaces _fa_bwd_dkv_kernel (fa_dkv_wgmma) and _fa_bwd_dq_kernel
// (fa_dq_wgmma) for bf16 with head_dim 16, 32, 64 or 128. One step of a
// block's walk is one (owned tile, walked tile) pair of 64-row tiles.
//   - Warpgroups: a block is two warpgroups; warpgroup w takes steps w,
//     w + 2, ... of the block's walk, with a ring of its own and its own
//     barrier, so the two drift out of phase and one's epilogue overlaps
//     the other's products. Each keeps partial dK/dV (dQ) sums; when an
//     owned tile is done, they are added in a fixed order (warpgroup 0's
//     plus warpgroup 1's) through shared memory: no atomics.
//   - Ring: each warpgroup's walked operands (Q, dO and the m, l, delta
//     rows; or K, V and the keep-mask) come through kStages shared-memory
//     stages filled by cp.async.cg kStages - 1 of its steps ahead, 16-byte
//     copies with compile-time trip counts, rows past T zero-filled through
//     the copy's source size; one warpgroup barrier per step.
//   - Schedule (make_walk): a causal block owns the pair of tiles
//     (p, n - 1 - p), so every block walks n + 1 tiles (the middle tile of
//     an odd count goes alone): at T = 512, 128 equal blocks on 132 SMs
//     instead of 256 blocks walking 1..8 tiles. A non-causal block owns
//     one tile and walks all n.
//   - Products: wgmma; a warpgroup computes a whole step. The scores
//     S^T = K Q^T and dP^T = V dO^T (dK/dV), S = Q K^T and dP = dO V^T (dQ)
//     read both operands from shared memory (m64n64k16); dV += P^T dO,
//     dK += dS^T Q and dQ += dS K take A from registers (the scores'
//     accumulator rounded to bf16, the reference's cast point: the
//     accumulator and A-fragment layouts coincide) and B from the same
//     shared tiles in their MN-major form. Tiles sit in wgmma's swizzled
//     layout (WgTile), written so by the ring; a proxy fence makes the
//     copies visible to wgmma.
//   - Epilogue: p = exp2((s - m) log2 e) / l with 1/l taken once per row,
//     the score keeping the reference's three f32 roundings; the causal
//     term only on the diagonal tile, the check of keys past T only on the
//     last (dQ; dK/dV never stores those rows). A row past T arrives with
//     l = 0 and gets 1/l = 0, so it adds nothing.

// two warpgroups, each walking every other tile of the block's walk
constexpr int kBwdThreads = 256;
constexpr int kWgThreads = 128;

// stages of each warpgroup's ring: three (two tiles in flight) where they
// fit in shared memory, two at head_dim 128
template <int D>
constexpr int kStages = D > 64 ? 2 : 3;

// barrier over one warpgroup's 128 threads (ids 1 and 2; 0 is
// __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + wg), "n"(kWgThreads)
               : "memory");
}

// barrier over the whole block, reached from the two warpgroups' own
// places in their walks (id 3)
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kBwdThreads) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without passing through registers; with
// !valid the source size is 0 and the 16 bytes are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A [64, D] bf16 tile in shared memory as wgmma reads it: D / 64 column
// blocks (one when D <= 64) of 64 rows of kRowBytes = 2 min(D, 64) bytes,
// the 16-byte chunks of each row XOR-swizzled with the row's low bits
// (wgmma's 128-byte swizzle for D = 64 and 128, 64-byte for 32, 32-byte
// for 16), so neither the copies nor wgmma's reads conflict on banks.
// Tiles start on 1024-byte boundaries, where the swizzle pattern repeats.
template <int D>
struct WgTile {
  static constexpr int kRowBytes = 2 * (D < 64 ? D : 64);
  static constexpr int kChunks = kRowBytes / 16;   // per row of a block
  static constexpr int kBlockBytes = kTile * kRowBytes;
  static constexpr int kBytes = kTile * D * 2;
  static constexpr uint64_t kMode = D >= 64 ? 1 : D == 32 ? 2 : 3;
};

// rows [r0, r0 + kTile) of head h of x [B, T, H, D] into the tile at dst,
// asynchronously, by NT threads (this one is tid); rows past T are zeros
template <int D, int NT>
__device__ __forceinline__ void load_tile(unsigned char* dst,
                                          const bf16* __restrict__ x, int b,
                                          int h, int r0, int T_, int H,
                                          int tid) {
  using L = WgTile<D>;
  constexpr int vpr = D / 8;   // 16-byte chunks per row of x
#pragma unroll
  for (int it = 0; it < (kTile * vpr + NT - 1) / NT; ++it) {
    const int i = it * NT + tid;
    if (kTile * vpr % NT && i >= kTile * vpr) break;
    const int r = i / vpr, vc = i % vpr, t = r0 + r;
    const bool ok = t < T_;
    uint32_t off = (vc / L::kChunks) * L::kBlockBytes + r * L::kRowBytes +
                   (vc % L::kChunks) * 16;
    off ^= ((off >> 7) & (L::kChunks - 1)) << 4;
    cp_async16(dst + off,
               x + ((static_cast<size_t>(b) * T_ + (ok ? t : T_ - 1)) * H +
                    h) * D + vc * 8,
               ok);
  }
}

// wgmma's shared-memory matrix descriptor of a swizzled tile region: start
// address, leading byte offset (lbo), stride byte offset (8 rows), swizzle
template <int D>
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo) {
  using L = WgTile<D>;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>((8 * L::kRowBytes) >> 4) << 32 | L::kMode << 62;
}

// the tile as a K-major operand (its rows are M or N, D is K): k16 slice kk
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  using L = WgTile<D>;
  return wg_desc<D>(tile + (kk / 4) * L::kBlockBytes + (kk % 4) * 32, 16);
}

// the tile as an MN-major operand (its rows are K, D is N): rows
// 16 j .. 16 j + 15, the N columns of block c
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int j, int c) {
  using L = WgTile<D>;
  return wg_desc<D>(tile + c * L::kBlockBytes + j * 16 * L::kRowBytes,
                    L::kBlockBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// copies that landed through cp.async become visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving reads of accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A . B^T for one k16 slice, m64n64k16, A and B K-major tiles in
// shared memory (descriptors); the slice accumulates into d unless `acc`
// is 0 (then d's input is ignored)
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                           uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D += A . B for one k16 slice, m64nNk16: A a register fragment (the
// accumulator layout of a previous product, rounded to bf16), B an MN-major
// tile in shared memory (transposed: imm-trans-b = 1)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// src[r0 + i] for i < kTile into dst, asynchronously, by threads tid <
// kTile; zeros past T
__device__ __forceinline__ void load_row(float* dst,
                                         const float* __restrict__ src,
                                         int r0, int T_, int tid) {
  if (tid < kTile) {
    const int t = r0 + tid;
    cp_async4(dst + tid, src + (t < T_ ? t : T_ - 1), t < T_);
  }
}

// The tiles a tensor-core block owns and, for each, the tiles it walks:
// owned tile own[o] walks tiles first[o] .. first[o] + count[o] - 1. The
// walk is one flat run of `steps` steps over the owned tiles in turn.
struct Walk {
  int own[2], first[2], count[2], n_own, steps;

  // owned tile of slot o (a select: no runtime index into the arrays)
  __device__ __forceinline__ int tile(int o) const {
    return o ? own[1] : own[0];
  }
  // step s -> (owned slot, walked tile)
  __device__ __forceinline__ int slot(int s) const {
    return s < count[0] ? 0 : 1;
  }
  __device__ __forceinline__ int walked(int s) const {
    return s < count[0] ? first[0] + s : first[1] + s - count[0];
  }
};

// kv_owner: the block owns KV tiles and walks Q tiles (dK/dV); else the
// reverse (dQ, the forward). Causal blocks walk only the tiles on or below the diagonal,
// so owned tile j walks n - j tiles (dK/dV) or j + 1 (dQ); block p owns
// the pair (p, n - 1 - p), which walks n + 1 tiles whichever kernel, and
// for odd n the middle tile goes alone. Non-causal blocks own one tile.
// Every allowed (Q tile, KV tile) pair is walked exactly once.
__device__ __forceinline__ Walk make_walk(bool kv_owner, int n, int causal) {
  Walk w;
  const int p = blockIdx.x;
  w.own[0] = p;
  w.own[1] = n - 1 - p;
  w.n_own = causal && w.own[1] != p ? 2 : 1;
  if (w.n_own == 1) w.own[1] = p;
  w.steps = 0;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    if (kv_owner) {
      w.first[o] = causal ? w.own[o] : 0;
      w.count[o] = n - w.first[o];
    } else {
      w.first[o] = 0;
      w.count[o] = causal ? w.own[o] + 1 : n;
    }
    if (o < w.n_own) w.steps += w.count[o];
  }
  return w;
}

// Accumulators of a [64, D] wgmma product, per thread: Acc<D>::kBlocks
// blocks of Acc<D>::kRegs floats, one block per 64 columns (one m64nNk16
// accumulator each, N = min(D, 64)). Register 4 n + e of a block holds row
// 16 warp + g + 8 (e >> 1), column 8 n + 2 t + (e & 1) of that block, for
// warp 0..3 of the warpgroup.
template <int D>
struct Acc {
  static constexpr int kBlocks = D > 64 ? D / 64 : 1;
  static constexpr int kN = D > 64 ? 64 : D;
  static constexpr int kRegs = kN / 2;
};

template <int D>
using AccRegs = float[Acc<D>::kBlocks][Acc<D>::kRegs];

// write a [64, D] accumulator as bf16 rows row0 .. row0 + 63 of y
// [B, T, H, D], rows inside T
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ y,
                                          const AccRegs<D>& acc, int b,
                                          int h, int row0, int T_, int H) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int r0 = 16 * ((threadIdx.x & 127) >> 5);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r0 + g + 8 * i;
    if (row >= T_) continue;
    bf16* out = y + ((static_cast<size_t>(b) * T_ + row) * H + h) * D + 2 * t;
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c)
#pragma unroll
      for (int n = 0; n < Acc<D>::kN / 8; ++n)
        *reinterpret_cast<uint32_t*>(out + 64 * c + 8 * n) =
            pack_bf16(acc[c][4 * n + 2 * i], acc[c][4 * n + 2 * i + 1]);
  }
}

template <int D>
__device__ __forceinline__ void zero(AccRegs<D>& acc) {
#pragma unroll
  for (int c = 0; c < Acc<D>::kBlocks; ++c)
#pragma unroll
    for (int i = 0; i < Acc<D>::kRegs; ++i) acc[c][i] = 0.0f;
}

// The two warpgroups' partial sums of one [64, D] accumulator, added in a
// fixed order (warpgroup 0's + warpgroup 1's) and stored by warpgroup 0;
// `scratch` holds 256 D bytes that no one reads any more (the owned
// tile's two resident tiles). Leaves acc zeroed for the next owned tile.
template <int D>
__device__ __forceinline__ void reduce_store(AccRegs<D>& acc, float* scratch,
                                             bf16* __restrict__ y, int b,
                                             int h, int row0, int T_, int H) {
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  block_sync();   // both warpgroups are done with the scratch's tiles
  if (wg == 1) {
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c)
#pragma unroll
      for (int i = 0; i < Acc<D>::kRegs; ++i)
        scratch[(c * Acc<D>::kRegs + i) * 128 + tid] = acc[c][i];
  }
  block_sync();
  if (wg == 0) {
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c)
#pragma unroll
      for (int i = 0; i < Acc<D>::kRegs; ++i)
        acc[c][i] += scratch[(c * Acc<D>::kRegs + i) * 128 + tid];
    store_acc<D>(y, acc, b, h, row0, T_, H);
  }
  zero<D>(acc);
}

// the [64, 64] accumulator x rounded to bf16 as four k16 A fragments of the
// next product (its columns become that product's K)
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack_bf16(x[8 * j], x[8 * j + 1]);
    a[j][1] = pack_bf16(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16(x[8 * j + 6], x[8 * j + 7]);
  }
}

// acc += A . tile over the 64 rows of an MN-major tile (K = those rows)
template <int D>
__device__ __forceinline__ void wgmma_acc(AccRegs<D>& acc,
                                          const uint32_t (&a)[4][4],
                                          uint32_t tile) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c)
      wgmma_rs<Acc<D>::kN>(acc[c], a[j], desc_mn<D>(tile, j, c));
}

// s = X . Y^T over D for two K-major tiles (64 rows each)
template <int D>
__device__ __forceinline__ void wgmma_scores(float (&s)[32], uint32_t x,
                                             uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss64(s, desc_k<D>(x, kk), desc_k<D>(y, kk), kk);
}

template <int D>
struct BwdSmem {
  static constexpr size_t kTileBytes = WgTile<D>::kBytes;
  static constexpr size_t kRing = 2 * kStages<D>;   // stages, both rings
  // 1 KB for aligning the dynamic shared memory to 1024 bytes; dK/dV:
  // resident K, V of two owned tiles, per stage Q, dO and the m, l, delta
  // rows of the walked Q tile; dQ: resident Q, dO of two owned tiles, per
  // stage K, V and the keep-mask of the walked KV tile
  static constexpr size_t kDkv =
      1024 + (4 + 2 * kRing) * kTileBytes + 4 * kRing * 3 * kTile;
  static constexpr size_t kDq =
      1024 + (4 + 2 * kRing) * kTileBytes + 4 * kRing * kTile;
};

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
fa_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const float* __restrict__ mask,
            const bf16* __restrict__ g_out, const float* __restrict__ m_rows,
            const float* __restrict__ l_rows,
            const float* __restrict__ delta, bf16* __restrict__ dq, int T_,
            int H, int causal, float scale) {
  constexpr int TB = WgTile<D>::kBytes, S = kStages<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* res = align_1k(smem_raw);       // [owned][Q, dO]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  unsigned char* ring = res + (4 + wg * S * 2) * TB;   // [stage][K, V]
  float* smask = reinterpret_cast<float*>(res + (4 + 4 * S) * TB) +
                 wg * S * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const size_t base = static_cast<size_t>(bh) * T_;
  const Walk w = make_walk(false, (T_ + kTile - 1) / kTile, causal);

  // this warpgroup's j-th step is step wg + 2 j of the walk
  auto issue = [&](int j) {
    const int k0 = w.walked(wg + 2 * j) * kTile, st = j % S;
    load_tile<D, kWgThreads>(ring + st * 2 * TB, k, b, h, k0, T_, H, tid);
    load_tile<D, kWgThreads>(ring + st * 2 * TB + TB, v, b, h, k0, T_, H,
                             tid);
    load_row(smask + st * kTile, mask + static_cast<size_t>(b) * T_, k0, T_,
             tid);
  };
  for (int o = 0; o < w.n_own; ++o) {
    load_tile<D, kBwdThreads>(res + 2 * o * TB, q, b, h, w.tile(o) * kTile,
                              T_, H, threadIdx.x);
    load_tile<D, kBwdThreads>(res + 2 * o * TB + TB, g_out, b, h,
                              w.tile(o) * kTile, T_, H, threadIdx.x);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (wg + 2 * j < w.steps) issue(j);
    cp_async_commit();
  }

  // m, 1/l, delta of this lane's two rows of each owned tile
  float mr[2][2], ilr[2][2], dr[2][2];
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = w.tile(o) * kTile + r0 + g + 8 * i;
      const bool in = row < T_;
      mr[o][i] = in ? m_rows[base + row] : 0.0f;
      ilr[o][i] = in ? __frcp_rn(l_rows[base + row]) : 0.0f;
      dr[o][i] = in ? delta[base + row] : 0.0f;
    }
  cp_async_wait<S - 1>();   // the resident tiles, copied by both warpgroups
  fence_async_smem();
  __syncthreads();

  AccRegs<D> acc;
  zero<D>(acc);
  bool first_done = w.n_own == 1;   // owned tile 0's sums are stored
  for (int j = 0; wg + 2 * j < w.steps; ++j) {
    const int s = wg + 2 * j;
    cp_async_wait<S - 2>();   // step j has landed ...
    fence_async_smem();
    wg_sync(wg);              // ... for the warpgroup; step j - 1 is done
    if (s + 2 * (S - 1) < w.steps) issue(j + S - 1);   // into j - 1's stage
    cp_async_commit();

    const int o = w.slot(s), st = j % S;
    if (o == 1 && !first_done) {   // both warpgroups are past tile 0
      reduce_store<D>(acc, reinterpret_cast<float*>(res), dq, b, h,
                      w.tile(0) * kTile, T_, H);
      first_done = true;
    }
    const int q0 = w.tile(o) * kTile, k0 = w.walked(s) * kTile;
    const uint32_t sq = smem_u32(res + 2 * o * TB), sg = sq + TB;
    const uint32_t sk = smem_u32(ring + st * 2 * TB), sv = sk + TB;
    const float* sm = smask + st * kTile;
    // S = Q K^T and dP = dO V^T for the owned tile's 64 query rows
    float s_[32], dp[32];
    wgmma_fence();
    wgmma_scores<D>(s_, sq, sk);
    wgmma_scores<D>(dp, sg, sv);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_);
    fence_regs(dp);
    // ds in place of s; only a tile that crosses the diagonal or holds
    // keys past T (the last one) checks each element
    auto epilogue = [&](auto edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * n + 2 * t + (e & 1), x_ = 4 * n + e;
          const float pad = __fmul_rn(__fsub_rn(1.0f, sm[c]), kNegInf);
          float x = __fadd_rn(__fmul_rn(s_[x_], scale), pad);
          if (decltype(edge)::value && causal)
            x = __fadd_rn(x, q0 + r0 + g + 8 * i >= k0 + c ? 0.0f : kNegInf);
          float p = exp2f(__fmul_rn(__fsub_rn(x, o ? mr[1][i] : mr[0][i]),
                                    kLog2e)) *
                    (o ? ilr[1][i] : ilr[0][i]);
          if (decltype(edge)::value && k0 + c >= T_) p = 0.0f;
          s_[x_] = __fmul_rn(
              __fmul_rn(p, __fsub_rn(dp[x_], o ? dr[1][i] : dr[0][i])), scale);
        }
    };
    if ((causal && k0 == q0) || k0 + kTile > T_)
      epilogue(std::true_type{});
    else
      epilogue(std::false_type{});
    // dQ += dS K: dS rounded to bf16 from registers, K read MN-major
    uint32_t a[4][4];
    to_a_frags(a, s_);
    wgmma_fence();
    wgmma_acc<D>(acc, a, sk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c) fence_regs(acc[c]);
  }
  if (!first_done)
    reduce_store<D>(acc, reinterpret_cast<float*>(res), dq, b, h,
                    w.tile(0) * kTile, T_, H);
  reduce_store<D>(acc, reinterpret_cast<float*>(res + 2 * (w.n_own - 1) * TB),
                  dq, b, h, w.tile(w.n_own - 1) * kTile, T_, H);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
fa_dkv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ mask,
             const bf16* __restrict__ g_out, const float* __restrict__ m_rows,
             const float* __restrict__ l_rows,
             const float* __restrict__ delta, bf16* __restrict__ dk,
             bf16* __restrict__ dv, int T_, int H, int causal, float scale) {
  constexpr int TB = WgTile<D>::kBytes, S = kStages<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* res = align_1k(smem_raw);       // [owned][K, V]
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  unsigned char* ring = res + (4 + wg * S * 2) * TB;   // [stage][Q, dO]
  float* srows = reinterpret_cast<float*>(res + (4 + 4 * S) * TB) +
                 wg * S * 3 * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const size_t base = static_cast<size_t>(bh) * T_;
  const Walk w = make_walk(true, (T_ + kTile - 1) / kTile, causal);

  auto issue = [&](int j) {
    const int q0 = w.walked(wg + 2 * j) * kTile, st = j % S;
    load_tile<D, kWgThreads>(ring + st * 2 * TB, q, b, h, q0, T_, H, tid);
    load_tile<D, kWgThreads>(ring + st * 2 * TB + TB, g_out, b, h, q0, T_,
                             H, tid);
    float* sr = srows + st * 3 * kTile;
    load_row(sr, m_rows + base, q0, T_, tid);
    load_row(sr + kTile, l_rows + base, q0, T_, tid);
    load_row(sr + 2 * kTile, delta + base, q0, T_, tid);
  };
  for (int o = 0; o < w.n_own; ++o) {
    load_tile<D, kBwdThreads>(res + 2 * o * TB, k, b, h, w.tile(o) * kTile,
                              T_, H, threadIdx.x);
    load_tile<D, kBwdThreads>(res + 2 * o * TB + TB, v, b, h,
                              w.tile(o) * kTile, T_, H, threadIdx.x);
  }
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (wg + 2 * j < w.steps) issue(j);
    cp_async_commit();
  }

  // pad terms of this lane's two keys of each owned tile
  float pad[2][2];
#pragma unroll
  for (int o = 0; o < 2; ++o)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = w.tile(o) * kTile + r0 + g + 8 * i;
      pad[o][i] =
          key < T_ ? __fmul_rn(__fsub_rn(1.0f, mask[static_cast<size_t>(b) *
                                                        T_ + key]),
                               kNegInf)
                   : 0.0f;
    }
  cp_async_wait<S - 1>();
  fence_async_smem();
  __syncthreads();

  AccRegs<D> dk_acc, dv_acc;
  zero<D>(dk_acc);
  zero<D>(dv_acc);
  bool first_done = w.n_own == 1;
  for (int j = 0; wg + 2 * j < w.steps; ++j) {
    const int s = wg + 2 * j;
    cp_async_wait<S - 2>();
    fence_async_smem();
    wg_sync(wg);
    if (s + 2 * (S - 1) < w.steps) issue(j + S - 1);
    cp_async_commit();

    const int o = w.slot(s), st = j % S;
    if (o == 1 && !first_done) {
      float* scratch = reinterpret_cast<float*>(res);
      reduce_store<D>(dk_acc, scratch, dk, b, h, w.tile(0) * kTile, T_, H);
      reduce_store<D>(dv_acc, scratch, dv, b, h, w.tile(0) * kTile, T_, H);
      first_done = true;
    }
    const int k0 = w.tile(o) * kTile, q0 = w.walked(s) * kTile;
    const uint32_t sk = smem_u32(res + 2 * o * TB), sv = sk + TB;
    const uint32_t sq = smem_u32(ring + st * 2 * TB), sg = sq + TB;
    const float* smr = srows + st * 3 * kTile;
    const float* slr = smr + kTile;
    const float* sdr = slr + kTile;
    // transposed blocks: rows are the owned tile's 64 keys, columns the Q
    // tile's rows: S^T = K Q^T, dP^T = V dO^T
    float p[32], ds[32];
    wgmma_fence();
    wgmma_scores<D>(p, sk, sq);
    wgmma_scores<D>(ds, sv, sg);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(p);
    fence_regs(ds);
    // m, 1/l and delta of this lane's 16 Q rows (columns); a row past T
    // was zero-filled, so its 1/l is 0 and its p and ds are 0. Keys past T
    // need no mask: their dK, dV rows are never stored.
    float cm[8][2], cil[8][2], cd[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int c = 8 * n + 2 * t + jj;
        cm[n][jj] = smr[c];
        cil[n][jj] = slr[c] > 0.0f ? __frcp_rn(slr[c]) : 0.0f;
        cd[n][jj] = sdr[c];
      }
    // only the diagonal tile (the first a causal owned tile walks) needs
    // the causal term
    auto epilogue = [&](auto diag) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, jj = e & 1, x_ = 4 * n + e;
          float x = __fadd_rn(__fmul_rn(p[x_], scale),
                              o ? pad[1][i] : pad[0][i]);
          if (decltype(diag)::value)
            x = __fadd_rn(x, 8 * n + 2 * t + jj >= r0 + g + 8 * i ? 0.0f
                                                                  : kNegInf);
          const float pv =
              exp2f(__fmul_rn(__fsub_rn(x, cm[n][jj]), kLog2e)) * cil[n][jj];
          p[x_] = pv;
          ds[x_] = __fmul_rn(__fmul_rn(pv, __fsub_rn(ds[x_], cd[n][jj])),
                             scale);
        }
    };
    if (causal && q0 == k0)
      epilogue(std::true_type{});
    else
      epilogue(std::false_type{});
    // dV += P^T dO and dK += dS^T Q: P^T and dS^T rounded to bf16 from
    // registers, dO and Q read MN-major
    uint32_t pa[4][4], da[4][4];
    to_a_frags(pa, p);
    to_a_frags(da, ds);
    wgmma_fence();
    wgmma_acc<D>(dv_acc, pa, sg);
    wgmma_acc<D>(dk_acc, da, sq);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c) {
      fence_regs(dk_acc[c]);
      fence_regs(dv_acc[c]);
    }
  }
  if (!first_done) {
    float* scratch = reinterpret_cast<float*>(res);
    reduce_store<D>(dk_acc, scratch, dk, b, h, w.tile(0) * kTile, T_, H);
    reduce_store<D>(dv_acc, scratch, dv, b, h, w.tile(0) * kTile, T_, H);
  }
  const int k_last = w.tile(w.n_own - 1) * kTile;
  float* scratch = reinterpret_cast<float*>(res + 2 * (w.n_own - 1) * TB);
  reduce_store<D>(dk_acc, scratch, dk, b, h, k_last, T_, H);
  reduce_store<D>(dv_acc, scratch, dv, b, h, k_last, T_, H);
}

// ------------------------------------------- forward (bf16, tensor cores)
// Replaces _fa_kernel for bf16 with head_dim 16, 32, 64 or 128, on the
// backward's machinery (above): a block owns one Q tile, or when causal the
// pair (p, n - 1 - p) (make_walk), and walks its KV tiles; two warpgroups
// take alternate steps of the walk, each with its own cp.async ring of K, V
// and keep-mask rows, its own barrier and its own (acc, m, l) per owned
// tile.
//   - Products: S = Q K^T by wgmma_ss64 (both tiles K-major in shared
//     memory); O += bf16(P) V with A from registers (the score accumulator,
//     rounded to bf16 — the reference's cast point) and V read MN-major, as
//     dQ += dS K does.
//   - Epilogue: the score keeps the reference's three f32 roundings (scaled
//     product, pad term, causal term); the causal term on the diagonal tile
//     only, keys past T (p = 0) on the last tile only; m_new = max(m, tile
//     max), alpha = exp2((m - m_new) log2 e), p = exp2((s - m_new) log2 e),
//     l = l alpha + rowsum(p) (unrounded p), acc = acc alpha + bf16(p) V.
//   - Merge: when an owned tile is done, the two warpgroups' states merge
//     in a fixed order, warpgroup 0's then warpgroup 1's: m = max(m0, m1),
//     l = l0 e^(m0 - m) + l1 e^(m1 - m), acc the same way, out = acc /
//     max(l, 1e-30). m is exactly the running max from NEG_INF, m and l
//     are stored apart; a fully padded row sees every score equal to -1e9,
//     so every p and every factor is exactly 1 and l counts its keys.

template <int D>
struct FwdSmem {
  static constexpr size_t kTileBytes = WgTile<D>::kBytes;
  static constexpr size_t kRing = 2 * kStages<D>;   // stages, both rings
  static constexpr size_t kAccFloats = Acc<D>::kBlocks * Acc<D>::kRegs + 4;
  // 1 KB for the alignment; two resident Q tiles; per stage K, V and the
  // keep-mask row; the merge's scratch (warpgroup 1's acc, m, l)
  static constexpr size_t kBytes = 1024 + (2 + 2 * kRing) * kTileBytes +
                                   4 * kRing * kTile + 4 * 128 * kAccFloats;
};

// The two warpgroups' (acc, m, l) of one owned tile merged in a fixed order
// (warpgroup 0's, then warpgroup 1's) through `scratch`, divided and stored
// by warpgroup 0 with the tile's m and l rows; leaves both states reset.
template <int D>
__device__ __forceinline__ void merge_store(AccRegs<D>& acc, float (&m)[2],
                                            float (&l)[2], float* scratch,
                                            bf16* __restrict__ out,
                                            float* __restrict__ m_out,
                                            float* __restrict__ l_out, int b,
                                            int h, int bh, int row0, int T_,
                                            int H) {
  constexpr int NA = Acc<D>::kBlocks * Acc<D>::kRegs;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  block_sync();   // warpgroup 0 is done with the scratch's last use
  if (wg == 1) {
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c)
#pragma unroll
      for (int i = 0; i < Acc<D>::kRegs; ++i)
        scratch[(c * Acc<D>::kRegs + i) * 128 + tid] = acc[c][i];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      scratch[(NA + i) * 128 + tid] = m[i];
      scratch[(NA + 2 + i) * 128 + tid] = l[i];
    }
  }
  block_sync();
  if (wg == 0) {
    float f0[2], f1[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m1 = scratch[(NA + i) * 128 + tid];
      const float l1 = scratch[(NA + 2 + i) * 128 + tid];
      const float mm = fmaxf(m[i], m1);
      f0[i] = exp2f(__fmul_rn(__fsub_rn(m[i], mm), kLog2e));
      f1[i] = exp2f(__fmul_rn(__fsub_rn(m1, mm), kLog2e));
      l[i] = fmaxf(__fadd_rn(__fmul_rn(l[i], f0[i]), __fmul_rn(l1, f1[i])),
                   1e-30f);
      m[i] = mm;
    }
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c)
#pragma unroll
      for (int x = 0; x < Acc<D>::kRegs; ++x) {
        const int i = (x & 3) >> 1;
        const float a1 = scratch[(c * Acc<D>::kRegs + x) * 128 + tid];
        acc[c][x] = __fdiv_rn(__fadd_rn(__fmul_rn(acc[c][x], f0[i]),
                                        __fmul_rn(a1, f1[i])),
                              l[i]);
      }
    store_acc<D>(out, acc, b, h, row0, T_, H);
    const int lane = threadIdx.x & 31, g = lane >> 2;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 16 * (tid >> 5) + g + 8 * i;
        if (row < T_) {
          m_out[static_cast<size_t>(bh) * T_ + row] = m[i];
          l_out[static_cast<size_t>(bh) * T_ + row] = l[i];
        }
      }
    }
  }
  zero<D>(acc);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
fa_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ mask,
             bf16* __restrict__ out, float* __restrict__ m_out,
             float* __restrict__ l_out, int T_, int H, int causal,
             float scale) {
  constexpr int TB = WgTile<D>::kBytes, S = kStages<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* res = align_1k(smem_raw);       // [owned] Q
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  unsigned char* ring = res + (2 + wg * S * 2) * TB;   // [stage][K, V]
  float* masks = reinterpret_cast<float*>(res + (2 + 4 * S) * TB);
  float* smask = masks + wg * S * kTile;
  float* scratch = masks + 2 * S * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (tid >> 5);
  const Walk w = make_walk(false, (T_ + kTile - 1) / kTile, causal);

  // this warpgroup's j-th step is step wg + 2 j of the walk
  auto issue = [&](int j) {
    const int k0 = w.walked(wg + 2 * j) * kTile, st = j % S;
    load_tile<D, kWgThreads>(ring + st * 2 * TB, k, b, h, k0, T_, H, tid);
    load_tile<D, kWgThreads>(ring + st * 2 * TB + TB, v, b, h, k0, T_, H,
                             tid);
    load_row(smask + st * kTile, mask + static_cast<size_t>(b) * T_, k0, T_,
             tid);
  };
  for (int o = 0; o < w.n_own; ++o)
    load_tile<D, kBwdThreads>(res + o * TB, q, b, h, w.tile(o) * kTile, T_,
                              H, threadIdx.x);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (wg + 2 * j < w.steps) issue(j);
    cp_async_commit();
  }
  cp_async_wait<S - 1>();   // the resident Q tiles, copied by both
  fence_async_smem();
  __syncthreads();

  AccRegs<D> acc;
  zero<D>(acc);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  bool first_done = w.n_own == 1;   // owned tile 0's outputs are stored
  for (int j = 0; wg + 2 * j < w.steps; ++j) {
    const int s = wg + 2 * j;
    cp_async_wait<S - 2>();   // step j has landed ...
    fence_async_smem();
    wg_sync(wg);              // ... for the warpgroup; step j - 1 is done
    if (s + 2 * (S - 1) < w.steps) issue(j + S - 1);   // into j - 1's stage
    cp_async_commit();

    const int o = w.slot(s), st = j % S;
    if (o == 1 && !first_done) {   // both warpgroups are past tile 0
      merge_store<D>(acc, m, l, scratch, out, m_out, l_out, b, h, bh,
                     w.tile(0) * kTile, T_, H);
      first_done = true;
    }
    const int q0 = w.tile(o) * kTile, k0 = w.walked(s) * kTile;
    const uint32_t sq = smem_u32(res + o * TB);
    const uint32_t sk = smem_u32(ring + st * 2 * TB), sv = sk + TB;
    const float* sm = smask + st * kTile;
    float s_[32];
    wgmma_fence();
    wgmma_scores<D>(s_, sq, sk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_);
    // scores in place of s_, then p; only a tile that crosses the diagonal
    // or holds keys past T (the last one) checks each element
    float mx[2] = {-INFINITY, -INFINITY};
    auto scores = [&](auto edge) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * n + 2 * t + (e & 1), x_ = 4 * n + e;
          const float pad = __fmul_rn(__fsub_rn(1.0f, sm[c]), kNegInf);
          float x = __fadd_rn(__fmul_rn(s_[x_], scale), pad);
          if (decltype(edge)::value) {
            if (causal)
              x = __fadd_rn(x, q0 + r0 + g + 8 * i >= k0 + c ? 0.0f
                                                              : kNegInf);
            if (k0 + c >= T_) x = -INFINITY;
          }
          s_[x_] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    };
    if ((causal && k0 == q0) || k0 + kTile > T_)
      scores(std::true_type{});
    else
      scores(std::false_type{});
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = exp2f(__fmul_rn(__fsub_rn(m[i], m_new), kLog2e));
      m[i] = m_new;
    }
#pragma unroll
    for (int x_ = 0; x_ < 32; ++x_) {
      const int i = (x_ & 3) >> 1;
      s_[x_] = exp2f(__fmul_rn(__fsub_rn(s_[x_], m[i]), kLog2e));
      sum[i] += s_[x_];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha[i]), quad_sum(sum[i]));
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c)
#pragma unroll
      for (int x_ = 0; x_ < Acc<D>::kRegs; ++x_)
        acc[c][x_] = __fmul_rn(acc[c][x_], alpha[(x_ & 3) >> 1]);
    // O += P V: P rounded to bf16 from registers, V read MN-major
    uint32_t a[4][4];
    to_a_frags(a, s_);
    wgmma_fence();
    wgmma_acc<D>(acc, a, sv);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < Acc<D>::kBlocks; ++c) fence_regs(acc[c]);
  }
  if (!first_done)
    merge_store<D>(acc, m, l, scratch, out, m_out, l_out, b, h, bh,
                   w.tile(0) * kTile, T_, H);
  merge_store<D>(acc, m, l, scratch, out, m_out, l_out, b, h, bh,
                 w.tile(w.n_own - 1) * kTile, T_, H);
}

template <int D>
size_t bwd_smem(int kernel) {
  return kernel == 1 ? BwdSmem<D>::kDkv : BwdSmem<D>::kDq;
}

size_t smem_bytes(int kernel, int D, bool bf16_in) {
  if (bf16_in && mma_head_dim(D)) {
    if (kernel == 0) {
      switch (D) {
        case 16: return FwdSmem<16>::kBytes;
        case 32: return FwdSmem<32>::kBytes;
        case 64: return FwdSmem<64>::kBytes;
        default: return FwdSmem<128>::kBytes;
      }
    }
    switch (D) {
      case 16: return bwd_smem<16>(kernel);
      case 32: return bwd_smem<32>(kernel);
      case 64: return bwd_smem<64>(kernel);
      default: return bwd_smem<128>(kernel);
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

// one block per 64-row tile and (batch, head)
dim3 grid_for(int B, int T_, int H) {
  return dim3((T_ + kTile - 1) / kTile, B * H);
}

// the tensor-core backward: one block per owned tile, or per pair of
// owned tiles when causal (see make_walk)
dim3 grid_bwd(int B, int T_, int H, int causal) {
  const int n = (T_ + kTile - 1) / kTile;
  return dim3(causal ? (n + 1) / 2 : n, B * H);
}

// one launch: the kernel's shared-memory opt-in, then the launch itself
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, size_t smem, dim3 grid,
                   cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
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
  launch(fa_fwd_wgmma<DD>, kBwdThreads, smem, grid_bwd(B, T_, H, causal), st, qb, kb, vb, msk, \
         ob, mo, lo, T_, H, causal, scale)
    KUBEML_MMA_DISPATCH(D, KUBEML_FWD)
#undef KUBEML_FWD
  }
  if (bf16_in)
    return launch(fa_fwd_kernel<bf16>, kThreads, smem, grid_for(B, T_, H), st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), msk, static_cast<bf16*>(out),
                  mo, lo, T_, H, D, causal, scale);
  return launch(fa_fwd_kernel<float>, kThreads, smem, grid_for(B, T_, H), st,
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
  launch(fa_dkv_wgmma<DD>, kBwdThreads, smem, grid_bwd(B, T_, H, causal), st, qb, kb, vb, msk, \
         gb, mr, lr, dr, dkb, dvb, T_, H, causal, scale)
    KUBEML_MMA_DISPATCH(D, KUBEML_DKV)
#undef KUBEML_DKV
  }
  if (bf16_in)
    return launch(fa_dkv_kernel<bf16>, kThreads, smem, grid_for(B, T_, H), st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), msk,
                  static_cast<const bf16*>(g), mr, lr, dr,
                  static_cast<bf16*>(dk), static_cast<bf16*>(dv), T_, H, D,
                  causal, scale);
  return launch(fa_dkv_kernel<float>, kThreads, smem, grid_for(B, T_, H), st,
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
  launch(fa_dq_wgmma<DD>, kBwdThreads, smem, grid_bwd(B, T_, H, causal), st, qb, kb, vb, msk, \
         gb, mr, lr, dr, dqb, T_, H, causal, scale)
    KUBEML_MMA_DISPATCH(D, KUBEML_DQ)
#undef KUBEML_DQ
  }
  if (bf16_in)
    return launch(fa_dq_kernel<bf16>, kThreads, smem, grid_for(B, T_, H), st,
                  static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), msk,
                  static_cast<const bf16*>(g), mr, lr, dr,
                  static_cast<bf16*>(dq), T_, H, D, causal, scale);
  return launch(fa_dq_kernel<float>, kThreads, smem, grid_for(B, T_, H), st,
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
