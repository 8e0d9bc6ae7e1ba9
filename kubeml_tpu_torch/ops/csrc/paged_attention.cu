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
// What bounds it: device-memory bytes and, at these sizes, latency. Per call
// it must read the K and V pages the slot's context really uses (the rest of
// the table points at the null page and is masked by the bias), the bias
// and q; its arithmetic is 4 * S * H * T * C * D operations, far below the
// card's rate at T <= 16. The serving path's calls are small (a decode call
// moves ~0.2 MB, a prefill call of one slot ~0.1 MB), so what sets the time
// is how many SMs share the work and how many dependent round trips each
// one makes.
//
// Design (bf16 and int8 pages, pa_cluster_kernel): a thread-block cluster of
// nr = min(8, Pmax) blocks per (head, slot). Rank r of the cluster takes
// pages r, r + nr, r + 2 nr, ... (interleaved, so a live prefix spreads
// evenly over the ranks). Each rank:
//   1. reads its pages' ids and its columns of the bias (the bias lands in
//      the score buffer, where the scores are later added to it); a page
//      whose bias is <= NEG_INF/2 in every row is dead, a row with a bias
//      above NEG_INF/2 anywhere is live;
//   2. starts cp.async copies of its live pages' K, then V rows (two commit
//      groups: the scores wait for K only, so V lands behind them);
//   3. cluster barrier; every rank reads every rank's row flags through
//      distributed shared memory (DSMEM). If every row has a live column
//      somewhere in C, dead pages are skipped exactly: their bias makes
//      exp(score - m) exactly 0.0 in f32 (m is a live score), so they add
//      nothing to the sum or to P.V and never set the max. A row with no
//      live column (an inactive decode slot) is not uniform in the
//      reference (-1e9 + q.k.scale rounds per column), so then every page
//      is copied and computed, as the reference does;
//   4. scores: T >= 2 on the tensor cores (mma.sync m16n8k16, bf16 operands,
//      f32 accumulators; a 16-token prefill chunk is one m16 tile, where
//      wgmma's 64 rows would waste three quarters), q staged once as bf16;
//      T = 1 (decode) on f32 FMAs, one thread per context token;
//   5. the row maxima, then the row sums, are exchanged through DSMEM: the
//      max is exact and order-free; the sum is added in rank order, so every
//      rank divides by the same global sum and forms the reference's
//      bf16(e / sum);
//   6. its f32 P.V partial (tensor cores for T >= 2, FMAs for T = 1) goes to
//      shared memory; after a cluster barrier each rank adds a slice of the
//      outputs over the ranks' partials in rank order through DSMEM (no
//      atomics) and writes it.
// The cluster size and the page assignment depend on Pmax only, never on S,
// so a slot's output is bit-identical whether it is served alone or in a
// batch. A refused cluster launch reports through cudaGetLastError(), which
// the C entry returns.
//
// The f32 instantiation (gpt-nano's f32 check, off the main path) keeps the
// first version's body, pa_kernel: one 512-thread block per (head, slot)
// that walks its page-table row twice (scores, then PV), staging tiles of
// `tile_pages` pages as f32 rows of D+1 in shared memory, with the [T, C]
// score rows kept there between the walks.
//
// Later work: a cluster larger than 8 (non-portable) or a split of the
// prefill call's query rows, so more than 8 SMs serve one (head, slot) at
// S = 1; TMA copies of whole pages.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kTileTokens = 256;  // context tokens staged per round
constexpr float kNegInf = -1e9f;  // the reference's NEG_INF

// pages staged per round: kTileTokens of context, at least one page
int tile_pages_for(int G, int Pmax) {
  const int tp = kTileTokens / G;
  return tp < 1 ? 1 : (tp > Pmax ? Pmax : tp);
}

// one page element as an f32 value: int8 dequantized as float(x) * scale
template <typename PT>
__device__ __forceinline__ float page_value(PT x, float scale) {
  if constexpr (std::is_same<PT, int8_t>::value) {
    return static_cast<float>(x) * scale;
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

// ------------------------------------------------- f32: the first version
// Stage pages pids[j0 .. j0+np) of head h into dst as [np*G, D+1] f32 rows
// (the +1 keeps row-strided reads free of bank
// conflicts). Each thread moves 16-byte vectors (D * sizeof(PT) is a
// multiple of 16; the wrapper checks), issuing kUnroll loads before it
// converts any, so several loads are in flight per thread.
template <typename PT>
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
        for (int k = 0; k < kVec; ++k) o[k] = page_value<PT>(e[k], scale);
      }
    }
  }
}

template <typename PT>
__global__ void __launch_bounds__(kThreads)
pa_kernel(const float* __restrict__ q, const PT* __restrict__ k_pages,
          const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
          const float* __restrict__ v_scale,
          const int32_t* __restrict__ tables, const float* __restrict__ bias,
          float* __restrict__ out, int T, int H, int D, int G, int Pmax,
          int P, int tile_pages, float scale) {
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
    sq[i] = q[((static_cast<size_t>(s) * T + t) * H + h) * D + d];
  }
  for (int i = tid; i < nsplit * O; i += blockDim.x) sacc[i] = 0.0f;

  // walk 1: scores[t, c] = (q[t] . k[c]) * scale + bias[t, c]
  for (int j0 = 0; j0 < Pmax; j0 += tile_pages) {
    const int rows = min(tile_pages, Pmax - j0) * G;
    __syncthreads();  // every reader of the previous tile is done
    stage_tile<PT>(skv, k_pages, k_scale, pids, j0, rows / G, h, H, D, G);
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

  // full-row f32 softmax, one warp per row
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
    for (int c = lane; c < C; c += 32) r[c] = r[c] / sum;
  }

  // walk 2: out[t, d] = sum_c w[t, c] * v[c, d], accumulated in f32. Work
  // item i = (group, output): when a block has more threads than outputs
  // (decode), `nsplit` groups each sum every nsplit-th context row
  for (int j0 = 0; j0 < Pmax; j0 += tile_pages) {
    const int rows = min(tile_pages, Pmax - j0) * G;
    __syncthreads();
    stage_tile<PT>(skv, v_pages, v_scale, pids, j0, rows / G, h, H, D, G);
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
    out[((static_cast<size_t>(s) * T + t) * H + h) * D + d] = v;
  }
}

// Shared memory of one pa_kernel block (4-byte words): scores [T, C],
// queries [T, D], PV partials [max(T*D, threads)], one tile
// [tile_pages*G, D+1], the slot's page ids [Pmax].
size_t f32_smem_bytes(int T, int D, int G, int Pmax) {
  const size_t O = static_cast<size_t>(T) * D;
  const int tile_pages = tile_pages_for(G, Pmax);
  return 4 * (static_cast<size_t>(T) * Pmax * G + O
              + (O > kThreads ? O : static_cast<size_t>(kThreads))
              + static_cast<size_t>(tile_pages) * G * (D + 1) + Pmax);
}

template <typename PT>
cudaError_t launch_f32(const void* q, const void* k_pages,
                       const void* v_pages, const void* k_scale,
                       const void* v_scale, const void* tables,
                       const void* bias, void* out, int S, int T, int H,
                       int D, int G, int Pmax, int P, float scale,
                       cudaStream_t stream) {
  auto kernel = pa_kernel<PT>;
  const int tile_pages = tile_pages_for(G, Pmax);
  const size_t smem = f32_smem_bytes(T, D, G, Pmax);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(H, S);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const float*>(bias),
      static_cast<float*>(out), T, H, D, G, Pmax, P, tile_pages, scale);
  return cudaGetLastError();
}

// --------------------------------------- bf16 and int8 pages: the cluster
using bf16 = __nv_bfloat16;

constexpr int kClusterMax = 8;   // the portable cluster size
constexpr int kPaThreads = 128;  // 4 warps per rank
constexpr int kChunk = 8;        // context tokens per n8 (or k8) slice

__host__ __device__ __forceinline__ int cluster_for(int Pmax) {
  return Pmax < kClusterMax ? Pmax : kClusterMax;
}

// Shared-memory layout of one rank (bytes), the same on every rank of a
// cluster (DSMEM reads use the same offsets remotely). npr = pages of the
// rank with the most; cols = npr * G context columns.
struct PaSmem {
  int npr, cols, ldsc, rowb, ldq, ng;
  size_t k, v, sc, part, gpart, qb, qf, pid, psk, psv, plive, cc, rowlive,
      rmax, rsum, misc, total;

  __host__ __device__ PaSmem(int T, int D, int G, int Pmax, int elem) {
    const int nr = cluster_for(Pmax);
    npr = (Pmax + nr - 1) / nr;
    cols = npr * G;
    ldsc = cols + 4;                 // score rows: f32, 4 words of padding
    rowb = D * elem + 16;            // K/V rows: raw page bytes + 16
    ldq = ((D + 15) / 16) * 16 + 8;  // bf16 query rows, zero past D
    ng = D < kPaThreads ? kPaThreads / D : 1;   // decode P.V groups
    const size_t tpad = ((T + 15) / 16) * 16;
    size_t o = 0;
    k = o;
    o += r16(static_cast<size_t>(cols) * rowb);
    v = o;
    o += r16(static_cast<size_t>(cols) * rowb);
    sc = o;
    o += r16(4 * static_cast<size_t>(T) * ldsc);
    part = o;
    o += r16(4 * static_cast<size_t>(T) * D);
    gpart = o;
    o += r16(4 * static_cast<size_t>(ng) * D);
    qb = o;
    o += r16(2 * tpad * ldq);
    qf = o;
    o += r16(4 * static_cast<size_t>(D));
    pid = o;
    o += r16(4 * static_cast<size_t>(npr));
    psk = o;
    o += r16(4 * static_cast<size_t>(npr));
    psv = o;
    o += r16(4 * static_cast<size_t>(npr));
    plive = o;
    o += r16(4 * static_cast<size_t>(npr));
    cc = o;
    o += r16(4 * static_cast<size_t>(cols / kChunk + 1));
    rowlive = o;
    o += r16(4 * static_cast<size_t>(T));
    rmax = o;
    o += r16(4 * static_cast<size_t>(T));
    rsum = o;
    o += r16(4 * static_cast<size_t>(T));
    misc = o;
    o += 16;
    total = o;
  }

  // bytes rounded up to 16, so every region starts 16-byte aligned
  __host__ __device__ static size_t r16(size_t bytes) {
    return (bytes + 15) / 16 * 16;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two f32 values rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the reference's dequant of one int8 page element: bf16(float(x) * scale)
__device__ __forceinline__ bf16 dequant(int8_t x, float scale) {
  return __float2bfloat16(__fmul_rn(static_cast<float>(x), scale));
}

__device__ __forceinline__ uint16_t bf16_bits(bf16 x) {
  return *reinterpret_cast<uint16_t*>(&x);
}

// the bits of element d of a staged K/V row, as bf16
template <typename PT>
__device__ __forceinline__ uint16_t kv_bits(const unsigned char* row, int d,
                                            float scale) {
  if constexpr (std::is_same<PT, int8_t>::value) {
    return bf16_bits(dequant(static_cast<int8_t>(row[d]), scale));
  } else {
    return reinterpret_cast<const uint16_t*>(row)[d];
  }
}

// elements d, d + 1 of a staged K/V row as a packed bf16 pair (0 past D)
template <typename PT>
__device__ __forceinline__ uint32_t kv_pair(const unsigned char* row, int d,
                                            int D, float scale) {
  if (d >= D) return 0u;
  if constexpr (std::is_same<PT, int8_t>::value) {
    const uint16_t two = *reinterpret_cast<const uint16_t*>(row + d);
    return static_cast<uint32_t>(
               bf16_bits(dequant(static_cast<int8_t>(two & 0xff), scale))) |
           static_cast<uint32_t>(
               bf16_bits(dequant(static_cast<int8_t>(two >> 8), scale)))
               << 16;
  } else {
    return *reinterpret_cast<const uint32_t*>(row + 2 * d);
  }
}

__device__ __forceinline__ float bits_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy the K and V rows of this rank's pages i (0 <= i < npr) for which
// want(i) holds into their slots (page i at rows i*G ..), 16 bytes a copy:
// all K rows, commit, all V rows, commit.
template <typename PT, typename Want>
__device__ __forceinline__ void issue_pages(
    unsigned char* sk, unsigned char* sv, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const int* pid, int npr, int G, int H,
    int h, int D, int rowb, Want want) {
  const int vpr = D * static_cast<int>(sizeof(PT)) / 16;
  const int n = npr * G * vpr;
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {
    const PT* pages = kv ? v_pages : k_pages;
    unsigned char* dst = kv ? sv : sk;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / vpr, vc = e - r * vpr;   // r = i * G + g
      const int i = r / G, g = r - i * G;
      if (!want(i)) continue;
      cp_async16(dst + static_cast<size_t>(r) * rowb + vc * 16,
                 pages + ((static_cast<size_t>(pid[i]) * G + g) * H + h) * D +
                     vc * (16 / static_cast<int>(sizeof(PT))));
    }
    cp_async_commit();
  }
}

template <typename PT, bool kMma>
__global__ void __launch_bounds__(kPaThreads)
pa_cluster_kernel(const bf16* __restrict__ q, const PT* __restrict__ k_pages,
                  const PT* __restrict__ v_pages,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  const int32_t* __restrict__ tables,
                  const float* __restrict__ bias, bf16* __restrict__ out,
                  int T, int H, int D, int G, int Pmax, int P, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char pa_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const PaSmem L(T, D, G, Pmax, static_cast<int>(sizeof(PT)));
  const int nr = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = kPaThreads / 32;
  const int C = Pmax * G;
  unsigned char* sk = pa_smem + L.k;
  unsigned char* sv = pa_smem + L.v;
  float* sc = reinterpret_cast<float*>(pa_smem + L.sc);     // [T, ldsc]
  float* part = reinterpret_cast<float*>(pa_smem + L.part); // [T, D]
  int* pid = reinterpret_cast<int*>(pa_smem + L.pid);
  float* psk = reinterpret_cast<float*>(pa_smem + L.psk);
  float* psv = reinterpret_cast<float*>(pa_smem + L.psv);
  int* plive = reinterpret_cast<int*>(pa_smem + L.plive);
  int* cc = reinterpret_cast<int*>(pa_smem + L.cc);         // computed chunks
  int* rowlive = reinterpret_cast<int*>(pa_smem + L.rowlive);
  float* rmax = reinterpret_cast<float*>(pa_smem + L.rmax);
  float* rsum = reinterpret_cast<float*>(pa_smem + L.rsum);
  int* misc = reinterpret_cast<int*>(pa_smem + L.misc);
  const int npr = (Pmax - rank + nr - 1) / nr;   // pages rank, rank + nr, ..
  const int ncols = npr * G;
  const int ldsc = L.ldsc, rowb = L.rowb;
  const int32_t* trow = tables + static_cast<size_t>(s) * Pmax;
  const float* brow = bias + static_cast<size_t>(s) * T * C;

  // 1. page ids (an out-of-range id reads the null page, like the
  // reference's clamped gather), scales, the queries, the bias
  for (int i = tid; i < npr; i += kPaThreads) {
    const int p = min(max(trow[rank + i * nr], 0), P - 1);
    pid[i] = p;
    plive[i] = 0;
    if (kQuant) {
      psk[i] = k_scale[p];
      psv[i] = v_scale[p];
    }
  }
  for (int t = tid; t < T; t += kPaThreads) rowlive[t] = 0;
  if constexpr (kMma) {
    bf16* qb = reinterpret_cast<bf16*>(pa_smem + L.qb);
    const int tpad = ((T + 15) / 16) * 16;
    for (int e = tid; e < tpad * L.ldq; e += kPaThreads) {
      const int t = e / L.ldq, d = e - t * L.ldq;
      qb[e] = t < T && d < D
                  ? q[((static_cast<size_t>(s) * T + t) * H + h) * D + d]
                  : __float2bfloat16(0.0f);
    }
  } else {
    float* qf = reinterpret_cast<float*>(pa_smem + L.qf);
    for (int d = tid; d < D; d += kPaThreads)
      qf[d] = __bfloat162float(q[(static_cast<size_t>(s) * H + h) * D + d]);
  }
  __syncthreads();
  for (int e = tid; e < T * ncols; e += kPaThreads) {
    const int t = e / ncols, c = e - t * ncols;
    const int i = c / G, g = c - i * G;
    const float b = brow[static_cast<size_t>(t) * C + (rank + i * nr) * G + g];
    sc[t * ldsc + c] = b;
    if (b > 0.5f * kNegInf) {   // benign races: every writer stores 1
      plive[i] = 1;
      rowlive[t] = 1;
    }
  }
  __syncthreads();

  // 2. the live pages' K and V rows, behind everything below
  issue_pages<PT>(sk, sv, k_pages, v_pages, pid, npr, G, H, h, D, rowb,
                  [&](int i) { return plive[i] != 0; });

  // 3. is every row live somewhere in the cluster's context?
  cluster.sync();
  int mine = 1;
  for (int t = tid; t < T; t += kPaThreads) {
    int any = 0;
    for (int r = 0; r < nr; ++r) any |= *cluster.map_shared_rank(rowlive + t, r);
    mine &= any != 0;
  }
  const bool skip = __syncthreads_and(mine) != 0;
  if (!skip)   // a row with no live column: every page, as the reference
    issue_pages<PT>(sk, sv, k_pages, v_pages, pid, npr, G, H, h, D, rowb,
                    [&](int i) { return plive[i] == 0; });
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < npr; ++i)
      if (!skip || plive[i])
        for (int x = 0; x < G; x += kChunk) cc[n++] = i * G + x;
    misc[0] = n;
  }
  cp_async_wait<1>();   // every K copy has landed (V may still fly)
  __syncthreads();
  const int nch = misc[0];

  // 4. scores: sc[t, c] = (q[t] . k[c]) * scale + bias[t, c]
  if constexpr (kMma) {
    const bf16* qb = reinterpret_cast<const bf16*>(pa_smem + L.qb);
    const int g = lane >> 2, t4 = lane & 3;
    for (int m0 = 0; m0 < T; m0 += 16) {
      for (int u = warp; u < nch; u += nwarps) {
        const int col0 = cc[u];
        const unsigned char* krow = sk + static_cast<size_t>(col0 + g) * rowb;
        const float ks = kQuant ? psk[(col0 + g) / G] : 0.0f;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int k0 = 0; k0 < D; k0 += 16) {
          const bf16* pa = qb + (m0 + g) * L.ldq + k0 + 2 * t4;
          const uint32_t a[4] = {
              *reinterpret_cast<const uint32_t*>(pa),
              *reinterpret_cast<const uint32_t*>(pa + 8 * L.ldq),
              *reinterpret_cast<const uint32_t*>(pa + 8),
              *reinterpret_cast<const uint32_t*>(pa + 8 * L.ldq + 8)};
          mma16816(acc, a, kv_pair<PT>(krow, k0 + 2 * t4, D, ks),
                   kv_pair<PT>(krow, k0 + 2 * t4 + 8, D, ks));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = m0 + g + 8 * (e >> 1), c = col0 + 2 * t4 + (e & 1);
          // scale, then add the bias: two roundings, as the reference does
          if (t < T)
            sc[t * ldsc + c] =
                __fadd_rn(__fmul_rn(acc[e], scale), sc[t * ldsc + c]);
        }
      }
    }
  } else {
    const float* qf = reinterpret_cast<const float*>(pa_smem + L.qf);
    for (int x = tid; x < nch * kChunk; x += kPaThreads) {
      const int c = cc[x / kChunk] + x % kChunk;
      const unsigned char* krow = sk + static_cast<size_t>(c) * rowb;
      const float ks = kQuant ? psk[c / G] : 0.0f;
      float a0 = 0.0f, a1 = 0.0f;
      for (int d = 0; d < D; d += 8) {
        float kv[8];
        if constexpr (kQuant) {
          const uint2 raw = *reinterpret_cast<const uint2*>(krow + d);
          const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            kv[j] = __bfloat162float(dequant(e[j], ks));
        } else {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + 2 * d);
          const uint16_t* e = reinterpret_cast<const uint16_t*>(&raw);
#pragma unroll
          for (int j = 0; j < 8; ++j) kv[j] = bits_float(e[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; j += 2) {
          a0 = fmaf(qf[d + j], kv[j], a0);
          a1 = fmaf(qf[d + j + 1], kv[j + 1], a1);
        }
      }
      sc[c] = __fadd_rn(__fmul_rn(a0 + a1, scale), sc[c]);
    }
  }
  __syncthreads();

  // 5. the row max over the cluster (exact), then exp and the row sum over
  // the cluster, added in rank order
  for (int t = warp; t < T; t += nwarps) {
    float m = -INFINITY;
    for (int x = lane; x < nch * kChunk; x += 32)
      m = fmaxf(m, sc[t * ldsc + cc[x / kChunk] + x % kChunk]);
    m = warp_max(m);
    if (lane == 0) rmax[t] = m;
  }
  cluster.sync();
  for (int t = warp; t < T; t += nwarps) {
    float m = lane < nr ? *cluster.map_shared_rank(rmax + t, lane)
                        : -INFINITY;
    m = warp_max(m);
    float sum = 0.0f;
    for (int x = lane; x < nch * kChunk; x += 32) {
      float* p = sc + t * ldsc + cc[x / kChunk] + x % kChunk;
      const float e = expf(*p - m);
      *p = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) rsum[t] = sum;
  }
  cluster.sync();
  for (int t = warp; t < T; t += nwarps) {
    float sum = 0.0f;
    for (int r = 0; r < nr; ++r) sum += *cluster.map_shared_rank(rsum + t, r);
    for (int x = lane; x < nch * kChunk; x += 32) {
      float* p = sc + t * ldsc + cc[x / kChunk] + x % kChunk;
      *p = __bfloat162float(__float2bfloat16(__fdiv_rn(*p, sum)));
    }
  }
  cp_async_wait<0>();   // the V copies
  __syncthreads();

  // 6. this rank's P.V partial: part[t, d] = sum_c w[t, c] v[c, d] in f32
  if constexpr (kMma) {
    const int g = lane >> 2, t4 = lane & 3;
    for (int m0 = 0; m0 < T; m0 += 16) {
      const int r0 = m0 + g, r1 = r0 + 8;
      const float* w0 = sc + r0 * ldsc;
      const float* w1 = sc + r1 * ldsc;
      for (int n0 = 8 * warp; n0 < D; n0 += 8 * nwarps) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int j = 0; j < nch; j += 2) {
          // k = 16 context tokens: chunk j (k 0..7), chunk j + 1 (k 8..15)
          const int ca = cc[j], cb = j + 1 < nch ? cc[j + 1] : -1;
          uint32_t a[4] = {0u, 0u, 0u, 0u}, b1 = 0u;
          if (r0 < T) a[0] = pack_bf16(w0[ca + 2 * t4], w0[ca + 2 * t4 + 1]);
          if (r1 < T) a[1] = pack_bf16(w1[ca + 2 * t4], w1[ca + 2 * t4 + 1]);
          const unsigned char* va = sv + static_cast<size_t>(ca + 2 * t4) * rowb;
          const float vsa = kQuant ? psv[(ca + 2 * t4) / G] : 0.0f;
          const uint32_t b0 =
              kv_bits<PT>(va, n0 + g, vsa) |
              static_cast<uint32_t>(kv_bits<PT>(va + rowb, n0 + g, vsa)) << 16;
          if (cb >= 0) {
            if (r0 < T)
              a[2] = pack_bf16(w0[cb + 2 * t4], w0[cb + 2 * t4 + 1]);
            if (r1 < T)
              a[3] = pack_bf16(w1[cb + 2 * t4], w1[cb + 2 * t4 + 1]);
            const unsigned char* vb =
                sv + static_cast<size_t>(cb + 2 * t4) * rowb;
            const float vsb = kQuant ? psv[(cb + 2 * t4) / G] : 0.0f;
            b1 = kv_bits<PT>(vb, n0 + g, vsb) |
                 static_cast<uint32_t>(kv_bits<PT>(vb + rowb, n0 + g, vsb))
                     << 16;
          }
          mma16816(acc, a, b0, b1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = e < 2 ? r0 : r1;
          if (t < T) part[t * D + n0 + 2 * t4 + (e & 1)] = acc[e];
        }
      }
    }
  } else {
    // decode: ng groups of D threads; group x sums every ng-th column
    float* gpart = reinterpret_cast<float*>(pa_smem + L.gpart);
    for (int i = tid; i < L.ng * D; i += kPaThreads) {
      const int grp = i / D, d = i - grp * D;
      float acc = 0.0f;
      for (int x = grp; x < nch * kChunk; x += L.ng) {
        const int c = cc[x / kChunk] + x % kChunk;
        const float vs = kQuant ? psv[c / G] : 0.0f;
        acc = fmaf(sc[c],
                   bits_float(kv_bits<PT>(sv + static_cast<size_t>(c) * rowb,
                                          d, vs)),
                   acc);
      }
      gpart[i] = acc;
    }
    __syncthreads();
    for (int d = tid; d < D; d += kPaThreads) {
      float v = 0.0f;
      for (int grp = 0; grp < L.ng; ++grp) v += gpart[grp * D + d];
      part[d] = v;
    }
  }

  // 7. the partials of all ranks, added in rank order; each rank writes a
  // slice of the outputs
  cluster.sync();
  for (int o = rank * kPaThreads + tid; o < T * D; o += nr * kPaThreads) {
    float v = 0.0f;
    for (int r = 0; r < nr; ++r) v += *cluster.map_shared_rank(part + o, r);
    const int t = o / D, d = o - t * D;
    out[((static_cast<size_t>(s) * T + t) * H + h) * D + d] =
        __float2bfloat16(v);
  }
  cluster.sync();   // no rank leaves while another still reads its memory
}

template <typename PT>
cudaError_t launch_cluster(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* tables,
                           const void* bias, void* out, int S, int T, int H,
                           int D, int G, int Pmax, int P, float scale,
                           cudaStream_t stream) {
  auto kernel = T > 1 ? pa_cluster_kernel<PT, true>
                      : pa_cluster_kernel<PT, false>;
  const size_t smem =
      PaSmem(T, D, G, Pmax, static_cast<int>(sizeof(PT))).total;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nr = cluster_for(Pmax);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nr, H, S);
  cfg.blockDim = dim3(kPaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nr;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q),
      static_cast<const PT*>(k_pages), static_cast<const PT*>(v_pages),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int32_t*>(tables), static_cast<const float*>(bias),
      static_cast<bf16*>(out), T, H, D, G, Pmax, P, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Shared memory (bytes) one block of the launch takes.
size_t smem_bytes(int T, int D, int G, int Pmax, bool q_bf16,
                  bool quantized) {
  if (!q_bf16) return f32_smem_bytes(T, D, G, Pmax);
  return PaSmem(T, D, G, Pmax, quantized ? 1 : 2).total;
}

}  // namespace

extern "C" {

// q [S, T, H, D] (f32 or bf16), k_pages/v_pages [P, G, H, D] (q's dtype, or
// int8 with quantized != 0), k_scale/v_scale [P] f32, tables [S, Pmax] i32,
// bias [S, 1, T, C] f32, out [S, T, H, D] in q's dtype. All contiguous, on
// the current device; D * sizeof(page element) a multiple of 16; with bf16
// queries G a multiple of 8; at most
// kubeml_paged_attention_smem_bytes(...) bytes of shared memory per block.
// Returns cudaGetLastError() after the launch (a refused cluster launch
// included).
int kubeml_paged_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* k_scale,
                           const void* v_scale, const void* tables,
                           const void* bias, void* out, int S, int T, int H,
                           int D, int G, int Pmax, int P, int q_bf16,
                           int quantized, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the reference's 1 / sqrt(float32(D)): sqrt rounded to f32, then the
  // reciprocal rounded to f32
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  cudaError_t err;
  if (q_bf16) {
    err = quantized
              ? launch_cluster<int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                       tables, bias, out, S, T, H, D, G, Pmax,
                                       P, scale, st)
              : launch_cluster<bf16>(q, k_pages, v_pages, k_scale, v_scale,
                                     tables, bias, out, S, T, H, D, G, Pmax,
                                     P, scale, st);
  } else {
    err = quantized
              ? launch_f32<int8_t>(q, k_pages, v_pages, k_scale, v_scale,
                                   tables, bias, out, S, T, H, D, G, Pmax, P,
                                   scale, st)
              : launch_f32<float>(q, k_pages, v_pages, k_scale, v_scale,
                                  tables, bias, out, S, T, H, D, G, Pmax, P,
                                  scale, st);
  }
  return static_cast<int>(err);
}

// Shared memory (bytes) one block of kubeml_paged_attention launches with.
size_t kubeml_paged_attention_smem_bytes(int T, int D, int G, int Pmax,
                                         int q_bf16, int quantized) {
  return smem_bytes(T, D, G, Pmax, q_bf16 != 0, quantized != 0);
}

}  // extern "C"
