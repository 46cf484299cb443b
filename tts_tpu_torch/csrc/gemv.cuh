// The block-dequant GEMV of the llama-family decode steps (K6-K9, and the
// Dia steps K10/K11): x (B, K) @ dequant(W)^T for B <= ROWS input rows, with
// the RMS norm fused as a prologue and the step's epilogues fused after it
// (RoPE + KV-row write, SiLU(gate) * up, residual add, store). Each source
// that launches it (llama_megastep.cu, dia_megastep.cu) instantiates the
// row counts and types it needs, so the sources build in parallel. The
// design notes are in llama_megastep.cu's header.
#pragma once

#include <atomic>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

using namespace tts;
namespace cg = cooperative_groups;

constexpr int WARPS = 12;
// The RMS norm's sum of squares is taken by the first RMS_WARPS warps,
// thread t summing elements t, t + RMS_WARPS * 32, ...
constexpr int RMS_WARPS = 8;
constexpr int CLUSTER = 2;   // blocks that share one staging of the rows
constexpr float RMS_EPS = 1e-5f;
constexpr int RMS_REGS = 16;  // x elements a thread holds for the RMS norm
// Dynamic shared memory a block may stage in: the H100's 227 KB a block
// can have, less room for the static shared memory.
constexpr int STAGE_LIMIT = 224 * 1024;

enum Epi { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_SILU_MUL = 2, EPI_ROPE_QKV = 3 };

// What the RoPE + KV-row epilogue reads: the inverse frequencies (d/2), the
// position of row r at pos[r * pos_stride], and this layer's cache, row r's
// (n_kv, ctx, d) at kc/vc + r * bstride elements. q occupies features
// [0, hidden), k [hidden, hidden + kvh), v [hidden + kvh, hidden + 2 kvh).
struct RopeArgs {
  const float* inv;
  const int* pos;
  int pos_stride;
  void* kc;
  void* vc;
  int hidden, kvh, d, ctx, bf16;
  long long bstride;
};

// The sum of v over the first RMS_WARPS warps (every thread of the block
// calls it): each warp's lanes, then the warps in order.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0 && threadIdx.x / 32 < RMS_WARPS) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < RMS_WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ void store_cache(void* cache, size_t idx, float v,
                                            int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(cache)[idx] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(cache)[idx] = v;
  }
}

// Element i of a staged activation row: block i / 32 keeps its four 16-byte
// chunks of 8 bf16 rotated by (block / 2), so that the 8 lanes of a quarter
// warp, which read chunk c of 8 consecutive blocks, hit 8 different 16-byte
// bank groups. stage_block undoes the rotation.
__device__ __forceinline__ int staged_index(int i) {
  const int b = i >> 5, c = (i >> 3) & 3;
  return (b << 5) | (((c + (b >> 1)) & 3) << 3) | (i & 7);
}

// Two floats rounded to bf16 and packed, a in the low half (the lower
// address).
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// Block b of a staged row xr (bf16, rotated chunks), in element order.
__device__ __forceinline__ void stage_block(const __nv_bfloat16* xr, int b,
                                            uint4 q[4]) {
  const uint4* blk = reinterpret_cast<const uint4*>(xr + b * QK);
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = blk[(c + (b >> 1)) & 3];
}

// dequant.cuh's block_dot<true> over a staged block (stage_block): the same
// products of the same bf16 values summed in the same order.
__device__ __forceinline__ float block_dot_staged(const uint4 q[4],
                                                  const float w[QK]) {
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < QK / 4; ++j) {
    const uint4& h = q[j / 2];
    const uint32_t u0 = j % 2 ? h.z : h.x, u1 = j % 2 ? h.w : h.y;
    sum += w[4 * j] * bf16_lo(u0) + w[4 * j + 1] * bf16_hi(u0) +
           w[4 * j + 2] * bf16_lo(u1) + w[4 * j + 3] * bf16_hi(u1);
  }
  return sum;
}

// The two weight rows of feature pair p (see llama_megastep.cu's header).
template <int EPI>
__device__ __forceinline__ void pair_rows(int p, const RopeArgs& ra,
                                          int& row_a, int& row_b) {
  if constexpr (EPI == EPI_ROPE_QKV) {
    const int h2 = ra.d / 2;
    row_a = (p / h2) * ra.d + p % h2;
    row_b = row_a + h2;
  } else if constexpr (EPI == EPI_SILU_MUL) {
    row_a = p;
    row_b = p;
  } else {
    row_a = 2 * p;
    row_b = 2 * p + 1;
  }
}

// One lane's share of one (feature pair, 32-weight block): both rows'
// codes and scales.
struct Unit {
  uint4 qa[2], qb[2];
  float sa, sb;
};

// Load the unit of pair p at block b (a lane past the row's blocks loads
// nothing).
template <int QT, bool PACKED, bool SBF16, int EPI>
__device__ __forceinline__ void load_unit(
    Unit& u, int p, int b, int nb, size_t row_bytes, const uint8_t* codes_a,
    const void* scales_a, const uint8_t* codes_b, const void* scales_b,
    const RopeArgs& ra) {
  if (b >= nb) return;
  int row_a, row_b;
  pair_rows<EPI>(p, ra, row_a, row_b);
  load_codes<PACKED>(codes_a + (size_t)row_a * row_bytes, b, u.qa);
  load_codes<PACKED>(codes_b + (size_t)row_b * row_bytes, b, u.qb);
  u.sa = load_scale<SBF16>(scales_a, (size_t)row_a * nb + b);
  u.sb = load_scale<SBF16>(scales_b, (size_t)row_b * nb + b);
}

// Stage rows [r0, r0 + nr) of x into xs (nr x K bf16, rotated), after the
// RMS norm when RMS: block rank c of the cluster normalizes and rounds the
// rows r0 + c, r0 + c + CLUSTER, ... into its own shared memory, then copies
// them into the other blocks' (distributed shared memory), so that the
// cluster reads each row from L2 once. The RMS sum of squares has the
// shape it has always had: thread t sums elements t, t + 256, ... in order,
// then the warps' sums are added in warp order.
template <bool RMS>
__device__ __forceinline__ void stage_rows(cg::cluster_group& cluster,
                                           const float* x,
                                           const float* norm_w, int r0,
                                           int nr, int K, __nv_bfloat16* xs,
                                           float* red) {
  constexpr int T = WARPS * 32, TR = RMS_WARPS * 32;
  const bool rms_thread = threadIdx.x < TR;
  const unsigned int rank = cluster.block_rank();
  cluster.sync();  // every block has started, and is done with the last pass
  for (int rr = rank; rr < nr; rr += CLUSTER) {
    const float* xr = x + (size_t)(r0 + rr) * K;
    __nv_bfloat16* dst = xs + (size_t)rr * K;
    if constexpr (RMS) {
      float v[RMS_REGS];
      float s = 0.f;
      const bool held = K <= RMS_REGS * TR;
      if (held) {
#pragma unroll
        for (int j = 0; j < RMS_REGS; ++j) {
          const int i = threadIdx.x + j * TR;
          v[j] = rms_thread && i < K ? xr[i] : 0.f;
          if (rms_thread && i < K) s += v[j] * v[j];
        }
      } else if (rms_thread) {
        for (int i = threadIdx.x; i < K; i += TR) s += xr[i] * xr[i];
      }
      const float rstd = 1.f / sqrtf(block_sum(s, red) / K + RMS_EPS);
      if (held) {
#pragma unroll
        for (int j = 0; j < RMS_REGS; ++j) {
          const int i = threadIdx.x + j * TR;
          if (rms_thread && i < K) {
            dst[staged_index(i)] = __float2bfloat16_rn(v[j] * rstd * norm_w[i]);
          }
        }
      } else {
        for (int i = threadIdx.x; i < K; i += T) {
          dst[staged_index(i)] = __float2bfloat16_rn(xr[i] * rstd * norm_w[i]);
        }
      }
    } else {
      // 8 consecutive elements a thread: one 16-byte chunk of the layout
      for (int c = threadIdx.x; c < K / 8; c += T) {
        const float4 lo = reinterpret_cast<const float4*>(xr)[2 * c];
        const float4 hi = reinterpret_cast<const float4*>(xr)[2 * c + 1];
        *reinterpret_cast<uint4*>(dst + staged_index(8 * c)) =
            make_uint4(pack_bf16x2(lo.x, lo.y), pack_bf16x2(lo.z, lo.w),
                       pack_bf16x2(hi.x, hi.y), pack_bf16x2(hi.z, hi.w));
      }
    }
  }
  __syncthreads();  // this block's rows are complete
  for (int rr = rank; rr < nr; rr += CLUSTER) {
    const uint4* src = reinterpret_cast<const uint4*>(xs + (size_t)rr * K);
    for (unsigned int peer = 0; peer < CLUSTER; ++peer) {
      if (peer == rank) continue;
      uint4* dst = cluster.map_shared_rank(
          reinterpret_cast<uint4*>(xs + (size_t)rr * K), peer);
      for (int c = threadIdx.x; c < K / 8; c += T) dst[c] = src[c];
    }
  }
  cluster.sync();  // every row is in every block of the cluster
}

// After a pair's last block: sum each row's lanes, reset the accumulators,
// and (lane 0) apply the epilogue to rows [r0, r0 + nr) of pair p.
template <int EPI, int ROWS>
__device__ __forceinline__ void epilogue(float* acc_a, float* acc_b, int nr,
                                         int r0, int p, int lane, int N,
                                         const float* res, float* out,
                                         const RopeArgs& ra) {
  int row_a, row_b;
  pair_rows<EPI>(p, ra, row_a, row_b);
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= nr) break;
    const float va = warp_sum(acc_a[r]);
    const float vb = warp_sum(acc_b[r]);
    acc_a[r] = acc_b[r] = 0.f;
    if (lane != 0) continue;
    const int row = r0 + r;
    float* o = out + (size_t)row * N;
    if constexpr (EPI == EPI_SILU_MUL) {
      o[p] = va / (1.f + expf(-va)) * vb;
    } else if constexpr (EPI == EPI_RESIDUAL) {
      const float* rs = res + (size_t)row * N;
      o[row_a] = rs[row_a] + va;
      o[row_b] = rs[row_b] + vb;
    } else if constexpr (EPI == EPI_STORE) {
      o[row_a] = va;
      o[row_b] = vb;
    } else {  // EPI_ROPE_QKV
      const int h2 = ra.d / 2;
      const int pr = ra.pos[row * ra.pos_stride];
      float ya = va, yb = vb;
      if (row_a < ra.hidden + ra.kvh) {  // q and k rotate, v does not
        const float ang = (float)pr * ra.inv[p % h2];
        const float c = cosf(ang), s = sinf(ang);
        ya = va * c - vb * s;
        yb = vb * c + va * s;
      }
      o[row_a] = ya;
      o[row_b] = yb;
      if (row_a >= ra.hidden) {
        const bool is_v = row_a >= ra.hidden + ra.kvh;
        const int j = row_a - ra.hidden - (is_v ? ra.kvh : 0);
        const int crow = min(pr, ra.ctx - 1);
        const size_t idx = (size_t)row * ra.bstride +
                           ((size_t)(j / ra.d) * ra.ctx + crow) * ra.d + j % ra.d;
        void* cache = is_v ? ra.vc : ra.kc;
        store_cache(cache, idx, ya, ra.bf16);
        store_cache(cache, idx + h2, yb, ra.bf16);
      }
    }
  }
}

// A grid of clusters of CLUSTER blocks, at most one block per SM; warp w
// of block g computes the feature pairs p = g + G * (w + WARPS * k) (G
// blocks), so that the pairs spread over the blocks first. For the rows
// [r0, r0 + rp) of each pass (more than one pass only where B x K bf16
// exceed STAGE_LIMIT), the cluster stages the rows (stage_rows), then each
// warp walks its pairs' 32-weight blocks, lane l taking blocks l, l + 32,
// ... of both rows of the pair: it keeps the codes and scales of the next
// PF (pair, block) units in flight in registers (issued before the staging
// for the first ones), dequantizes each unit once and dots it with every
// staged row, and after a pair's last block sums the lanes and applies the
// epilogue. out (B, N).
template <int QT, bool PACKED, bool SBF16, bool RMS, int EPI, int ROWS>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(WARPS * 32, 1)
llama_gemv_kernel(const float* __restrict__ x, const float* __restrict__ norm_w,
                  const uint8_t* __restrict__ codes_a, const void* __restrict__ scales_a,
                  const uint8_t* __restrict__ codes_b, const void* __restrict__ scales_b,
                  int B, int P, int N, int K, int rp, const float* res,
                  float* out, RopeArgs ra) {
  // units in flight per lane past the one computed (1 at 16 rows, whose
  // accumulators would otherwise spill)
  constexpr int PF = ROWS <= 8 ? 2 : 1;
  extern __shared__ uint4 smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __shared__ float red[RMS_WARPS];
  cg::cluster_group cluster = cg::this_cluster();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = K / QK, J = (nb + 31) / 32;  // blocks of a lane per pair
  const size_t row_bytes = PACKED ? K / 2 : K;
  const int p0 = blockIdx.x + gridDim.x * warp, pstep = gridDim.x * WARPS;
  const int n_pairs = p0 < P ? (P - 1 - p0) / pstep + 1 : 0;
  const int n_units = n_pairs * J;
  for (int r0 = 0; r0 < B; r0 += rp) {
    const int nr = min(rp, B - r0);
    // ring[0] is the unit computed next; ring[f] is f units ahead
    Unit ring[PF];
    int lk = 0, lj = 0;  // the next unit to load: pair p0 + lk * pstep, lane block lj
#pragma unroll
    for (int f = 0; f < PF; ++f) {
      if (lk < n_pairs) {
        load_unit<QT, PACKED, SBF16, EPI>(ring[f], p0 + lk * pstep, lane + 32 * lj,
                                          nb, row_bytes, codes_a, scales_a,
                                          codes_b, scales_b, ra);
      }
      if (++lj == J) { lj = 0; ++lk; }
    }
    stage_rows<RMS>(cluster, x, norm_w, r0, nr, K, xs, red);
    float acc_a[ROWS], acc_b[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc_a[r] = acc_b[r] = 0.f;
    int ck = 0, cj = 0;  // the unit being computed
#pragma unroll 1
    for (int u = 0; u < n_units; ++u) {
      const Unit cur = ring[0];
#pragma unroll
      for (int f = 0; f + 1 < PF; ++f) ring[f] = ring[f + 1];
      if (lk < n_pairs) {
        load_unit<QT, PACKED, SBF16, EPI>(ring[PF - 1], p0 + lk * pstep,
                                          lane + 32 * lj, nb, row_bytes,
                                          codes_a, scales_a, codes_b,
                                          scales_b, ra);
      }
      if (++lj == J) { lj = 0; ++lk; }
      const int b = lane + 32 * cj;
      if (b < nb) {
        float wa[QK], wb[QK];
        dequant_codes<QT, PACKED, true>(cur.qa, cur.sa, wa);
        dequant_codes<QT, PACKED, true>(cur.qb, cur.sb, wb);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < nr) {
            uint4 xq[4];
            stage_block(xs + (size_t)r * K, b, xq);
            acc_a[r] += block_dot_staged(xq, wa);
            acc_b[r] += block_dot_staged(xq, wb);
          }
        }
      }
      if (++cj == J) {
        epilogue<EPI, ROWS>(acc_a, acc_b, nr, r0, p0 + ck * pstep, lane, N, res,
                            out, ra);
        cj = 0;
        ++ck;
      }
    }
  }
}

// Rows staged per pass: all B when B x K bf16 fit in STAGE_LIMIT, else
// split evenly over the fewest passes that fit (0: K too long for one row).
inline int rows_per_pass(int B, int K) {
  const int fit = STAGE_LIMIT / (K * (int)sizeof(__nv_bfloat16));
  if (fit < 1) return 0;
  const int passes = (B + fit - 1) / fit;
  return (B + passes - 1) / passes;
}

// Blocks of the grid: one per SM at most, a whole number of clusters, no
// more than the pairs need (WARPS pairs a block).
inline int grid_blocks(int P) {
  static std::atomic<int> sms{0};
  int n = sms.load();
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = CLUSTER;
    }
    sms.store(n);
  }
  const int need = (P + WARPS - 1) / WARPS;
  const int blocks = need < n ? need : n;
  return ((blocks + CLUSTER - 1) / CLUSTER) * CLUSTER;
}

template <int QT, bool PACKED, bool SBF16, bool RMS, int EPI, int ROWS>
int launch_one(const float* x, const float* norm_w, const uint8_t* ca,
               const void* sa, const uint8_t* cb, const void* sb, int B, int P,
               int N, int K, const float* res, float* out, RopeArgs ra,
               cudaStream_t s) {
  auto kern = llama_gemv_kernel<QT, PACKED, SBF16, RMS, EPI, ROWS>;
  const int rp = rows_per_pass(B, K);
  if (rp < 1) return (int)cudaErrorInvalidValue;
  const int smem = rp * K * (int)sizeof(__nv_bfloat16);
  // past 48 KB a launch needs the kernel's opt-in: each instantiation opts
  // in once, to every size a launch may ask for
  static std::atomic<bool> opted{false};
  if (!opted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, STAGE_LIMIT);
    if (e != cudaSuccess) return (int)e;
    opted.store(true);
  }
  kern<<<grid_blocks(P), WARPS * 32, smem, s>>>(x, norm_w, ca, sa, cb, sb, B, P,
                                               N, K, rp, res, out, ra);
  return (int)cudaGetLastError();
}

}  // namespace
