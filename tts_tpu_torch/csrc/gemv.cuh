// The block-dequant GEMV of the llama-family decode steps (K6-K9, and the
// Dia steps K10/K11): x (B, K) @ dequant(W)^T for B <= ROWS input rows, with
// the RMS norm fused as a prologue and the step's epilogues fused after it
// (RoPE + KV-row write, SiLU(gate) * up, residual add, store). Each source
// that launches it (llama_megastep.cu, dia_megastep.cu) instantiates the
// row counts and types it needs, so the sources build in parallel. The
// design notes are in llama_megastep.cu's header.
#pragma once

#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

using namespace tts;

constexpr int WARPS = 8;
constexpr float RMS_EPS = 1e-5f;

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

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
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

// Each block stages its input rows in shared memory, K in chunks of KC
// elements: B x KC bf16 within STAGE_BYTES, under the 48 KB a block gets
// without opting in (its other static shared memory takes the rest). KC is
// a multiple of ROUND, the elements one pass of a warp's 32 lanes covers,
// so that every lane visits its blocks in the same order whatever KC is.
constexpr int STAGE_BYTES = 46 * 1024;
constexpr int ROUND = 32 * QK;

__device__ __forceinline__ int chunk_elems(int B, int K) {
  const int kc = STAGE_BYTES / (int)sizeof(__nv_bfloat16) / B / ROUND * ROUND;
  return min(max(kc, ROUND), K);
}

// Element i of a staged activation row: block i / 32 keeps its four 16-byte
// chunks of 8 bf16 rotated by (block / 2), so that the 8 lanes of a quarter
// warp, which read chunk c of 8 consecutive blocks, hit 8 different 16-byte
// bank groups. block_dot_staged undoes the rotation.
__device__ __forceinline__ int staged_index(int i) {
  const int b = i >> 5, c = (i >> 3) & 3;
  return (b << 5) | (((c + (b >> 1)) & 3) << 3) | (i & 7);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// dequant.cuh's block_dot<true> over block b of a staged row xr (bf16,
// rotated chunks): the same products of the same bf16 values summed in the
// same order.
__device__ __forceinline__ float block_dot_staged(
    const __nv_bfloat16* __restrict__ xr, int b, const float w[QK]) {
  const uint4* blk = reinterpret_cast<const uint4*>(xr + b * QK);
  uint4 q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = blk[(c + (b >> 1)) & 3];
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

// Grid ceil(P / WARPS) blocks; warp p of the grid computes the feature pair
// p (see the header) for B <= ROWS input rows x (B, K); out (B, N). For each
// chunk of K, the block rounds the rows' elements to bf16 (after the RMS
// norm when RMS) into shared memory in the rotated layout, then every warp
// dots its weight blocks of the chunk with them.
template <int QT, bool PACKED, bool SBF16, bool RMS, int EPI, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
llama_gemv_kernel(const float* __restrict__ x, const float* __restrict__ norm_w,
                  const uint8_t* __restrict__ codes_a, const void* __restrict__ scales_a,
                  const uint8_t* __restrict__ codes_b, const void* __restrict__ scales_b,
                  int B, int P, int N, int K, const float* res, float* out,
                  RopeArgs ra) {
  __shared__ __align__(16) __nv_bfloat16 xs[STAGE_BYTES / sizeof(__nv_bfloat16)];
  __shared__ float red[WARPS];
  __shared__ float rstd[ROWS];
  if constexpr (RMS) {
    for (int r = 0; r < B; ++r) {
      const float* xr = x + (size_t)r * K;
      float s = 0.f;
      for (int i = threadIdx.x; i < K; i += WARPS * 32) s += xr[i] * xr[i];
      const float t = block_sum(s, red);
      if (threadIdx.x == 0) rstd[r] = 1.f / sqrtf(t / K + RMS_EPS);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;
  // a warp past the last pair still stages its share of every chunk
  const bool live = p < P;
  const int pw = live ? p : P - 1;
  int row_a, row_b;
  if constexpr (EPI == EPI_ROPE_QKV) {
    const int h2 = ra.d / 2;
    row_a = (pw / h2) * ra.d + pw % h2;
    row_b = row_a + h2;
  } else if constexpr (EPI == EPI_SILU_MUL) {
    row_a = pw;
    row_b = pw;
  } else {
    row_a = 2 * pw;
    row_b = 2 * pw + 1;
  }
  const int nb = K / QK, kc_max = chunk_elems(B, K);
  const size_t row_bytes = PACKED ? K / 2 : K;
  const uint8_t* wa = codes_a + (size_t)row_a * row_bytes;
  const uint8_t* wb = codes_b + (size_t)row_b * row_bytes;
  float acc_a[ROWS], acc_b[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc_a[r] = acc_b[r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kc_max) {
    const int kc = min(kc_max, K - k0), b0 = k0 / QK;
    __syncthreads();  // the last chunk's reads are done; rstd is written
    for (int r = 0; r < B; ++r) {
      const float* xr = x + (size_t)r * K + k0;
      for (int i = threadIdx.x; i < kc; i += WARPS * 32) {
        const float v = RMS ? xr[i] * rstd[r] * norm_w[k0 + i] : xr[i];
        xs[r * kc_max + staged_index(i)] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();
    for (int b = b0 + lane; b < b0 + kc / QK; b += 32) {
      float w[QK];
      dequant_block<QT, PACKED, true>(
          wa, b, load_scale<SBF16>(scales_a, (size_t)row_a * nb + b), w);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < B) acc_a[r] += block_dot_staged(xs + r * kc_max, b - b0, w);
      }
      dequant_block<QT, PACKED, true>(
          wb, b, load_scale<SBF16>(scales_b, (size_t)row_b * nb + b), w);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < B) acc_b[r] += block_dot_staged(xs + r * kc_max, b - b0, w);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= B) break;
    const float va = warp_sum(acc_a[r]);
    const float vb = warp_sum(acc_b[r]);
    if (lane != 0) continue;
    float* o = out + (size_t)r * N;
    if constexpr (EPI == EPI_SILU_MUL) {
      o[p] = va / (1.f + expf(-va)) * vb;
    } else if constexpr (EPI == EPI_RESIDUAL) {
      const float* rs = res + (size_t)r * N;
      o[row_a] = rs[row_a] + va;
      o[row_b] = rs[row_b] + vb;
    } else if constexpr (EPI == EPI_STORE) {
      o[row_a] = va;
      o[row_b] = vb;
    } else {  // EPI_ROPE_QKV
      const int h2 = ra.d / 2;
      const int pr = ra.pos[r * ra.pos_stride];
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
        const int row = min(pr, ra.ctx - 1);
        const size_t idx = (size_t)r * ra.bstride +
                           ((size_t)(j / ra.d) * ra.ctx + row) * ra.d + j % ra.d;
        void* cache = is_v ? ra.vc : ra.kc;
        store_cache(cache, idx, ya, ra.bf16);
        store_cache(cache, idx + h2, yb, ra.bf16);
      }
    }
  }
}

template <int QT, bool PACKED, bool SBF16, bool RMS, int EPI, int ROWS>
int launch_one(const float* x, const float* norm_w, const uint8_t* ca,
               const void* sa, const uint8_t* cb, const void* sb, int B, int P,
               int N, int K, const float* res, float* out, RopeArgs ra,
               cudaStream_t s) {
  const dim3 grid((P + WARPS - 1) / WARPS);
  llama_gemv_kernel<QT, PACKED, SBF16, RMS, EPI, ROWS><<<grid, WARPS * 32, 0, s>>>(
      x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra);
  return (int)cudaGetLastError();
}

}  // namespace
