// The Parler decode step's GEMV device code, shared by the launch sequence
// of K2 / K5 (parler_megastep.cu, one launch per GEMV) and the persistent
// K12 (parler_flat.cu, every GEMV of the step inside one launch). Both call
// the same functions, so a feature's sum runs in the same order on either
// route and K12 equals K2 bit for bit.
//
// A GEMV phase is: every block of WARPS warps normalizes the B input rows
// into shared memory itself (`ln_rows`, for the projections that follow a
// layer norm), then one warp computes one output feature for all B rows
// (`gemv_feature`): each lane dequantizes a 32-weight block once into
// registers (dequant.cuh) and dots it with every row, one accumulator per
// row, so one weight read serves every slot and each row sums in the same
// order whatever B is. The epilogue stores, adds the residual, applies the
// tanh-GELU, or (qkv) also writes the current token's k / v into the cache.
#pragma once

#include "dequant.cuh"

namespace tts {
namespace parler {

constexpr int WARPS = 8;  // warps per block on both routes
constexpr float LN_EPS = 1e-5f;

enum Epi { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_GELU = 2, EPI_QKV = 3 };

// Where the qkv epilogue writes the current token's k and v: slot r's
// cache of this layer, (heads, ctx, d) at kc/vc + r * bstride elements, row
// min(pos[r], ctx - 1).
struct CacheArgs {
  void* kc;
  void* vc;
  const int* pos;
  int hidden, d, ctx, bf16;
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

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// xs (B, K) = bf16(LayerNorm(x (B, K)) * w + b), computed by all WARPS * 32
// threads of the block; returns after a block barrier. x may be written by
// other blocks of the same launch (K12), so it is read through plain loads.
__device__ __forceinline__ void ln_rows(const float* x, const float* ln_w,
                                        const float* ln_b, int B, int K,
                                        float* xs) {
  __shared__ float red[WARPS];
  for (int r = 0; r < B; ++r) {
    const float* xr = x + (size_t)r * K;
    float* xo = xs + (size_t)r * K;
    float s = 0.f;
    for (int i = threadIdx.x; i < K; i += WARPS * 32) s += xr[i];
    const float mu = block_sum(s, red) / K;
    float v = 0.f;
    for (int i = threadIdx.x; i < K; i += WARPS * 32) {
      const float dv = xr[i] - mu;
      v += dv * dv;
    }
    const float rstd = 1.f / sqrtf(block_sum(v, red) / K + LN_EPS);
    for (int i = threadIdx.x; i < K; i += WARPS * 32) {
      xo[i] = bf16_round((xr[i] - mu) * rstd * ln_w[i] + ln_b[i]);
    }
  }
  __syncthreads();
}

// Output feature n of out (B, N) = epilogue(xin (B, K) @ dequant(W)^T),
// computed by one warp (lane = its lane). xin is the normalized rows in
// shared memory or the input rows in device memory; codes / scales are the
// weight rows (N, K) of the layer, bf16 scales.
template <int QT, bool PACKED, int EPI, int ROWS>
__device__ __forceinline__ void gemv_feature(
    const float* xin, const uint8_t* __restrict__ codes,
    const __nv_bfloat16* __restrict__ scales, int B, int N, int K,
    const float* res, float* out, const CacheArgs& c, int n, int lane) {
  const int nb = K / QK;
  const uint8_t* row = codes + (size_t)n * (PACKED ? K / 2 : K);
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  for (int b = lane; b < nb; b += 32) {
    float w[QK];
    dequant_block<QT, PACKED, true>(row, b, load_scale<true>(scales, (size_t)n * nb + b), w);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < B) acc[r] += block_dot<true>(xin + (size_t)r * K + b * QK, w);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= B) break;
    const float v = warp_sum(acc[r]);
    if (lane != 0) continue;
    const size_t o = (size_t)r * N + n;
    if constexpr (EPI == EPI_RESIDUAL) {
      out[o] = res[o] + v;
    } else if constexpr (EPI == EPI_GELU) {
      out[o] = gelu_tanh(v);
    } else {
      out[o] = v;
    }
    if constexpr (EPI == EPI_QKV) {
      if (n >= c.hidden) {
        const int which = (n - c.hidden) / c.hidden;  // 0: k, 1: v
        const int j = (n - c.hidden) % c.hidden;
        const int p = min(c.pos[r], c.ctx - 1);
        const size_t idx = (size_t)r * c.bstride +
                           ((size_t)(j / c.d) * c.ctx + p) * c.d + j % c.d;
        void* dst = which ? c.vc : c.kc;
        if (c.bf16) {
          reinterpret_cast<__nv_bfloat16*>(dst)[idx] = __float2bfloat16_rn(v);
        } else {
          reinterpret_cast<float*>(dst)[idx] = v;
        }
      }
    }
  }
}

}  // namespace parler
}  // namespace tts
