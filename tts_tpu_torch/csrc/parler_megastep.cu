// K2: the Parler decode step's block-dequant GEMV, with the layer norm fused
// as a prologue and the epilogues of the step fused after it.
//
// Replaces the TPU kernel tts_tpu/ops/parler_megastep.py:_megastep_kernel
// (wrapper parler_megastep): one decode step over all L layers, LN -> qkv ->
// self-attention -> o -> LN -> cross-q -> cross-attention -> co -> LN ->
// fc1 -> tanh-GELU -> fc2, weights block-quantized with bf16 scales, the
// TPU's `_dqdot` numerics (weights dequantized in f32 and rounded once to
// bf16, activations rounded to bf16, f32 sums).
//
// What bounds it on the H100: a decode step reads every weight once for 2
// flops: at Parler-Mini width 24 x (2*1024*3072 + 2*1024*4096) = 352 M Q4
// weights x 0.5625 B = 198 MB per step, about 59 us at 3.35 TB/s, plus the
// KV cache rows up to pos. Memory bandwidth, and at this size the launch
// latency of the step's many small kernels.
//
// Design: the TPU kernel runs the layers as a sequential grid and carries x
// in VMEM scratch. Blocks on the H100 run in no order and nothing carries
// between them, so the port runs the step as a sequence of launches on one
// stream, per layer (ops/parler_megastep.py drives it):
//   1. gemv  LN1 prologue, qkv;   epilogue writes k, v into cache row pos
//   2. K3    self-attention over cache rows [0, pos]
//   3. gemv  o;    epilogue x += .
//   4. gemv  LNc prologue, cross-q
//   5. K3    cross-attention over the (heads, Tc, D) f32 K/V
//   6. gemv  co;   epilogue x += .
//   7. gemv  LN2 prologue, fc1;  epilogue tanh-GELU
//   8. gemv  fc2;  epilogue x += .
// Each gemv block normalizes the whole input row into shared memory itself
// (H floats; recomputing the LN per block costs L2 reads, not device-memory
// traffic), then one warp per output feature streams that feature's weight
// row exactly as K1 does (dequant.cuh). The current token's k/v are written
// into the cache before the attention reads rows [0, pos]: exact in f32; on
// a bf16 cache the current row is rounded to bf16 too (the TPU kernel folds
// the f32 row in analytically). The plain version does the same.
// A single persistent launch per step is later work.
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

using namespace tts;

constexpr int WARPS = 8;
constexpr float LN_EPS = 1e-5f;

enum Epi { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_GELU = 2, EPI_QKV = 3 };

// Where the qkv epilogue writes the current token's k and v: this layer's
// cache (heads, ctx, d), row min(pos, ctx - 1).
struct CacheArgs {
  void* kc;
  void* vc;
  const int* pos;
  int hidden, d, ctx, bf16;
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

template <int QT, bool PACKED, bool LN, int EPI>
__global__ void __launch_bounds__(WARPS * 32)
gemv_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
            const float* __restrict__ ln_b, const uint8_t* __restrict__ codes,
            const __nv_bfloat16* __restrict__ scales, int N, int K,
            const float* res, float* out, CacheArgs c) {
  extern __shared__ float4 xs4[];  // K floats: the normalized input row
  const float* xin = x;
  if constexpr (LN) {
    __shared__ float red[WARPS];
    float* xs = reinterpret_cast<float*>(xs4);
    float s = 0.f;
    for (int i = threadIdx.x; i < K; i += WARPS * 32) s += x[i];
    const float mu = block_sum(s, red) / K;
    float v = 0.f;
    for (int i = threadIdx.x; i < K; i += WARPS * 32) {
      const float dv = x[i] - mu;
      v += dv * dv;
    }
    const float rstd = 1.f / sqrtf(block_sum(v, red) / K + LN_EPS);
    for (int i = threadIdx.x; i < K; i += WARPS * 32) {
      xs[i] = bf16_round((x[i] - mu) * rstd * ln_w[i] + ln_b[i]);
    }
    __syncthreads();
    xin = xs;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;
  const int nb = K / QK;
  const uint8_t* row = codes + (size_t)n * (PACKED ? K / 2 : K);
  float acc = 0.f;
  for (int b = lane; b < nb; b += 32) {
    float w[QK];
    dequant_block<QT, PACKED, true>(row, b, load_scale<true>(scales, (size_t)n * nb + b), w);
    acc += block_dot<true>(xin + b * QK, w);
  }
  acc = warp_sum(acc);
  if (lane != 0) return;
  if constexpr (EPI == EPI_RESIDUAL) {
    out[n] = res[n] + acc;
  } else if constexpr (EPI == EPI_GELU) {
    out[n] = gelu_tanh(acc);
  } else {
    out[n] = acc;
  }
  if constexpr (EPI == EPI_QKV) {
    if (n >= c.hidden) {
      const int which = (n - c.hidden) / c.hidden;  // 0: k, 1: v
      const int j = (n - c.hidden) % c.hidden;
      const int p = min(*c.pos, c.ctx - 1);
      const size_t idx = ((size_t)(j / c.d) * c.ctx + p) * c.d + j % c.d;
      void* dst = which ? c.vc : c.kc;
      if (c.bf16) {
        reinterpret_cast<__nv_bfloat16*>(dst)[idx] = __float2bfloat16_rn(acc);
      } else {
        reinterpret_cast<float*>(dst)[idx] = acc;
      }
    }
  }
}

template <int QT, bool PACKED>
int launch(int ln, int epi, const float* x, const float* ln_w,
           const float* ln_b, const uint8_t* codes, const void* scales, int N,
           int K, const float* res, float* out, CacheArgs c, cudaStream_t s) {
  const dim3 grid((N + WARPS - 1) / WARPS);
  const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(scales);
  const size_t smem = ln ? (size_t)K * sizeof(float) : 0;
  if (ln && epi == EPI_QKV) {
    gemv_kernel<QT, PACKED, true, EPI_QKV><<<grid, WARPS * 32, smem, s>>>(
        x, ln_w, ln_b, codes, sc, N, K, res, out, c);
  } else if (ln && epi == EPI_STORE) {
    gemv_kernel<QT, PACKED, true, EPI_STORE><<<grid, WARPS * 32, smem, s>>>(
        x, ln_w, ln_b, codes, sc, N, K, res, out, c);
  } else if (ln && epi == EPI_GELU) {
    gemv_kernel<QT, PACKED, true, EPI_GELU><<<grid, WARPS * 32, smem, s>>>(
        x, ln_w, ln_b, codes, sc, N, K, res, out, c);
  } else if (!ln && epi == EPI_RESIDUAL) {
    gemv_kernel<QT, PACKED, false, EPI_RESIDUAL><<<grid, WARPS * 32, 0, s>>>(
        x, ln_w, ln_b, codes, sc, N, K, res, out, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (N) = epilogue(LN?(x) @ dequant(W)^T) for W (N, K) with bf16 scales.
// (ln, epi) is one of (1, QKV), (1, STORE), (1, GELU), (0, RESIDUAL); the
// cache arguments are read only by the QKV epilogue (N = 3 * hidden).
extern "C" int tts_parler_gemv(const float* x, const float* ln_w,
                               const float* ln_b, int ln,
                               const uint8_t* codes, const void* scales,
                               int qtype, int packed, int N, int K,
                               const float* res, float* out, int epi, void* kc,
                               void* vc, const int* pos, int hidden, int d,
                               int ctx, int cache_bf16, void* stream) {
  if (N <= 0 || K <= 0 || K % tts::QK || K > 12288) return (int)cudaErrorInvalidValue;
  const CacheArgs c{kc, vc, pos, hidden, d, ctx, cache_bf16};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  using namespace tts;
  if (qtype == Q4_0 && packed) {
    return launch<Q4_0, true>(ln, epi, x, ln_w, ln_b, codes, scales, N, K, res, out, c, s);
  } else if (qtype == Q4_0) {
    return launch<Q4_0, false>(ln, epi, x, ln_w, ln_b, codes, scales, N, K, res, out, c, s);
  } else if (qtype == Q5_0 && !packed) {
    return launch<Q5_0, false>(ln, epi, x, ln_w, ln_b, codes, scales, N, K, res, out, c, s);
  } else if (qtype == Q8_0 && !packed) {
    return launch<Q8_0, false>(ln, epi, x, ln_w, ln_b, codes, scales, N, K, res, out, c, s);
  }
  return (int)cudaErrorInvalidValue;
}
