// K2 and K5: the Parler decode step's block-dequant GEMV, with the layer
// norm fused as a prologue and the epilogues of the step fused after it, for
// one sequence (K2) or B batch slots that share one read of the weights
// (K5). K2 is K5 with B = 1: one templated kernel serves both.
//
// Replaces the TPU kernels tts_tpu/ops/parler_megastep.py:_megastep_kernel
// (wrapper parler_megastep) and :_megastep_batched_kernel (wrapper
// parler_megastep_batched): one decode step over all L layers, LN -> qkv ->
// self-attention -> o -> LN -> cross-q -> cross-attention -> co -> LN ->
// fc1 -> tanh-GELU -> fc2, weights block-quantized with bf16 scales, the
// TPU's `_dqdot` numerics (weights dequantized in f32 and rounded once to
// bf16, activations rounded to bf16, f32 sums).
//
// What bounds it on the H100: a decode step reads every weight once for 2
// flops per slot: at Parler-Mini width 24 x (2*1024*3072 + 2*1024*4096) =
// 352 M Q4 weights x 0.5625 B = 198 MB per step, about 59 us at 3.35 TB/s,
// plus each slot's KV cache rows up to its pos (at B = 8, pos 1000, bf16:
// 787 MB, which then dominates). Memory bandwidth, and at this size the
// launch latency of the step's many small kernels.
//
// Design: the TPU kernels run the layers as a sequential grid and carry x
// in VMEM scratch. Blocks on the H100 run in no order and nothing carries
// between them, so the port runs the step as a sequence of launches on one
// stream, per layer (ops/parler_megastep.py drives it):
//   1. gemv  LN1 prologue, qkv;   epilogue writes k, v into cache row pos
//   2. K3/K4 self-attention over cache rows [0, pos]
//   3. gemv  o;    epilogue x += .
//   4. gemv  LNc prologue, cross-q
//   5. K3/K4 cross-attention over the (heads, Tc, D) f32 K/V (shared)
//   6. gemv  co;   epilogue x += .
//   7. gemv  LN2 prologue, fc1;  epilogue tanh-GELU
//   8. gemv  fc2;  epilogue x += .
// Each gemv block normalizes the B input rows into shared memory itself
// (B x K floats; recomputing the LN per block costs L2 reads, not
// device-memory traffic), then one warp per output feature streams that
// feature's weight row as K1 does (dequant.cuh): each lane dequantizes a
// 32-weight block once into registers and dots it with all B rows, keeping
// one accumulator per row, so one weight read serves every slot. Each row
// sums in the same order whatever B is, so slot s of a batched step equals
// a one-row step on slot s's state bit for bit. The current token's k/v are
// written into the cache before the attention reads rows [0, pos]: exact in
// f32; on a bf16 cache the current row is rounded to bf16 too (the TPU
// kernels fold the f32 row in analytically). The plain version does the
// same. Inactive slots still compute and write their row at a frozen pos,
// which nothing reads. A single persistent launch per step is later work.
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

using namespace tts;

constexpr int WARPS = 8;
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

// Grid N / WARPS blocks; B <= ROWS input rows x (B, K), outputs (B, N).
template <int QT, bool PACKED, bool LN, int EPI, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
gemv_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
            const float* __restrict__ ln_b, const uint8_t* __restrict__ codes,
            const __nv_bfloat16* __restrict__ scales, int B, int N, int K,
            const float* res, float* out, CacheArgs c) {
  extern __shared__ float4 xs4[];  // B x K floats: the normalized input rows
  const float* xin = x;
  if constexpr (LN) {
    __shared__ float red[WARPS];
    float* xs = reinterpret_cast<float*>(xs4);
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
    xin = xs;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;
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

constexpr size_t OPT_IN_FROM = 47 * 1024;

template <int QT, bool PACKED, bool LN, int EPI, int ROWS>
int launch_one(const float* x, const float* ln_w, const float* ln_b,
               const uint8_t* codes, const __nv_bfloat16* sc, int B, int N,
               int K, const float* res, float* out, CacheArgs c,
               cudaStream_t s) {
  const dim3 grid((N + WARPS - 1) / WARPS);
  const size_t smem = LN ? (size_t)B * K * sizeof(float) : 0;
  auto kern = gemv_kernel<QT, PACKED, LN, EPI, ROWS>;
  // A block gets 48 KB without opting in, its static shared memory (the
  // norm's block sum) included: opt in before the dynamic rows reach it.
  if (smem > OPT_IN_FROM) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<grid, WARPS * 32, smem, s>>>(x, ln_w, ln_b, codes, sc, B, N, K, res,
                                      out, c);
  return (int)cudaGetLastError();
}

template <int QT, bool PACKED, int ROWS>
int launch(int ln, int epi, const float* x, const float* ln_w,
           const float* ln_b, const uint8_t* codes, const void* scales, int B,
           int N, int K, const float* res, float* out, CacheArgs c,
           cudaStream_t s) {
  const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(scales);
#define TTS_GEMV_ARGS x, ln_w, ln_b, codes, sc, B, N, K, res, out, c, s
  if (ln && epi == EPI_QKV) {
    return launch_one<QT, PACKED, true, EPI_QKV, ROWS>(TTS_GEMV_ARGS);
  } else if (ln && epi == EPI_STORE) {
    return launch_one<QT, PACKED, true, EPI_STORE, ROWS>(TTS_GEMV_ARGS);
  } else if (ln && epi == EPI_GELU) {
    return launch_one<QT, PACKED, true, EPI_GELU, ROWS>(TTS_GEMV_ARGS);
  } else if (!ln && epi == EPI_RESIDUAL) {
    return launch_one<QT, PACKED, false, EPI_RESIDUAL, ROWS>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int ROWS>
int dispatch(int ln, int epi, const float* x, const float* ln_w,
             const float* ln_b, const uint8_t* codes, const void* scales,
             int qtype, int packed, int B, int N, int K, const float* res,
             float* out, CacheArgs c, cudaStream_t s) {
#define TTS_GEMV_ARGS ln, epi, x, ln_w, ln_b, codes, scales, B, N, K, res, out, c, s
  if (qtype == Q4_0 && packed) {
    return launch<Q4_0, true, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q4_0) {
    return launch<Q4_0, false, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q5_0 && !packed) {
    return launch<Q5_0, false, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q8_0 && !packed) {
    return launch<Q8_0, false, ROWS>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

constexpr int MAX_ROWS = 16;
constexpr size_t MAX_SMEM = 232448;  // what one block may opt in to on sm_90

// out (B, N) = epilogue(LN?(x) @ dequant(W)^T) for x (B, K), W (N, K) with
// bf16 scales, 1 <= B <= 16 (K2 is the call with B = 1). (ln, epi) is one
// of (1, QKV), (1, STORE), (1, GELU), (0, RESIDUAL); the cache arguments
// are read only by the QKV epilogue (N = 3 * hidden): slot r's k/v go to
// kc/vc + r * kv_bstride elements, row min(pos[r], ctx - 1).
extern "C" int tts_parler_gemv(
    const float* x, const float* ln_w, const float* ln_b, int ln,
    const uint8_t* codes, const void* scales, int qtype, int packed, int B,
    int N, int K, const float* res, float* out, int epi, void* kc, void* vc,
    const int* pos, int hidden, int d, int ctx, int cache_bf16,
    long long kv_bstride, void* stream) {
  if (B <= 0 || B > MAX_ROWS || N <= 0 || K <= 0 || K % tts::QK ||
      (ln && (size_t)B * K * sizeof(float) > MAX_SMEM)) {
    return (int)cudaErrorInvalidValue;
  }
  const CacheArgs c{kc, vc, pos, hidden, d, ctx, cache_bf16, kv_bstride};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TTS_GEMV_ARGS ln, epi, x, ln_w, ln_b, codes, scales, qtype, packed, B, N, K, res, out, c, s
  if (B == 1) return dispatch<1>(TTS_GEMV_ARGS);
  if (B <= 8) return dispatch<8>(TTS_GEMV_ARGS);
  return dispatch<MAX_ROWS>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}
