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
// a one-row step on slot s's state bit for bit. The GEMV body lives in
// parler_gemv.cuh, shared with the one-launch K12 (parler_flat.cu). The
// current token's k/v are written into the cache before the attention
// reads rows [0, pos]: exact in
// f32; on a bf16 cache the current row is rounded to bf16 too (the TPU
// kernels fold the f32 row in analytically). The plain version does the
// same. Inactive slots still compute and write their row at a frozen pos,
// which nothing reads. K12 (parler_flat.cu) runs the same step as a
// single persistent launch.
#include <cuda_runtime.h>

#include "parler_gemv.cuh"

namespace {

using namespace tts;
using namespace tts::parler;

// Grid N / WARPS blocks; B <= ROWS input rows x (B, K), outputs (B, N). The
// body is parler_gemv.cuh's, which K12 runs inside its persistent loop.
template <int QT, bool PACKED, bool LN, int EPI, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
gemv_kernel(const float* __restrict__ x, const float* __restrict__ ln_w,
            const float* __restrict__ ln_b, const uint8_t* __restrict__ codes,
            const __nv_bfloat16* __restrict__ scales, int B, int N, int K,
            const float* res, float* out, CacheArgs c) {
  extern __shared__ float4 xs4[];  // B x K floats: the normalized input rows
  const float* xin = x;
  if constexpr (LN) {
    float* xs = reinterpret_cast<float*>(xs4);
    ln_rows(x, ln_w, ln_b, B, K, xs);
    xin = xs;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;
  gemv_feature<QT, PACKED, EPI, ROWS>(xin, codes, scales, B, N, K, res, out,
                                      c, n, lane);
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
  const tts::parler::CacheArgs c{kc, vc, pos, hidden, d, ctx, cache_bf16,
                                 kv_bstride};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TTS_GEMV_ARGS ln, epi, x, ln_w, ln_b, codes, scales, qtype, packed, B, N, K, res, out, c, s
  if (B == 1) return dispatch<1>(TTS_GEMV_ARGS);
  if (B <= 8) return dispatch<8>(TTS_GEMV_ARGS);
  return dispatch<MAX_ROWS>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}
