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
// Each gemv launch is parler_gemv.cuh's `gemv` (its header has the design:
// tensor cores, the B rows staged once per block as bf16 behind the layer
// norm, weights tiled at prep and streamed through a cp.async ring per
// warp, K split over the warps of a block), one block per group of tiles,
// launched with programmatic dependent launch: a block issues its first
// weight copies, lets the next launch start, then waits for the kernel
// before it. Each row sums in one order whatever B is, so slot s of a
// batched step equals a one-row step on slot s's state bit for bit; K12
// (parler_flat.cu) runs the same function inside its one persistent
// launch. The current token's k/v are written into the cache before the
// attention reads rows [0, pos]: exact in f32; on a bf16 cache the current
// row is rounded to bf16 too (the TPU kernels fold the f32 row in
// analytically). The plain version does the same. Inactive slots still
// compute and write their row at a frozen pos, which nothing reads.
#include <mutex>

#include <cuda_runtime.h>

#include "parler_gemv.cuh"

namespace {

using namespace tts;
using namespace tts::parler;

template <int QT, bool PACKED, int NT, bool LN, int EPI>
__global__ void __launch_bounds__(THREADS, 2)
gemv_kernel(const float* x, const float* ln_w, const float* ln_b,
            const uint8_t* __restrict__ codes,
            const __nv_bfloat16* __restrict__ scales, int B, int N, int K,
            const float* res, float* out, CacheArgs c) {
  extern __shared__ __align__(16) uint8_t smem[];
  gemv<QT, PACKED, NT, LN, EPI, true>(x, ln_w, ln_b, codes, scales, B, N, K,
                                      res, out, c, smem);
}

// One block per SM at most, each taking groups of WARPS / k_split(K) tiles
// in turn: a block stages its rows once for all its groups, and its warps'
// rings run ahead across them.
template <int QT, bool PACKED, int NT, bool LN, int EPI>
int launch_one(const float* x, const float* ln_w, const float* ln_b,
               const uint8_t* codes, const __nv_bfloat16* sc, int B, int N,
               int K, const float* res, float* out, CacheArgs c,
               cudaStream_t s) {
  auto kern = gemv_kernel<QT, PACKED, NT, LN, EPI>;
  const int smem = smem_bytes<PACKED, NT>(B, K);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // past 48 KB a launch needs the kernel's opt-in: each instantiation opts
  // in once, to every size a launch may ask for
  static std::once_flag opted;
  static cudaError_t opt_err = cudaSuccess;
  std::call_once(opted, [&] {
    opt_err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_LIMIT);
  });
  if (opt_err != cudaSuccess) return (int)opt_err;
  const int tpb = WARPS / k_split(K), groups = (N / TILE + tpb - 1) / tpb;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups < sm_count() ? groups : sm_count());
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, ln_w, ln_b, codes, sc,
                                           B, N, K, res, out, c);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int QT, bool PACKED, int NT>
int launch(int ln, int epi, const float* x, const float* ln_w,
           const float* ln_b, const uint8_t* codes, const void* scales, int B,
           int N, int K, const float* res, float* out, CacheArgs c,
           cudaStream_t s) {
  const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(scales);
#define TTS_GEMV_ARGS x, ln_w, ln_b, codes, sc, B, N, K, res, out, c, s
  if (ln && epi == EPI_QKV) {
    return launch_one<QT, PACKED, NT, true, EPI_QKV>(TTS_GEMV_ARGS);
  } else if (ln && epi == EPI_STORE) {
    return launch_one<QT, PACKED, NT, true, EPI_STORE>(TTS_GEMV_ARGS);
  } else if (ln && epi == EPI_GELU) {
    return launch_one<QT, PACKED, NT, true, EPI_GELU>(TTS_GEMV_ARGS);
  } else if (!ln && epi == EPI_RESIDUAL) {
    return launch_one<QT, PACKED, NT, false, EPI_RESIDUAL>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int NT>
int dispatch(int ln, int epi, const float* x, const float* ln_w,
             const float* ln_b, const uint8_t* codes, const void* scales,
             int qtype, int packed, int B, int N, int K, const float* res,
             float* out, CacheArgs c, cudaStream_t s) {
#define TTS_GEMV_ARGS ln, epi, x, ln_w, ln_b, codes, scales, B, N, K, res, out, c, s
  if (qtype == Q4_0 && packed) {
    return launch<Q4_0, true, NT>(TTS_GEMV_ARGS);
  } else if (qtype == Q5_0 && !packed) {
    return launch<Q5_0, false, NT>(TTS_GEMV_ARGS);
  } else if (qtype == Q8_0 && !packed) {
    return launch<Q8_0, false, NT>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out (B, N) = epilogue(LN?(x) @ dequant(W)^T) for x (B, K) and W (N, K)
// tiled (ops/parler_megastep.py prep_mega_layers: gemv_tile's "pairs",
// codes Q4_0 nibble-packed, Q5_0 or Q8_0, bf16 scales), 1 <= B <= 16 (K2 is
// the call with B = 1), N a multiple of 16, K of 128. (ln, epi) is one of
// (1, QKV), (1, STORE), (1, GELU), (0, RESIDUAL); with ln, ln_w / ln_b (K)
// are the norm's weight and bias; res may be out. The cache arguments are
// read only by the QKV epilogue (N = 3 * hidden): slot r's k/v go to kc/vc
// + r * kv_bstride elements, row min(pos[r], ctx - 1). x, ln_w, ln_b,
// codes and scales 16-byte aligned. Launched with programmatic dependent
// launch on `stream`.
extern "C" int tts_parler_gemv(
    const float* x, const float* ln_w, const float* ln_b, int ln,
    const uint8_t* codes, const void* scales, int qtype, int packed, int B,
    int N, int K, const float* res, float* out, int epi, void* kc, void* vc,
    const int* pos, int hidden, int d, int ctx, int cache_bf16,
    long long kv_bstride, void* stream) {
  if (B <= 0 || B > MAX_ROWS || N <= 0 || N % TILE || K <= 0 ||
      K % tts::UNIT_K || (size_t)x % 16 || (size_t)codes % 16 ||
      (size_t)scales % 16 ||
      (ln && (ln_w == nullptr || ln_b == nullptr || (size_t)ln_w % 16 ||
              (size_t)ln_b % 16)) ||
      (epi == EPI_QKV && (d <= 0 || d % 2 || hidden % d || N != 3 * hidden))) {
    return (int)cudaErrorInvalidValue;
  }
  const CacheArgs c{kc, vc, pos, hidden, d, ctx, cache_bf16, kv_bstride};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TTS_GEMV_ARGS ln, epi, x, ln_w, ln_b, codes, scales, qtype, packed, B, N, K, res, out, c, s
  if (B <= 8) return dispatch<1>(TTS_GEMV_ARGS);
  return dispatch<2>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}
