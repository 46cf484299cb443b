// K10 and K11: the Dia decode step's block-dequant GEMV. K10 runs the L
// decoder layers for one request's CFG pair (the conditional and the
// unconditional sequence as two input rows); K11 runs them for B pairs, 2B
// rows, each pair at its own position with its own caches and cross K/V.
// Both drive this GEMV, K4 (decode_attention.cu, tts_decode_attention) for
// the self-attention and the cross-attention entry of decode_attention.cu
// (tts_cross_attention) from ops/dia_megastep.py.
//
// Replaces the TPU kernels tts_tpu/ops/dia_megastep.py:_dia_kernel (wrapper
// dia_megastep) and :_dia_batched_kernel (wrapper dia_megastep_batched):
// per layer RMS -> qkv -> NeoX RoPE (theta 10000) -> GQA self-attention at
// softmax scale 1.0 -> o -> RMS -> cross q + RoPE -> cross-attention over
// the bucketed cross K/V with the analytic pad-tail fold -> cross o -> RMS
// -> SiLU(gate) * up -> down, every projection block-quantized with bf16
// scales and the TPU's `_dqdot` numerics (the weight dequantized in f32 and
// rounded once to bf16, activations rounded to bf16, f32 sums).
//
// What bounds it on the H100: a decode step reads every weight once for 2
// flops per weight and row: at Dia-1.6B width 18 x (3072 x 2048 + 3 x 2048
// x 2048 + 3 x 8192 x 2048) = 1.25 G Q4_0 weights x 0.5625 B = 0.70 GB,
// plus 73.7 KB of bf16 K/V rows per cache position for the pair and the
// bucketed cross K/V (~75 MB at a bucket of 256): about 0.25 ms at 3.35
// TB/s at position 1000. Memory bandwidth, and launch latency on the host
// (8 launches a layer). K11 reads the weights once for every pair.
//
// Design: the TPU kernel streams the layers through one sequential (layer,
// phase) grid and carries x in VMEM; H100 blocks run in no order, so the
// step is a launch sequence on one stream, per layer:
//   1. gemv  RMS prologue, qkv;  epilogue RoPE on q and k, k and v written
//            into cache row pos (EPI_ROPE_QKV)
//   2. K4    GQA self-attention of each row over its own cache rows [0, pos]
//   3. gemv  o;                  epilogue x += .
//   4. gemv  RMS prologue, cross q;  epilogue RoPE (EPI_ROPE_QKV with no k
//            or v features: kvh = 0 rotates every feature and writes no
//            cache row)
//   5. cross-attention over all Sb bucket rows, the tail folded last
//   6. gemv  cross o;            epilogue x += .
//   7. gemv  RMS prologue, gate and up;  epilogue SiLU(gate) * up
//   8. gemv  down;               epilogue x += .
// The GEMV is the llama steps' (gemv.cuh), instantiated here for the rows
// the Dia steps take: 2 (K10's pair), 8 and 16 (K11 at up to 4 and 8
// pairs), bf16 scales only (prep_dia_mega keeps every scale in bf16, as the
// TPU prep does) and the qtypes prep_dia_mega admits. A source of its own
// builds in parallel with llama_megastep.cu, whose 1/8/16-row set is the
// slowest of the sources to compile; a 2-row instantiation keeps K10 from
// carrying 8 accumulators per row through the 8-row kernel.
//
// Where it can go wrong, and what this design does:
//  * Per-pair bit-identity: each K11 pair equals K10 on that pair's state
//    bit for bit. A row sums in the same order whatever ROWS is (gemv.cuh),
//    K4 and the cross-attention treat each row alone, so the engine's
//    greedy codes equal the single-stream runner's.
//  * Attention roundings: the TPU batched kernel rounds q, K/V and the
//    probabilities to bf16 for its dots, the single-stream one does not;
//    K11 keeps K10's f32 softmax (the JAX reference of K11 is K10's per
//    pair).
//  * Mixed positions: row r reads its position at pos[r * pos_stride] (K11
//    passes each pair's position twice) and writes its cache at r *
//    kv_bstride; frozen pairs write their stale row in their own cache only.
//  * The current token: the TPU kernel folds the unrounded f32 k/v of the
//    current token into the softmax and its caller writes the cache row
//    afterwards. Here the qkv epilogue writes the row first and K4 attends
//    rows [0, pos], as K8 does: exact in f32; on a bf16 cache the current
//    row is rounded to bf16 before it is attended (the plain versions do
//    the same).
//  * RoPE angles reach pos x inv_freq[0] = 3071 rad at the end of the
//    cache: the accurate cosf / sinf (no --use_fast_math anywhere).
#include <cuda_runtime.h>

#include "gemv.cuh"

namespace {

template <int QT, bool PACKED, int ROWS>
int launch(int rms, int epi, const float* x, const float* norm_w,
           const uint8_t* ca, const void* sa, const uint8_t* cb, const void* sb,
           int B, int P, int N, int K, const float* res, float* out,
           RopeArgs ra, cudaStream_t s) {
#define TTS_GEMV_ARGS x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (rms && epi == EPI_ROPE_QKV) {
    return launch_one<QT, PACKED, true, true, EPI_ROPE_QKV, ROWS>(TTS_GEMV_ARGS);
  } else if (rms && epi == EPI_SILU_MUL) {
    return launch_one<QT, PACKED, true, true, EPI_SILU_MUL, ROWS>(TTS_GEMV_ARGS);
  } else if (!rms && epi == EPI_RESIDUAL) {
    return launch_one<QT, PACKED, true, false, EPI_RESIDUAL, ROWS>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int ROWS>
int dispatch(int qtype, int packed, int rms, int epi, const float* x,
             const float* norm_w, const uint8_t* ca, const void* sa,
             const uint8_t* cb, const void* sb, int B, int P, int N, int K,
             const float* res, float* out, RopeArgs ra, cudaStream_t s) {
#define TTS_GEMV_ARGS rms, epi, x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (qtype == Q4_0 && packed) {
    return launch<Q4_0, true, ROWS>(TTS_GEMV_ARGS);
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

// tts_llama_gemv's contract (llama_megastep.cu) for the Dia steps: bf16
// scales only (scale_bf16 must be 1), Q4_0 packed, Q5_0 or Q8_0, 1 <= B <=
// 16, and (rms, epi) one of (1, ROPE_QKV), (1, SILU_MUL), (0, RESIDUAL).
// ROPE_QKV with kvh = 0 rotates q alone and writes no cache (the cross q).
extern "C" int tts_dia_gemv(
    const float* x, const float* norm_w, int rms, const uint8_t* codes_a,
    const void* scales_a, const uint8_t* codes_b, const void* scales_b,
    int qtype, int packed, int scale_bf16, int B, int N, int K,
    const float* res, float* out, int epi, const float* inv, const int* pos,
    int pos_stride, void* kc, void* vc, int hidden, int kvh, int d, int ctx,
    int cache_bf16, long long kv_bstride, void* stream) {
  if (B <= 0 || B > MAX_ROWS || N <= 0 || N % 2 || K <= 0 || K % tts::QK ||
      !scale_bf16) {
    return (int)cudaErrorInvalidValue;
  }
  if (epi == EPI_ROPE_QKV &&
      (d <= 0 || d % 2 || hidden % d || kvh % d || N != hidden + 2 * kvh)) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = epi == EPI_SILU_MUL ? N : N / 2;
  const RopeArgs ra{inv, pos, pos_stride, kc, vc, hidden, kvh, d, ctx,
                    cache_bf16, kv_bstride};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TTS_GEMV_ARGS qtype, packed, rms, epi, x, norm_w, codes_a, scales_a, codes_b, scales_b, B, P, N, K, res, out, ra, s
  if (B <= 2) return dispatch<2>(TTS_GEMV_ARGS);
  if (B <= 8) return dispatch<8>(TTS_GEMV_ARGS);
  return dispatch<MAX_ROWS>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}
