// K8, K6, K9 and K7: the Orpheus (llama-family) decode step's block-dequant
// GEMV, with the RMS norm fused as a prologue and the epilogues of the step
// fused after it. K8 runs the L layers for one sequence; K6 runs the same
// layers and then the final RMS norm and the padded LM head. K9 and K7 are
// K8 and K6 for B <= 16 batch slots, one input row per slot, each slot at
// its own position with its own cache. All four drive this one kernel
// (ops/llama_megastep.py, ops/llama_flat.py).
//
// Replaces the TPU kernels tts_tpu/ops/llama_megastep.py:_llama_kernel
// (wrapper llama_megastep), tts_tpu/ops/llama_flat.py:_flat_kernel
// (wrapper llama_flat_megastep), tts_tpu/ops/llama_megastep.py:
// _llama_batched_kernel (wrapper llama_megastep_batched) and _flat_kernel
// with batched=True (wrapper llama_flat_megastep_batched): per layer RMS ->
// qkv -> NeoX RoPE with the llama3 frequency factors -> GQA attention over
// the cache -> o -> RMS -> SiLU(gate) * up -> down, weights
// block-quantized, the TPU's `_dqdot`
// numerics (the weight dequantized in f32 with its f32 or bf16 scale and
// rounded once to bf16, activations rounded to bf16, f32 sums). The scale
// dtype here is only a storage choice, not a numerics mode as in K1: K8
// keeps the qkv scales in f32 and the others in bf16, as the TPU kernel's
// prep does; K6 keeps every scale in bf16. Either way the product rounds.
//
// What bounds it on the H100: a decode step reads every weight once for 2
// flops: at Orpheus-3B width 28 x (3072 x 5120 + 3072 x 3072 + 3 x 3072 x
// 8192) = 2.82 G Q4_0 weights x 0.5625 B = 1.585 GB, plus K6's head of
// 157,184 x 3072 (0.272 GB), plus 114,688 B of bf16 K/V rows per cache
// position: about 0.59 ms for K6 at 3.35 TB/s at position 1000. Memory
// bandwidth; at this size launch latency matters less than for Parler. The
// batched steps read the weights once for every slot and each slot's own
// K/V rows: K7 at 8 slots at positions 0..3000 (7334 rows in all) 1.86 GB
// of weights + 0.84 GB of K/V, about 0.81 ms; K9 (no head) about 0.73 ms.
//
// Design: the TPU kernels stream the layers through one sequential grid and
// carry x in VMEM. Blocks on the H100 run in no order and nothing carries
// between them, so the step is a sequence of launches on one stream, per
// layer (the Python wrappers drive it):
//   1. gemv  RMS prologue, qkv;  epilogue RoPE on q and k, and k, v written
//            into cache row pos
//   2. K3    GQA attention over cache rows [0, pos] (kv head j serves q
//            heads [j * g, (j + 1) * g))
//   3. gemv  o;              epilogue x += .
//   4. gemv  RMS prologue, gate and up;  epilogue SiLU(gate) * up
//   5. gemv  down;           epilogue x += .
// and for K6, after the last layer:
//   6. gemv  RMS(out_norm) prologue, head;  epilogue store the logits.
// Each warp computes feature pairs, two output features at a time, so that
// the epilogues that pair features need no exchange between warps: RoPE
// rotates features i and i + d/2 of one head, and SiLU(gate) * up pairs
// gate row n with up row n. The other epilogues take rows 2p and 2p + 1.
// Lane l of a warp takes the 32-weight blocks l, l + 32, ... of both rows
// of a pair, dequantizes each block once into registers (dequant.cuh) and
// dots it with every input row. The kernel (gemv.cuh, shared with the Dia
// steps' source) is templated on the input rows (ROWS 1, 8 or 16 here), as
// K2/K5 are; the batched steps (K9, K7) are K8's and K6's launch
// sequences with B rows, the attention launch being K4, the batched K3.
//
// The GEMV's shape on the card: a grid of at most one block of 12 warps
// per SM, in clusters of 2 (at Orpheus-3B width every launch but o and
// down, 128 blocks, fills the 132 SMs), each warp walking many feature
// pairs (pair p = block + G * (warp + 12 k) over G blocks, so that pairs
// spread over the blocks first). A block first stages its B input rows
// whole in dynamic shared memory as bf16 (the rounding the dot applies
// anyway; B x K bf16 is 48 KB at 8 x 3072, 128 KB at 8 x 8192, staged in
// two passes of rows where it would exceed 224 KB: 16 x 8192), the RMS norm
// applied on the way (its sum of squares over the first 8 warps, the shape
// it always had). The two blocks of a cluster each normalize and round
// half of the rows and copy them into the other's shared memory
// (distributed shared memory), so a cluster reads each row from L2 once:
// about 1.0 GB of staging reads for a K7 step at 8 slots against its 1.86
// GB of weights, where blocks of 16 features that each staged every row
// (twice under the RMS norm) read about 11 GB. While the rows stage, each
// warp already has the codes and scales of its first (pair, block) units in
// flight, and it keeps the next PF = 2 units' loads (1 at 16 rows) ahead
// of the arithmetic of the current one, so weight bytes stream while the block
// stages and computes. What bounds it then: at 8-16 rows the SMs' issue
// rate (each weight is dequantized once and multiplied into every row: 2
// flops per weight and row, plus the bf16 unpacking of the staged rows),
// at one row the bytes. 12 warps of up to 168 registers fill an SM's
// register file; more warps would spill, fewer hide less latency (PERF.md).
//
// Where the batched steps can go wrong, and what this design does:
//  * Per-slot bit-identity: each K9 slot equals K8 on that slot's state,
//    and each K7 slot K6, bit for bit. A row sums in the same order
//    whatever ROWS is (the per-row accumulators are independent, the RMS
//    block sum and the warp sums are per row), and K4 on one slot equals
//    K3. The engine's greedy tokens equal the single-stream runner's
//    because of it.
//  * Attention roundings: the TPU batched kernels round q, K/V and the
//    softmax probabilities to bf16 for their page dots; the single-stream
//    ones do not. K4 keeps K3's f32 softmax instead, so that slots equal
//    K8/K6 (the JAX package's reference for both batched kernels is the
//    single-stream reference per slot).
//  * Mixed positions: row r reads its position at pos[r * pos_stride] and
//    writes its cache at r * kv_bstride; the checks put slots at different
//    positions that straddle K4's 256-row pages, one of them at 0.
//  * Activation reads: each lane reads its 32-element block of every row
//    once per weight block and pair (both rows of the pair dot the same
//    staged values), and the lanes of a warp read 32 consecutive blocks:
//    at a 128-byte lane stride, float4 loads of f32 rows would conflict in
//    the shared-memory banks and scatter over L1 lines, B times over (K5's
//    bottleneck, PERF.md). So the rows are staged as bf16 with the four
//    16-byte chunks of each 32-element block rotated by (block / 2): a
//    quarter warp's 8 loads hit 8 bank groups, and a row takes half the
//    bytes. Every lane visits its blocks in increasing order and each
//    block's products are summed as dequant.cuh's block_dot sums them, so
//    each (feature, row) sum is the same whatever the grid, the row count
//    or the staging.
//  * Shared memory: past the 48 KB a block gets without opting in, a
//    launch needs the kernel's cudaFuncAttributeMaxDynamicSharedMemorySize:
//    each instantiation opts in once, to the 224 KB any launch of it may
//    ask for, before its first launch.
//
// The current token's k/v: the TPU kernels fold the unrounded f32 k/v of
// the current token into the softmax, and the caller writes the cache row
// afterwards. Here, as in K2, the qkv epilogue writes the row first and K3
// attends rows [0, pos]: exact in f32; on a bf16 cache the current row is
// rounded to bf16 before it is attended. The plain versions do the same.
// RoPE angles reach pos x inv_freq[0] = 3584 rad at the end of the cache,
// so they use the accurate cosf / sinf (no --use_fast_math anywhere).
#include <cuda_runtime.h>

#include "gemv.cuh"

namespace {

template <int QT, bool PACKED, bool SBF16, int ROWS>
int launch(int rms, int epi, const float* x, const float* norm_w,
           const uint8_t* ca, const void* sa, const uint8_t* cb, const void* sb,
           int B, int P, int N, int K, const float* res, float* out,
           RopeArgs ra, cudaStream_t s) {
#define TTS_GEMV_ARGS x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (rms && epi == EPI_ROPE_QKV) {
    return launch_one<QT, PACKED, SBF16, true, EPI_ROPE_QKV, ROWS>(TTS_GEMV_ARGS);
  } else if (rms && epi == EPI_SILU_MUL) {
    return launch_one<QT, PACKED, SBF16, true, EPI_SILU_MUL, ROWS>(TTS_GEMV_ARGS);
  } else if (rms && epi == EPI_STORE) {
    return launch_one<QT, PACKED, SBF16, true, EPI_STORE, ROWS>(TTS_GEMV_ARGS);
  } else if (!rms && epi == EPI_RESIDUAL) {
    return launch_one<QT, PACKED, SBF16, false, EPI_RESIDUAL, ROWS>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int QT, bool PACKED, int ROWS>
int with_scales(int scale_bf16, int rms, int epi, const float* x,
                const float* norm_w, const uint8_t* ca, const void* sa,
                const uint8_t* cb, const void* sb, int B, int P, int N, int K,
                const float* res, float* out, RopeArgs ra, cudaStream_t s) {
#define TTS_GEMV_ARGS rms, epi, x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (scale_bf16) return launch<QT, PACKED, true, ROWS>(TTS_GEMV_ARGS);
  return launch<QT, PACKED, false, ROWS>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}

template <int ROWS>
int dispatch(int qtype, int packed, int scale_bf16, int rms, int epi,
             const float* x, const float* norm_w, const uint8_t* ca,
             const void* sa, const uint8_t* cb, const void* sb, int B, int P,
             int N, int K, const float* res, float* out, RopeArgs ra,
             cudaStream_t s) {
#define TTS_GEMV_ARGS scale_bf16, rms, epi, x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (qtype == Q4_0 && packed) {
    return with_scales<Q4_0, true, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q4_0) {
    return with_scales<Q4_0, false, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q5_0 && !packed) {
    return with_scales<Q5_0, false, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q8_0 && !packed) {
    return with_scales<Q8_0, false, ROWS>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

constexpr int MAX_ROWS = 16;

// out = epilogue(RMS?(x) @ dequant(W)^T) for x (B, K), weights row-major
// (N, K) as ops/quant_matmul.py lays them out, with f32 (scale_bf16 = 0) or
// bf16 scales and the `_dqdot` rounding either way; 1 <= B <= 16 (K6/K8
// are the calls with B = 1, K7/K9 with one row per slot). (rms, epi) is one of
//   (1, ROPE_QKV): W = qkv (hidden + 2 kvh rows); out (B, hidden + 2 kvh)
//                  with q and k of row r rotated at pos[r * pos_stride];
//                  row r's k and v also written into its cache (kc / vc +
//                  r * kv_bstride elements) at row min(pos, ctx - 1);
//   (1, SILU_MUL): A = gate, B = up, both (N, K); out (B, N);
//   (1, STORE)   : out (B, N), N even;
//   (0, RESIDUAL): out = res + ., N even (res may be out).
// codes_b / scales_b are read only by SILU_MUL; pass A's for the others.
extern "C" int tts_llama_gemv(
    const float* x, const float* norm_w, int rms, const uint8_t* codes_a,
    const void* scales_a, const uint8_t* codes_b, const void* scales_b,
    int qtype, int packed, int scale_bf16, int B, int N, int K,
    const float* res, float* out, int epi, const float* inv, const int* pos,
    int pos_stride, void* kc, void* vc, int hidden, int kvh, int d, int ctx,
    int cache_bf16, long long kv_bstride, void* stream) {
  if (B <= 0 || B > MAX_ROWS || N <= 0 || N % 2 || K <= 0 || K % tts::QK) {
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
#define TTS_GEMV_ARGS qtype, packed, scale_bf16, rms, epi, x, norm_w, codes_a, scales_a, codes_b, scales_b, B, P, N, K, res, out, ra, s
  if (B == 1) return dispatch<1>(TTS_GEMV_ARGS);
  if (B <= 8) return dispatch<8>(TTS_GEMV_ARGS);
  return dispatch<MAX_ROWS>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}
