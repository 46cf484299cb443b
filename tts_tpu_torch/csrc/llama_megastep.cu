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
// the epilogues that pair features need no exchange between threads: RoPE
// rotates features i and i + d/2 of one head, and SiLU(gate) * up pairs
// gate row n with up row n. The other epilogues take rows 2p and 2p + 1.
// The kernel (gemv.cuh, shared with the Dia steps' source) is templated on
// the n-tiles of input rows (1 for up to 8 rows, 2 for 9-16); the batched
// steps (K9, K7) are K8's and K6's launch sequences with B rows, the
// attention launch being K4, the batched K3.
//
// The GEMV on the card (gemv.cuh):
//  * Tensor cores. A warp's tile is 8 feature pairs = 16 weight rows, the
//    A operand of mma.sync m16n8k16 (bf16 in, f32 out): rows 0-7 the
//    pairs' "a" rows, 8-15 their "b" rows, so that the D fragment gives
//    each thread both features of one pair for two input rows and the
//    epilogues run in registers. The input rows are the B operand, staged
//    once per block as bf16 (the rounding the `_dqdot` product applies);
//    1-8 rows fill one n-tile, 9-16 two. Weights are dequantized straight
//    into A fragments with the `_dqdot` rounding (bf16 of the f32 product
//    of the code value and the scale; for Q4_0 with bf16 scales in bf16x2
//    arithmetic, which rounds the same exact product once). Each
//    32-weight block's two mma products are summed apart and added into
//    the f32 accumulators in block order, as the CUDA-core dot summed each
//    block before: the tensor core's own sums then span 32 products.
//  * The weight stream. Each warp keeps a ring of stages in shared memory
//    (4 blocks of K of its 16 rows a stage: 1152 bytes for Q4_0 with bf16
//    scales; 6 stages at one n-tile, 4 at two), fed by 16-byte cp.async
//    copies, the copies of stage u + depth issued while stage u is
//    computed, across tiles. The prep tiles each projection in that order
//    (ops/llama_megastep.py gemv_tile), so a stage is one contiguous run of
//    codes and one of scales (row-major weights, read as 64-byte pieces of
//    16 rows, streamed slower: PERF.md).
//  * K split over a cluster. k_split(K) blocks (2, or 4 past K 4096) each
//    take a K range of every tile and stage only that range of the input
//    rows, so 16 x 8192 (Orpheus's down at 16 rows) stages 64 KB a block
//    and the weights are read once. Warp w of each rank walks the same
//    tiles; ranks past 0 write their sums into rank 0's shared memory and
//    arrive on its mbarrier (release at cluster scope), rank 0 adds them in
//    rank order and applies the epilogue, and frees the slot by arriving on
//    the sender's barrier. The RMS norm's sums of squares are taken per
//    rank and exchanged the same way, through the cluster barrier.
//  * The grid: one block per SM at most (clusters that fit at once, no
//    more than the tiles), tiles spread over the clusters first (tile c +
//    C (w + 8 j) for warp w of cluster c), 8 warps a block. A block's
//    shared memory stays under half an SM's where it can (1-8 rows, and 16
//    rows up to K 4096), so that the next launch's blocks fit beside it.
//  * Programmatic dependent launch. Each launch carries the programmatic
//    stream serialization attribute; a block issues its first weight copies
//    (weights are never written), lets the next launch start, and waits
//    (griddepcontrol.wait) for the kernel before it before it reads x, res,
//    pos or a cache, or writes anything: a scratch buffer that the previous
//    launch still reads is never written early.
//
// Where the batched steps can go wrong, and what this design does:
//  * Per-slot bit-identity: each K9 slot equals K8 on that slot's state,
//    and each K7 slot K6, bit for bit. A row's sum has one order whatever B
//    and whatever column of the n-tile it takes: the k16 steps in block
//    order, the K split fixed by K, the ranks added in rank order, and each
//    column of an mma summed apart from the others; the RMS sums per row;
//    and K4 on one slot equals K3. The engine's greedy tokens equal the
//    single-stream runner's because of it.
//  * Attention roundings: the TPU batched kernels round q, K/V and the
//    softmax probabilities to bf16 for their page dots; the single-stream
//    ones do not. K4 keeps K3's f32 softmax instead, so that slots equal
//    K8/K6 (the JAX package's reference for both batched kernels is the
//    single-stream reference per slot).
//  * Mixed positions: row r reads its position at pos[r * pos_stride] and
//    writes its cache at r * kv_bstride; the checks put slots at different
//    positions that straddle K4's 256-row pages, one of them at 0.
//  * Shared memory: each instantiation opts in once to the 226 KB of
//    dynamic shared memory any launch of it may ask for.
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

template <int NT>
int dispatch(int qtype, int packed, int scale_bf16, const float* x,
             const float* norm_w, const uint8_t* ca, const void* sa, int B,
             int P, int N, int K, int epi, const float* res, float* out,
             RopeArgs ra, cudaStream_t s) {
#define TTS_GEMV_ARGS x, norm_w, ca, sa, B, P, N, K, epi, res, out, ra, s
  if (qtype == Q4_0 && packed) {
    return scale_bf16 ? launch_one<Q4_0, true, true, NT>(TTS_GEMV_ARGS)
                      : launch_one<Q4_0, true, false, NT>(TTS_GEMV_ARGS);
  } else if (qtype == Q5_0 && !packed) {
    return scale_bf16 ? launch_one<Q5_0, false, true, NT>(TTS_GEMV_ARGS)
                      : launch_one<Q5_0, false, false, NT>(TTS_GEMV_ARGS);
  } else if (qtype == Q8_0 && !packed) {
    return scale_bf16 ? launch_one<Q8_0, false, true, NT>(TTS_GEMV_ARGS)
                      : launch_one<Q8_0, false, false, NT>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// out = epilogue(RMS?(x) @ dequant(W)^T) for x (B, K), the weights tiled
// (ops/llama_megastep.py gemv_tile, the pairs of `epi`: codes_a the tiles'
// codes, scales_a their scales; Q4_0 nibble-packed, Q5_0 or Q8_0), with
// f32 (scale_bf16 = 0) or bf16 scales and the `_dqdot` rounding either way;
// 1 <= B <= 16 (K6/K8 are the calls with B = 1, K7/K9 with one row per
// slot); K a multiple of 256 (512 past 4096). (rms, epi) is one of
//   (1, ROPE_QKV): W = qkv (hidden + 2 kvh rows); out (B, hidden + 2 kvh)
//                  with q and k of row r rotated at pos[r * pos_stride];
//                  row r's k and v also written into its cache (kc / vc +
//                  r * kv_bstride elements) at row min(pos, ctx - 1);
//   (1, SILU_MUL): W tiles gate and up, both (N, K); out (B, N);
//   (1, STORE)   : out (B, N), N even;
//   (0, RESIDUAL): out = res + ., N even (res may be out).
// codes_b / scales_b are not read (the tiles hold both rows of every pair).
// Launched with programmatic dependent launch on `stream`.
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
  const bool ok = (rms && (epi == EPI_ROPE_QKV || epi == EPI_SILU_MUL ||
                           epi == EPI_STORE)) ||
                  (!rms && epi == EPI_RESIDUAL);
  if (!ok || (rms && norm_w == nullptr)) return (int)cudaErrorInvalidValue;
  const int P = epi == EPI_SILU_MUL ? N : N / 2;
  const RopeArgs ra{inv, pos, pos_stride, kc, vc, hidden, kvh, d, ctx,
                    cache_bf16, kv_bstride};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TTS_GEMV_ARGS qtype, packed, scale_bf16, x, rms ? norm_w : nullptr, codes_a, scales_a, B, P, N, K, epi, res, out, ra, s
  if (B <= 8) return dispatch<1>(TTS_GEMV_ARGS);
  return dispatch<2>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}
