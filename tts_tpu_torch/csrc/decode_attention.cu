// K3 and K4: single-query decode attention over a KV cache, reading rows
// [0, pos], for one sequence (K3) or a batch of B sequences each at its own
// position (K4). K3 is K4 with B = 1: one kernel serves both.
//
// Replaces the TPU kernels tts_tpu/ops/decode_attention.py:_kernel (wrapper
// paged_decode_attention) and :_batched_kernel (wrapper
// paged_decode_attention_batched): q (B, Hq, D), k/v (B, Hkv, CTX, D) in
// bf16 or f32, GQA (q head h reads kv head h / n_rep), softmax in f32 with a
// running max and sum. `pos` (one per slot, or one shared) is read from
// device memory, so a decode loop never has to bring it to the host.
//
// What bounds it on the H100: every K and V row up to pos is read once and
// used for 2 flops per element: memory bandwidth (plus launch latency at
// short contexts).
//
// Design: the TPU kernels walk 256-row pages in a sequential grid, carrying
// the running max/sum in VMEM scratch. Blocks on the H100 run in no order,
// so here each 256-row page of each (slot, q head) is its own block (grid
// (B * Hq, CTX / 256)); pages past the slot's pos exit at once. Inside a
// block, lanes that share a cache row each read 16 bytes of it (8 lanes per
// 64-wide bf16 row), so a warp reads several whole rows per coalesced pass;
// each lane keeps an online-softmax state for its slice of D, merged across
// the warp with shuffles and across warps through shared memory. A second
// kernel merges each (slot, head)'s pages' partial (max, sum, weighted V)
// into the output, in page order; with one page (a context of at most 256
// rows, e.g. cross-attention) the first kernel writes the output itself.
// The page and combine bodies live in attention.cuh, shared with K12.
// The K/V batch stride may be 0: the Parler cross-attention K/V are shared
// by every slot, so one kernel serves both attentions of the batched step.
//
// The Dia steps' cross-attention (K10 / K11, ops/dia_megastep.py) is the
// same kernel through its own entry, tts_cross_attention: every row of the
// bucketed cross K/V attended (no position; MHA, scale 1.0), and the
// analytic pad tail of tts_tpu/ops/dia_megastep.py:_dia_kernel folded in as
// one more partial state. The reference attends the whole padded encoder
// window, whose rows past the bucket have K exactly 0 (logit 0) and V rows
// that sum to vtail: n_tail such rows are the state (m 0, l n_tail, acc
// vtail), merged after the pages, where `denom += n_tail e^{-m}` and
// `numer += e^{-m} vtail` of the TPU kernel take place. With n_tail 0 the
// fold is skipped (the TPU kernel then takes no max with 0 either).
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

using namespace tts::attn;

// Grid (B * Hq, n_pages). Writes out (B * Hq, D) directly when n_pages == 1,
// else the page's partial state to part_ml (B * Hq, n_pages, 2) / part_acc
// (B * Hq, n_pages, D). Slot s reads q at q + s * q_bstride, its cache at
// kc/vc + s * kv_bstride and its position at pos[s * pos_stride] (every row
// of the cache when pos_ptr is null). With a tail, the state (0, n_tail,
// tail[(s * Hq + h) * D ..]) is merged last (see the header). The body is
// attention.cuh's, which K12 runs inside its persistent loop.
template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
attn_page_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int* __restrict__ pos_ptr,
                 float* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int hq, int n_rep, int ctx,
                 long long q_bstride, long long kv_bstride, int pos_stride,
                 float scale, const float* __restrict__ tail, float n_tail) {
  const int bh = blockIdx.x, s = bh / hq;
  const int pos = pos_ptr ? min(pos_ptr[(size_t)s * pos_stride], ctx - 1) : ctx - 1;
  attn_page<T, D, true>(q, kc, vc, pos, out, part_ml, part_acc, bh,
                        blockIdx.y, gridDim.y, hq, n_rep, ctx, q_bstride,
                        kv_bstride, scale, tail, n_tail);
}

// Grid (B * Hq), D threads: merge the pages [0, pos / 256] of each
// (slot, head) in page order, then the tail when there is one.
__global__ void attn_combine_kernel(const float* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    const int* __restrict__ pos_ptr,
                                    float* __restrict__ out, int hq,
                                    int n_pages, int ctx, int pos_stride,
                                    int D, const float* __restrict__ tail,
                                    float n_tail) {
  const int bh = blockIdx.x;
  const int s = bh / hq;
  const int last = (pos_ptr ? min(pos_ptr[(size_t)s * pos_stride], ctx - 1) : ctx - 1) / PAGE;
  attn_combine(part_ml, part_acc, last, out, bh, n_pages, D, tail, n_tail,
               threadIdx.x);
}

template <typename T, int D>
void launch(const float* q, const void* kc, const void* vc, const int* pos,
            float* out, float* part_ml, float* part_acc, int b, int hq,
            int n_rep, int ctx, long long q_bstride, long long kv_bstride,
            int pos_stride, float scale, const float* tail, float n_tail,
            cudaStream_t s) {
  const int n_pages = (ctx + PAGE - 1) / PAGE;
  attn_page_kernel<T, D><<<dim3(b * hq, n_pages), NWARPS * 32, 0, s>>>(
      q, reinterpret_cast<const T*>(kc), reinterpret_cast<const T*>(vc), pos,
      out, part_ml, part_acc, hq, n_rep, ctx, q_bstride, kv_bstride,
      pos_stride, scale, tail, n_tail);
  if (n_pages > 1) {
    attn_combine_kernel<<<b * hq, D, 0, s>>>(part_ml, part_acc, pos, out, hq,
                                             n_pages, ctx, pos_stride, D, tail,
                                             n_tail);
  }
}

int dispatch(const float* q, const void* kc, const void* vc, const int* pos,
             float* out, float* part_ml, float* part_acc, int b, int hq,
             int n_rep, int ctx, int d, int cache_bf16, long long q_bstride,
             long long kv_bstride, int pos_stride, float scale,
             const float* tail, float n_tail, cudaStream_t s) {
  if (b <= 0 || hq <= 0 || n_rep <= 0 || hq % n_rep || ctx <= 0 ||
      (ctx + PAGE - 1) / PAGE > 65535) {
    return (int)cudaErrorInvalidValue;
  }
#define TTS_ATTN_ARGS q, kc, vc, pos, out, part_ml, part_acc, b, hq, n_rep, ctx, \
                      q_bstride, kv_bstride, pos_stride, scale, tail, n_tail, s
  if (cache_bf16 && d == 64) {
    launch<__nv_bfloat16, 64>(TTS_ATTN_ARGS);
  } else if (cache_bf16 && d == 128) {
    launch<__nv_bfloat16, 128>(TTS_ATTN_ARGS);
  } else if (!cache_bf16 && d == 64) {
    launch<float, 64>(TTS_ATTN_ARGS);
  } else if (!cache_bf16 && d == 128) {
    launch<float, 128>(TTS_ATTN_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef TTS_ATTN_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, d) f32, slot s at q + s * q_bstride (the heads of a slot
// contiguous); kc/vc (b, hq / n_rep, ctx, d), bf16 (cache_bf16) or f32,
// slot s at + s * kv_bstride elements (0: one cache shared by every slot);
// pos device int32, slot s at pos[s * pos_stride] (0: one shared position);
// out (b, hq, d) f32; part_ml (b * hq, ceil(ctx/256), 2) and part_acc
// (b * hq, ceil(ctx/256), d) f32 scratch. d must be 64 or 128. K3 is the
// call with b = 1.
extern "C" int tts_decode_attention(
    const float* q, const void* kc, const void* vc, const int* pos,
    float* out, float* part_ml, float* part_acc, int b, int hq, int n_rep,
    int ctx, int d, int cache_bf16, long long q_bstride, long long kv_bstride,
    int pos_stride, float scale, void* stream) {
  return dispatch(q, kc, vc, pos, out, part_ml, part_acc, b, hq, n_rep, ctx,
                  d, cache_bf16, q_bstride, kv_bstride, pos_stride, scale,
                  nullptr, 0.f, reinterpret_cast<cudaStream_t>(stream));
}

// The Dia cross-attention: q (b, hq, d) f32 as above; kc/vc (b, hq, sb, d)
// bf16 or f32, slot s at + s * kv_bstride elements, every one of the sb rows
// attended (MHA); tail (b * hq, d) f32, the V sum of the n_tail pad rows of
// logit 0 past the bucket, or null when n_tail is 0; out and scratch as
// above with ctx = sb.
extern "C" int tts_cross_attention(
    const float* q, const void* kc, const void* vc, const float* tail,
    float n_tail, float* out, float* part_ml, float* part_acc, int b, int hq,
    int sb, int d, int cache_bf16, long long q_bstride, long long kv_bstride,
    float scale, void* stream) {
  if ((tail == nullptr) != (n_tail == 0.f) || n_tail < 0.f) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch(q, kc, vc, nullptr, out, part_ml, part_acc, b, hq, 1, sb, d,
                  cache_bf16, q_bstride, kv_bstride, 0, scale, tail, n_tail,
                  reinterpret_cast<cudaStream_t>(stream));
}
