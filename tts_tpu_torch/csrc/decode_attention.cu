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
// so here each 256-row page of each (slot, kv head) is its own block (grid
// (B * Hq / G, CTX / 256)), serving the G q heads that share the kv head
// (G = n_rep up to 4: 3 for Orpheus's 24 / 8 heads, 4 for Dia's 16 / 4);
// pages past the slot's pos exit at once. A block has G groups of NWARPS
// warps, one group per q head; the groups walk the same rows at the same
// time, so a row comes from device memory (and L2) once per kv head and
// from L1 for the other heads. (Keeping the G heads' states in each lane
// of one group instead was slower, 4 warps doing G heads' arithmetic, and
// its code sums no longer matched the one-head block's bit for bit:
// PERF.md.) Inside a group, lanes that share a cache row each read 16
// bytes of it (8 lanes per 64-wide bf16 row), so a warp reads several whole
// rows per coalesced pass, and issues the K and V loads of PF = 8 passes
// (4 in a grid of more than two blocks per SM) before their arithmetic
// (one memory round trip per PF passes, where a pass that loads K, reduces
// the score and only then loads V takes two);
// each lane keeps an online-softmax state for its slice of D, merged
// across the warp with shuffles and across warps through shared memory.
// When pos lies in the first page, that page writes the output itself;
// otherwise every live page writes its partial (max, sum, weighted V) per
// q head, and the block that finishes the (slot, kv head)'s pages last,
// counted on a per-item arrival counter that it resets to 0 itself, merges
// them in page order: one launch per call, no combine launch and no memset
// (the counters are zeroed once, when the wrapper allocates them). The
// page and merge bodies live in attention.cuh, shared with K12; each lane
// sums the same rows in the same order as a block of one q head with one
// pass in flight, so the outputs are the two-launch design's bit for bit.
// The K/V batch stride may be 0: the Parler cross-attention K/V are shared
// by every slot, so one kernel serves both attentions of the batched step.
// Head sizes: the models' 64 and 128 are compiled for; every other size
// from 1 to 1024 (attention.cuh head_size_ok; the JAX kernel takes any D)
// runs on a generic instantiation per cache dtype, group and width (256,
// 512, 1024: attention.cuh generic_cap), which takes the head size at run
// time and spreads a row over the lanes as attention.cuh's lane layout
// says; a row that is not whole 16-byte chunks is read element by element
// (its own instantiation: WHOLE false).
// Past 512 a block serves at most 2 q heads (its merge's shared memory).
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
#include <atomic>

#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

using namespace tts::attn;

// Grid (B * Hq / G, n_pages): block (bg, page) is page `page` of the q
// heads [g * G, g * G + G) of slot s (bg = s * Hq / G + g). Writes out
// (B * Hq, D) directly when the slot's position lies in page 0, else the
// page's partial states to part_ml (B * Hq, n_pages, 2) / part_acc
// (B * Hq, n_pages, D), and the item's last block to finish merges them
// (arrivals: B * Hq / G counters, zero on entry and on exit). Slot s reads
// q at q + s * q_bstride, its cache at kc/vc + s * kv_bstride and its
// position at pos[s * pos_stride] (every row of the cache when pos_ptr is
// null). With a tail, the state (0, n_tail, tail[(s * Hq + h) * D ..]) is
// merged last (see the header). D 0: the head size is d, up to DCAP (the
// generic path; WHOLE: d a multiple of 16 / sizeof(T)), else D.
template <typename T, int D, int G, int PF, int DCAP, bool WHOLE>
__global__ void __launch_bounds__(NWARPS * G * 32)
attn_page_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int* __restrict__ pos_ptr,
                 float* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc,
                 unsigned int* __restrict__ arrivals, int hq, int n_rep,
                 int ctx, long long q_bstride, long long kv_bstride,
                 int pos_stride, float scale, const float* __restrict__ tail,
                 float n_tail, int d) {
  const int bg = blockIdx.x, s = bg / (hq / G);
  const int pos = pos_ptr ? min(pos_ptr[(size_t)s * pos_stride], ctx - 1) : ctx - 1;
  attn_page<T, D, G, true, PF, DCAP, WHOLE>(
      q, kc, vc, pos, out, part_ml, part_acc, bg, blockIdx.y, gridDim.y, hq,
      n_rep, ctx, q_bstride, kv_bstride, scale, tail, n_tail, d);
  if (last_page(pos) > 0 && (int)blockIdx.y <= last_page(pos)) {
    attn_finish<D, G>(part_ml, part_acc, arrivals, pos, out, bg, gridDim.y,
                      hq, tail, n_tail, d);
  }
}

// The passes whose K / V loads a warp keeps in flight: 8 where the grid
// has at most about two blocks per SM (one sequence: its few blocks each
// stream more bytes), 4 where it has more (a batch: more of its blocks fit
// on an SM's registers at once). The outputs do not depend on it.
int passes_in_flight(long long blocks) {
  static std::atomic<int> sms{0};
  int n = sms.load();
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      n = 1;
    }
    sms.store(n);
  }
  return blocks <= 2LL * n ? 8 : 4;
}

// The q heads one block serves: the largest of 4, 3, 2, 1 that divides
// n_rep, and at most 2 for heads past 512 (the merge's shared memory,
// attention.cuh).
int group_of(int n_rep, int d) {
  if (d <= 512 && n_rep % 4 == 0) return 4;
  if (d <= 512 && n_rep % 3 == 0) return 3;
  return n_rep % 2 == 0 ? 2 : 1;
}

// The generic path (D 0) keeps 4 passes in flight at width 256 (a lane of
// an f32 row of more than 128 elements holds two chunks, so 8 passes'
// loads would take 128 registers), 2 at 512 and 1 at 1024: a lane's loads
// in flight stay within 64 registers (attention.cuh, the limit).
template <typename T, int D, int G, int DCAP, bool WHOLE>
void launch(const float* q, const void* kc, const void* vc, const int* pos,
            float* out, float* part_ml, float* part_acc,
            unsigned int* arrivals, int b, int hq, int n_rep, int ctx,
            long long q_bstride, long long kv_bstride, int pos_stride,
            float scale, const float* tail, float n_tail, int d,
            cudaStream_t s) {
  const int n_pages = (ctx + PAGE - 1) / PAGE;
  const dim3 grid(b * hq / G, n_pages);
  constexpr int PF_GENERIC = DCAP <= 256 ? 4 : DCAP <= 512 ? 2 : 1;
  constexpr int PF = D > 0 ? 4 : PF_GENERIC;
  auto kern = attn_page_kernel<T, D, G, PF, DCAP, WHOLE>;
  if constexpr (D > 0) {
    if (passes_in_flight((long long)grid.x * grid.y) == 8) {
      kern = attn_page_kernel<T, D, G, 8, DCAP, WHOLE>;
    }
  }
  kern<<<grid, NWARPS * G * 32, 0, s>>>(
      q, reinterpret_cast<const T*>(kc), reinterpret_cast<const T*>(vc), pos,
      out, part_ml, part_acc, arrivals, hq, n_rep, ctx, q_bstride, kv_bstride,
      pos_stride, scale, tail, n_tail, d);
}

// G 3 and 4 are compiled for widths up to 512 only (group_of).
template <typename T, int D, int DCAP = D, bool WHOLE = true>
void launch_group(int g, const float* q, const void* kc, const void* vc,
                  const int* pos, float* out, float* part_ml, float* part_acc,
                  unsigned int* arrivals, int b, int hq, int n_rep, int ctx,
                  long long q_bstride, long long kv_bstride, int pos_stride,
                  float scale, const float* tail, float n_tail, int d,
                  cudaStream_t s) {
#define TTS_ATTN_ARGS q, kc, vc, pos, out, part_ml, part_acc, arrivals, b, hq, \
                      n_rep, ctx, q_bstride, kv_bstride, pos_stride, scale,   \
                      tail, n_tail, d, s
  if constexpr (DCAP <= 512) {
    if (g == 4) {
      launch<T, D, 4, DCAP, WHOLE>(TTS_ATTN_ARGS);
      return;
    } else if (g == 3) {
      launch<T, D, 3, DCAP, WHOLE>(TTS_ATTN_ARGS);
      return;
    }
  }
  if (g == 2) {
    launch<T, D, 2, DCAP, WHOLE>(TTS_ATTN_ARGS);
  } else {
    launch<T, D, 1, DCAP, WHOLE>(TTS_ATTN_ARGS);
  }
#undef TTS_ATTN_ARGS
}

// Every other head size, on the generic path of its width, its rows read
// 16 bytes at a time where they are whole 16-byte chunks.
template <typename T, bool WHOLE>
void generic(int g, const float* q, const void* kc, const void* vc,
             const int* pos, float* out, float* part_ml, float* part_acc,
             unsigned int* arrivals, int b, int hq, int n_rep, int ctx,
             long long q_bstride, long long kv_bstride, int pos_stride,
             float scale, const float* tail, float n_tail, int d,
             cudaStream_t s) {
#define TTS_ATTN_ARGS g, q, kc, vc, pos, out, part_ml, part_acc, arrivals, b, \
                      hq, n_rep, ctx, q_bstride, kv_bstride, pos_stride,       \
                      scale, tail, n_tail, d, s
  switch (generic_cap(d)) {
    case 256: launch_group<T, 0, 256, WHOLE>(TTS_ATTN_ARGS); break;
    case 512: launch_group<T, 0, 512, WHOLE>(TTS_ATTN_ARGS); break;
    default: launch_group<T, 0, 1024, WHOLE>(TTS_ATTN_ARGS); break;
  }
#undef TTS_ATTN_ARGS
}

int dispatch(const float* q, const void* kc, const void* vc, const int* pos,
             float* out, float* part_ml, float* part_acc,
             unsigned int* arrivals, int b, int hq, int n_rep, int ctx, int d,
             int cache_bf16, long long q_bstride, long long kv_bstride,
             int pos_stride, float scale, const float* tail, float n_tail,
             cudaStream_t s) {
  if (b <= 0 || hq <= 0 || n_rep <= 0 || hq % n_rep || ctx <= 0 ||
      (ctx + PAGE - 1) / PAGE > 65535 || arrivals == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (!head_size_ok(d)) return (int)cudaErrorInvalidValue;
  const int g = group_of(n_rep, d);
#define TTS_ATTN_ARGS g, q, kc, vc, pos, out, part_ml, part_acc, arrivals, b, \
                      hq, n_rep, ctx, q_bstride, kv_bstride, pos_stride,       \
                      scale, tail, n_tail, d, s
  // the models' head sizes compiled for, every other one on the generic path
  if (cache_bf16 && d == 64) {
    launch_group<__nv_bfloat16, 64>(TTS_ATTN_ARGS);
  } else if (cache_bf16 && d == 128) {
    launch_group<__nv_bfloat16, 128>(TTS_ATTN_ARGS);
  } else if (!cache_bf16 && d == 64) {
    launch_group<float, 64>(TTS_ATTN_ARGS);
  } else if (!cache_bf16 && d == 128) {
    launch_group<float, 128>(TTS_ATTN_ARGS);
  } else if (cache_bf16 && d % 8 == 0) {
    generic<__nv_bfloat16, true>(TTS_ATTN_ARGS);
  } else if (cache_bf16) {
    generic<__nv_bfloat16, false>(TTS_ATTN_ARGS);
  } else if (d % 4 == 0) {
    generic<float, true>(TTS_ATTN_ARGS);
  } else {
    generic<float, false>(TTS_ATTN_ARGS);
  }
#undef TTS_ATTN_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// The entries' version: 2 since the arrival counters' pointer joined them.
extern "C" int tts_attention_abi(void) { return 2; }

// q (b, hq, d) f32, slot s at q + s * q_bstride (the heads of a slot
// contiguous); kc/vc (b, hq / n_rep, ctx, d), bf16 (cache_bf16) or f32,
// slot s at + s * kv_bstride elements (0: one cache shared by every slot);
// pos device int32, slot s at pos[s * pos_stride] (0: one shared position);
// out (b, hq, d) f32; part_ml (b * hq, ceil(ctx/256), 2) and part_acc
// (b * hq, ceil(ctx/256), d) f32 scratch; arrivals at least b * hq zeroed
// uint32 counters, left zeroed (launches that share them must be ordered,
// as on one stream). d from 1 to 1024 (head_size_ok). K3 is
// the call with b = 1.
extern "C" int tts_decode_attention(
    const float* q, const void* kc, const void* vc, const int* pos,
    float* out, float* part_ml, float* part_acc, unsigned int* arrivals,
    int b, int hq, int n_rep, int ctx, int d, int cache_bf16,
    long long q_bstride, long long kv_bstride, int pos_stride, float scale,
    void* stream) {
  return dispatch(q, kc, vc, pos, out, part_ml, part_acc, arrivals, b, hq,
                  n_rep, ctx, d, cache_bf16, q_bstride, kv_bstride, pos_stride,
                  scale, nullptr, 0.f, reinterpret_cast<cudaStream_t>(stream));
}

// The Dia cross-attention: q (b, hq, d) f32 as above; kc/vc (b, hq, sb, d)
// bf16 or f32, slot s at + s * kv_bstride elements, every one of the sb rows
// attended (MHA); tail (b * hq, d) f32, the V sum of the n_tail pad rows of
// logit 0 past the bucket, or null when n_tail is 0; out, scratch and
// arrivals as above with ctx = sb.
extern "C" int tts_cross_attention(
    const float* q, const void* kc, const void* vc, const float* tail,
    float n_tail, float* out, float* part_ml, float* part_acc,
    unsigned int* arrivals, int b, int hq, int sb, int d, int cache_bf16,
    long long q_bstride, long long kv_bstride, float scale, void* stream) {
  if ((tail == nullptr) != (n_tail == 0.f) || n_tail < 0.f) {
    return (int)cudaErrorInvalidValue;
  }
  return dispatch(q, kc, vc, nullptr, out, part_ml, part_acc, arrivals, b, hq,
                  1, sb, d, cache_bf16, q_bstride, kv_bstride, 0, scale, tail,
                  n_tail, reinterpret_cast<cudaStream_t>(stream));
}
