// K8 and K6: the Orpheus (llama-family) decode step over all L layers of
// one sequence as ONE persistent, cooperative launch; K6 adds the final RMS
// norm and the padded Q4_0 LM head as a last phase.
//
// Replaces the TPU kernels tts_tpu/ops/llama_megastep.py:_llama_kernel
// (wrapper llama_megastep) and tts_tpu/ops/llama_flat.py:_flat_kernel
// (wrapper llama_flat_megastep): per layer RMS -> qkv -> NeoX RoPE with the
// llama3 frequency factors -> GQA attention over the cache -> o -> RMS ->
// SiLU(gate) * up -> down, weights block-quantized with the `_dqdot`
// numerics; K6 then RMS(out_norm) -> the head, whose padded rows give
// logits of exactly 0. The TPU kernels are one pallas_call each, whose
// weight DMA of the next tile overlaps the current one's compute. The
// contract here is the port's (ops/llama_megastep.py, ops/llama_flat.py):
// the step writes this token's k / v into cache row pos in place and
// attends rows [0, pos]. K9 and K7, the batched forms, stay the launch
// sequence (llama_megastep.cu + K4), which this step equals bit for bit.
//
// What bounds it on the H100: every weight read once (1.585 GB of Q4_0 at
// Orpheus-3B width, K6's head 0.272 GB more) plus the K/V rows up to pos
// (114,688 bytes a position at bf16): about 0.52 ms (K8) and 0.59 ms (K6)
// at 3.35 TB/s at pos 1000 (bytes). The launch sequence before it issued
// 140 launches a step (141 for K6), each GEMV launch paying a ramp of
// several us beyond its bytes, and the host issuing them was the Orpheus
// CLI's bound.
//
// Design, on the model of K10 (dia_flat.cu): a grid of (SMs x the blocks
// per SM that fit) blocks of 8 warps, launched cooperatively, so that a
// grid that cannot be resident at once is refused. Each layer runs five
// phases, each ended by a grid barrier (grid_sync.cuh; none after the last
// layer's last phase, one more before K6's head: 5 L - 1 barriers, 5 L for
// K6):
//   1. RMS(attn_norm) -> qkv, RoPE, k / v into cache row pos
//   2. GQA self-attention over rows [0, pos]
//   3. o, x += .
//   4. RMS(ffn_norm) -> gate / up, SiLU(gate) * up
//   5. down, x += .
//   and for K6: RMS(out_norm) -> the head -> logits.
// The GEMV phases are flat_gemv.cuh's (gemv.cuh's per-item device code,
// a tile's k_split(K) K ranges on as many warps of one block, added in
// range order: the order of the launch sequence's cluster rank 0; the rows
// staged by the same operations), so x_out, k_new, v_new, both caches and
// the logits equal the launch sequence's bit for bit, and so every K9 / K7
// slot equals this step. The attention phase runs attention.cuh's pages
// and their merge by the last block to finish a group's pages (the arrival
// counters, as K3 does; no extra barrier), one q head a page block, or two
// where one a block would take more than one round of the grid (K3 serves
// the 3 q heads of a kv head in one block of 12 warps; a block here has 8,
// and the outputs do not depend on the grouping).
//
// Scale layouts: K8 keeps its qkv scales in f32 and the others in bf16 (as
// the TPU prep does), K6 every scale in bf16; the kernel is templated on
// the qkv phase's (QSB) and on the qtype (Q4_0 packed, Q5_0, Q8_0): six
// kernels. Their attention phase picks the cache dtype, the head size (64
// or 128) and the grouping at run time, so that the source builds
// quickly; the GEMV code appears twice in each kernel (the qkv phase and
// one call site that takes o, gate / up, down and the head in turn).
//
// Hiding the ramp: a warp issues the ring stages of its items in the next
// GEMV phase as soon as it is done with the current one, before the
// barrier; across the attention phase they wait in the ring. The ring is
// 8 stages, kept full across a warp's items (the head's 19,648 items at
// Orpheus-3B width, 18-19 a warp). The attention operands the step does
// not write (the layer's K / V rows below pos) are prefetched into L2
// during the qkv phase before them (cp.async.bulk.prefetch.L2).
//
// Memory: data written inside the launch (x, qkv, the attention output and
// partials, cache row pos, the SiLU output) is read through coherent
// loads; the weights stream through cp.async (L2).
#include <cuda_runtime.h>

#include "attention.cuh"
#include "flat_gemv.cuh"
#include "grid_sync.cuh"

namespace {

using tts::attn::PAGE;

constexpr int ROWS = 1;            // one sequence
constexpr int FLAT_STAGES = 8;     // a warp's ring stages
constexpr int ATTN_PF = 4;         // passes whose K / V loads a page's warp keeps in flight
constexpr int MAX_STEP_D = 128;    // head sizes 64 and 128

struct LlamaArgs {
  float* x;                  // (1, H), updated in place
  const float* norms;        // (L, 2, H): attn_norm, ffn_norm
  const uint8_t* qkv_c;      // tiled codes, stacked on L (gemv_tile)
  const uint8_t* qkv_s;      // their scales: f32 or bf16 (QSB)
  const uint8_t* o_c;
  const uint8_t* o_s;        // bf16, as every scale but K8's qkv
  const uint8_t* gu_c;       // gate / up pairs
  const uint8_t* gu_s;
  const uint8_t* down_c;
  const uint8_t* down_s;
  long long qkv_lc, qkv_ls, o_lc, o_ls, gu_lc, gu_ls, down_lc, down_ls;  // bytes a layer
  const uint8_t* head_c;     // K6's padded head (vocab rows), null for K8
  const uint8_t* head_s;
  const float* out_norm;     // (H)
  float* logits;             // (1, vocab)
  int vocab;
  void* kv_k;                // layer l at + l * kv_ls elements, (n_kv, ctx, d) dense
  void* kv_v;
  long long kv_ls;
  const int* pos;            // (1,)
  const float* inv;          // (d / 2) RoPE inverse frequencies
  float scale;               // the softmax scale, d^-1/2 as the host computes it
  float* qkv;                // (L, 1, H + 2 KV): q, k_new, v_new of every layer
  float* attn;               // (heads, d)
  float* act;                // (F)
  float* part_ml;            // (heads, n_pages, 2)
  float* part_acc;           // (heads, n_pages, d)
  unsigned int* arrivals;    // heads counters, zero on entry and exit
  unsigned int* bar;         // grid_sync's 2 words
  int n_layers, hidden, ffn, heads, n_kv, d, ctx, n_pages, cache_bf16;
};

enum Which { W_QKV = 0, W_O = 1, W_GATE_UP = 2, W_DOWN = 3, W_HEAD = 4 };

// Phase `which` of layer l (the head for W_HEAD); pos and inv are
// shared-memory copies of a.pos[0] and a.inv.
__device__ __forceinline__ Gemv gemv_of(const LlamaArgs& a, int l, int which,
                                        const int* pos, const float* inv) {
  const int H = a.hidden, kvh = a.n_kv * a.d, kvn = H + 2 * kvh;
  const RopeArgs rope{inv, pos, 0, nullptr, nullptr, H, kvh, a.d, a.ctx,
                      a.cache_bf16, 0};
  Gemv g{};
  g.ra = rope;
  g.K = H;
  if (which == W_QKV) {
    g.codes = a.qkv_c + l * a.qkv_lc;
    g.scales = a.qkv_s + l * a.qkv_ls;
    g.x = a.x;
    g.norm_w = a.norms + (size_t)(2 * l) * H;
    g.N = kvn;
    g.P = kvn / 2;
    g.epi = EPI_ROPE_QKV;
    g.out = a.qkv + (size_t)l * ROWS * kvn;
    const size_t el = (a.cache_bf16 ? 2 : 4) * (size_t)(l * a.kv_ls);
    g.ra.kc = reinterpret_cast<uint8_t*>(a.kv_k) + el;
    g.ra.vc = reinterpret_cast<uint8_t*>(a.kv_v) + el;
  } else if (which == W_O) {
    g.codes = a.o_c + l * a.o_lc;
    g.scales = a.o_s + l * a.o_ls;
    g.x = a.attn;
    g.N = H;
    g.P = H / 2;
    g.epi = EPI_RESIDUAL;
    g.res = a.x;
    g.out = a.x;
  } else if (which == W_GATE_UP) {
    g.codes = a.gu_c + l * a.gu_lc;
    g.scales = a.gu_s + l * a.gu_ls;
    g.x = a.x;
    g.norm_w = a.norms + (size_t)(2 * l + 1) * H;
    g.N = a.ffn;
    g.P = a.ffn;
    g.epi = EPI_SILU_MUL;
    g.out = a.act;
  } else if (which == W_DOWN) {
    g.codes = a.down_c + l * a.down_lc;
    g.scales = a.down_s + l * a.down_ls;
    g.x = a.act;
    g.K = a.ffn;
    g.N = H;
    g.P = H / 2;
    g.epi = EPI_RESIDUAL;
    g.res = a.x;
    g.out = a.x;
  } else {   // W_HEAD
    g.codes = a.head_c;
    g.scales = a.head_s;
    g.x = a.x;
    g.norm_w = a.out_norm;
    g.N = a.vocab;
    g.P = a.vocab / 2;
    g.epi = EPI_STORE;
    g.out = a.logits;
  }
  return g;
}

// The self-attention of layer l: the (group of G q heads) x 256-row page
// items over the blocks, each block merging a group's pages when it
// finishes its last (attn_finish).
template <typename T, int D, int G>
__device__ __forceinline__ void self_attention(const LlamaArgs& a, int l, int pos) {
  const int kvn = a.hidden + 2 * a.n_kv * D, n_rep = a.heads / a.n_kv;
  const int live = pos / PAGE + 1;
  const T* kc = reinterpret_cast<const T*>(a.kv_k) + l * a.kv_ls;
  const T* vc = reinterpret_cast<const T*>(a.kv_v) + l * a.kv_ls;
  const float* q = a.qkv + (size_t)l * ROWS * kvn;
  const int items = a.heads / G * live;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int bg = it / live, page = it % live;
    tts::attn::attn_page<T, D, G, false, ATTN_PF>(
        q, kc, vc, pos, a.attn, a.part_ml, a.part_acc, bg, page, a.n_pages,
        a.heads, n_rep, a.ctx, kvn, 0, a.scale, nullptr, 0.f);
    if (live > 1) {
      tts::attn::attn_finish<D, G>(a.part_ml, a.part_acc, a.arrivals, pos,
                                   a.attn, bg, a.n_pages, a.heads, nullptr, 0.f);
    }
    __syncthreads();   // the next item reuses the page's shared memory
  }
}

// One q head a page block (4 of its 8 warps) while the (head, page) items
// fit the grid in one round; past that, two heads a block (every warp), so
// that the items take half the rounds (Orpheus-3B past pos 1279: 24 heads
// x 6 pages > 132 blocks). The outputs do not depend on it.
template <typename T, int D>
__device__ __forceinline__ void attention_of(const LlamaArgs& a, int l, int pos) {
  if (a.heads % 2 == 0 && a.heads * (pos / PAGE + 1) > (int)gridDim.x) {
    self_attention<T, D, 2>(a, l, pos);
  } else {
    self_attention<T, D, 1>(a, l, pos);
  }
}

__device__ __forceinline__ void attention(const LlamaArgs& a, int l, int pos) {
  if (a.cache_bf16) {
    if (a.d == 128) {
      attention_of<__nv_bfloat16, 128>(a, l, pos);
    } else {
      attention_of<__nv_bfloat16, 64>(a, l, pos);
    }
  } else if (a.d == 128) {
    attention_of<float, 128>(a, l, pos);
  } else {
    attention_of<float, 64>(a, l, pos);
  }
}

template <int QT, bool PACKED, bool QSB>
__global__ void __launch_bounds__(THREADS, 1) llama_flat_kernel(LlamaArgs a) {
  using SQ = Stage<PACKED, QSB>;
  using SB = Stage<PACKED, true>;
  constexpr int RING = SQ::BYTES > SB::BYTES ? SQ::BYTES : SB::BYTES;
  extern __shared__ __align__(16) uint8_t smem[];   // flat_smem_bytes
  __shared__ double rms_part[MAX_KS][MAX_ROWS];
  __shared__ float rstd[MAX_ROWS];
  __shared__ int pos_s;
  __shared__ float inv_s[MAX_STEP_D / 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Smem sm;
  sm.ring = smem + warp * FLAT_STAGES * RING;
  sm.slots = reinterpret_cast<float4*>(smem + WARPS * FLAT_STAGES * RING);
  sm.raw = sm.slots + 2 * WARPS * 32;
  sm.xs = reinterpret_cast<uint8_t*>(sm.raw) + (ROWS + 1) * a.hidden * sizeof(float);
  WeightStream<PACKED, QSB> wq;     // the qkv phase's stream
  WeightStream<PACKED, true> wb;    // every other GEMV phase's
  Gemv gq = gemv_of(a, 0, W_QKV, &pos_s, inv_s);
  gemv_begin<PACKED, QSB, FLAT_STAGES>(wq, gq, sm.ring, warp, lane);
  if (threadIdx.x == 0) pos_s = a.pos[0];
  if (threadIdx.x < a.d / 2) inv_s[threadIdx.x] = a.inv[threadIdx.x];
  __syncthreads();
  const int pos = min(pos_s, a.ctx - 1);   // the cache row written and attended up to
  const int esize = a.cache_bf16 ? 2 : 4;
  const long long row_bytes = (long long)a.d * esize;
#pragma unroll 1
  for (int l = 0; l < a.n_layers; ++l) {
    // 1. RMS -> qkv, RoPE; k, v into cache row pos (this layer's K / V rows
    //    below pos into L2 meanwhile: each kv head's K and V)
    const uint8_t* kc = reinterpret_cast<const uint8_t*>(a.kv_k) + l * a.kv_ls * esize;
    const uint8_t* vc = reinterpret_cast<const uint8_t*>(a.kv_v) + l * a.kv_ls * esize;
    prefetch_l2(kc, a.ctx * row_bytes, a.n_kv, pos * row_bytes);
    prefetch_l2(vc, a.ctx * row_bytes, a.n_kv, pos * row_bytes);
    gemv_run<QT, PACKED, QSB, ROWS, FLAT_STAGES>(wq, gq, sm, rms_part, rstd);
    Gemv gb = gemv_of(a, l, W_O, &pos_s, inv_s);
    gemv_begin<PACKED, true, FLAT_STAGES>(wb, gb, sm.ring, warp, lane);
    grid_sync(a.bar);
    // 2. self-attention over rows [0, pos]
    attention(a, l, pos);
    grid_sync(a.bar);
    // 3. o, x += .; 4. RMS -> gate / up, SiLU(gate) * up; 5. down, x += .;
    //    after the last layer K6's RMS(out_norm) -> head
    const int last = l + 1 == a.n_layers && a.head_c != nullptr ? W_HEAD : W_DOWN;
#pragma unroll 1
    for (int w = W_O; w <= last; ++w) {
      gemv_run<QT, PACKED, true, ROWS, FLAT_STAGES>(wb, gb, sm, rms_part, rstd);
      if (w < last) {
        gb = gemv_of(a, l, w + 1, &pos_s, inv_s);
        gemv_begin<PACKED, true, FLAT_STAGES>(wb, gb, sm.ring, warp, lane);
        grid_sync(a.bar);
      }
    }
    if (l + 1 < a.n_layers) {
      gq = gemv_of(a, l + 1, W_QKV, &pos_s, inv_s);
      gemv_begin<PACKED, QSB, FLAT_STAGES>(wq, gq, sm.ring, warp, lane);
      grid_sync(a.bar);
    }
  }
  grid_exit(a.bar);
}

// A stage's bytes of f32 (qsb 0) or bf16 scales.
inline long long scale_bytes(int qsb) { return 16LL * UNIT_BLOCKS * (qsb ? 2 : 4); }

// Dynamic shared memory of a block (Smem; ops/llama_persistent.py
// smem_bytes reckons the same): 8 warps' rings of FLAT_STAGES of the
// larger stage, the two buffers of range sums, the f32 row and norm
// weights of an RMS prologue, the row staged as bf16 at the larger K.
template <bool PACKED, bool QSB>
int flat_smem_bytes(int hidden, int ffn) {
  constexpr int q = Stage<PACKED, QSB>::BYTES, b = Stage<PACKED, true>::BYTES;
  return WARPS * FLAT_STAGES * (q > b ? q : b) + 2 * WARPS * 32 * 16 +
         (ROWS + 1) * hidden * (int)sizeof(float) +
         ROWS * xs_stride(hidden > ffn ? hidden : ffn);
}

template <int QT, bool PACKED, bool QSB>
int launch(LlamaArgs a, int smem, cudaStream_t s, int* grid, int* per_sm) {
  if (smem != flat_smem_bytes<PACKED, QSB>(a.hidden, a.ffn)) return (int)cudaErrorInvalidValue;
  return launch_cooperative(reinterpret_cast<const void*>(llama_flat_kernel<QT, PACKED, QSB>),
                            a, smem, s, grid, per_sm);
}

template <bool QSB>
int dispatch_qtype(const LlamaArgs& a, int qtype, int packed, int smem,
                   cudaStream_t s, int* grid, int* per_sm) {
  if (qtype == Q4_0 && packed) return launch<Q4_0, true, QSB>(a, smem, s, grid, per_sm);
  if (qtype == Q5_0 && !packed) return launch<Q5_0, false, QSB>(a, smem, s, grid, per_sm);
  if (qtype == Q8_0 && !packed) return launch<Q8_0, false, QSB>(a, smem, s, grid, per_sm);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Floats of scratch one step needs (ops/llama_persistent.py scratch_floats
// reckons the same): the attention output (H), the SiLU output (F) and the
// page partials (heads, n_pages, 2 + d).
extern "C" long long tts_llama_flat_scratch(int hidden, int ffn, int heads,
                                            int d, int ctx) {
  const long long pages = (ctx + PAGE - 1) / PAGE;
  return (long long)hidden + ffn + (long long)heads * pages * (2 + d);
}

// One Orpheus decode step of L layers for one sequence: x (1, H) f32,
// updated in place to the pre-final-norm output. Weights as
// LlamaMegaLayers (ops/llama_megastep.py: tiled, Q4_0 packed, Q5_0 or Q8_0
// codes, contiguous, stacked on L), the qkv scales f32 (qkv_sbf16 0: K8's
// prep) or bf16, every other scale bf16. kv_k / kv_v bf16 (cache_bf16) or
// f32, layer l at + l * kv_ls elements, (n_kv, ctx, d) dense; row min(pos,
// ctx - 1) written in place. pos a device int32; inv the (d / 2) RoPE
// inverse frequencies; scale the softmax scale. qkv (L, 1, H + 2 n_kv d)
// receives q, k_new, v_new of every layer. With head_c (K6): the head's
// tiles (vocab rows, bf16 scales), out_norm (H) and logits (1, vocab);
// null head_c, out_norm and logits for K8. scratch holds
// tts_llama_flat_scratch floats, 16-byte aligned; words heads + 2 zeroed
// uint32 (the arrival counters and the barrier), left zeroed, shared only
// by launches in stream order. smem: the block's dynamic shared memory as
// the caller reckons it (must equal the kernel's). *grid and *per_sm
// receive the blocks launched and the blocks an SM holds. d must be 64 or
// 128. Returns a CUDA error code (0: ok).
extern "C" int tts_llama_flat(
    float* x, const float* norms, const uint8_t* qkv_c, const void* qkv_s,
    int qkv_sbf16, const uint8_t* o_c, const void* o_s, const uint8_t* gu_c,
    const void* gu_s, const uint8_t* down_c, const void* down_s,
    const uint8_t* head_c, const void* head_s, const float* out_norm,
    float* logits, int vocab, void* kv_k, void* kv_v, long long kv_ls,
    const int* pos, const float* inv, float scale, float* qkv, float* scratch,
    long long scratch_floats, unsigned int* words, int n_words, int qtype,
    int packed, int n_layers, int hidden, int ffn, int heads, int n_kv, int d,
    int ctx, int cache_bf16, int smem, int* grid, int* per_sm, void* stream) {
  const bool head = head_c != nullptr;
  if (n_layers <= 0 || heads <= 0 || n_kv <= 0 || heads % n_kv ||
      hidden != heads * d || (d != 64 && d != 128) || ctx <= 0 ||
      hidden % (UNIT_K * k_split(hidden)) || ffn % (UNIT_K * k_split(ffn)) ||
      ffn % TILE_PAIRS || hidden % (2 * TILE_PAIRS) ||
      head != (head_s != nullptr) || head != (out_norm != nullptr) ||
      head != (logits != nullptr) || (head && (vocab <= 0 || vocab % 2)) ||
      n_words < heads + 2 ||
      scratch_floats < tts_llama_flat_scratch(hidden, ffn, heads, d, ctx)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long cb = packed ? Stage<true, true>::CODES : Stage<false, true>::CODES;
  const long long st_h = hidden / UNIT_K, st_f = ffn / UNIT_K;
  const long long kvn = hidden + 2LL * n_kv * d;
  const long long t_qkv = (kvn / 2 + TILE_PAIRS - 1) / TILE_PAIRS;
  const long long t_h = hidden / (2 * TILE_PAIRS);
  const long long t_gu = ffn / TILE_PAIRS;
  const long long pages = (ctx + PAGE - 1) / PAGE;
  LlamaArgs a;
  a.x = x;
  a.norms = norms;
  a.qkv_c = qkv_c;
  a.qkv_s = reinterpret_cast<const uint8_t*>(qkv_s);
  a.o_c = o_c;
  a.o_s = reinterpret_cast<const uint8_t*>(o_s);
  a.gu_c = gu_c;
  a.gu_s = reinterpret_cast<const uint8_t*>(gu_s);
  a.down_c = down_c;
  a.down_s = reinterpret_cast<const uint8_t*>(down_s);
  a.qkv_lc = t_qkv * st_h * cb;
  a.qkv_ls = t_qkv * st_h * scale_bytes(qkv_sbf16);
  a.o_lc = t_h * st_h * cb;
  a.o_ls = t_h * st_h * scale_bytes(1);
  a.gu_lc = t_gu * st_h * cb;
  a.gu_ls = t_gu * st_h * scale_bytes(1);
  a.down_lc = t_h * st_f * cb;
  a.down_ls = t_h * st_f * scale_bytes(1);
  a.head_c = head_c;
  a.head_s = reinterpret_cast<const uint8_t*>(head_s);
  a.out_norm = out_norm;
  a.logits = logits;
  a.vocab = vocab;
  a.kv_k = kv_k;
  a.kv_v = kv_v;
  a.kv_ls = kv_ls;
  a.pos = pos;
  a.inv = inv;
  a.scale = scale;
  a.qkv = qkv;
  float* p = scratch;
  a.attn = p;
  p += hidden;
  a.act = p;
  p += ffn;
  a.part_ml = p;
  p += heads * pages * 2;
  a.part_acc = p;
  a.arrivals = words;
  a.bar = words + heads;
  a.n_layers = n_layers;
  a.hidden = hidden;
  a.ffn = ffn;
  a.heads = heads;
  a.n_kv = n_kv;
  a.d = d;
  a.ctx = ctx;
  a.n_pages = (int)pages;
  a.cache_bf16 = cache_bf16;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return qkv_sbf16 ? dispatch_qtype<true>(a, qtype, packed, smem, s, grid, per_sm)
                   : dispatch_qtype<false>(a, qtype, packed, smem, s, grid, per_sm);
}
