// K9 and K7's layer stack: the batched Orpheus (llama-family) decode step
// over all L layers of up to 8 slots, each at its own position with its own
// cache, as ONE persistent, cooperative launch.
//
// Replaces the TPU kernel tts_tpu/ops/llama_megastep.py:_llama_batched_kernel
// (wrapper llama_megastep_batched), and runs the layers of
// tts_tpu/ops/llama_flat.py:_flat_kernel's batched form (K7, whose LM head
// stays one GEMV launch after it, ops/llama_flat.py): per layer RMS -> qkv
// -> NeoX RoPE at each slot's own position with the llama3 frequency
// factors -> GQA attention over each slot's cache -> o -> RMS -> SiLU(gate)
// * up -> down, weights block-quantized with the `_dqdot` numerics. The
// contract is the port's (ops/llama_megastep.py): each slot writes its
// token's k / v into its cache row pos[s] in place and attends rows
// [0, pos[s]].
//
// What bounds it on the H100: every weight read once for all the slots
// (1.585 GB of Q4_0 at Orpheus-3B width) plus each slot's K/V rows up to
// its position: about 0.73 ms at 3.35 TB/s for 8 slots at chip_smoke's
// mixed positions (bytes). The launch sequence before it
// (llama_megastep.cu + K4, still the route for other head sizes) issued 4
// GEMV launches and 1 attention launch a layer, 140 a step at 28 layers,
// each with a ramp of several us beyond its bytes.
//
// Design, on the model of K8 (llama_flat.cu): a grid of (SMs x the blocks
// per SM that fit) blocks of 8 warps, launched cooperatively, so that a grid
// that cannot be resident at once is refused. Each layer runs five phases
// over the B slot rows, each ended by a grid barrier (grid_sync.cuh; none
// after the last layer's last phase: 5 L - 1 barriers):
//   1. RMS(attn_norm) -> qkv, RoPE at pos[s], k / v into slot s's cache row
//   2. GQA self-attention: (slot, group of q heads, live 256-row page) items
//      over the blocks, each slot up to its own position, a (slot, group)'s
//      pages merged by the block that finishes its last page (attention.cuh
//      attn_finish_acq_rel, arrival counters as K4 merges; no extra barrier)
//   3. o, x += .
//   4. RMS(ffn_norm) -> gate / up, SiLU(gate) * up
//   5. down, x += .
// The GEMV phases are flat_gemv.cuh's (gemv.cuh's per-item device code): a
// tile's k_split(K) K ranges on as many warps of one block, added in range
// order (the launch sequence's cluster rank 0's order), the B rows the one
// n-tile of 8 columns of the mma, each column summed apart from the others.
// So each slot's outputs and cache equal K8's on that slot's state bit for
// bit, and the step equals the launch sequence (layers_cuda) bit for bit.
//
// Shared memory is what sets B's limit. K8's layout (an f32 copy of the rows
// and norm weights for the RMS prologue, the rows staged as bf16 at the
// larger K, an 8-stage ring a warp) would need ~352 KB a block at 8 rows of
// Orpheus-3B width, where a block may have 227 KB. Here the RMS sums are
// taken from loads of x in device memory in the launch sequence's lane and
// range order, with no f32 copy (flat_gemv.cuh gemv_run_rows), and a warp's
// ring holds RING_BYTES (6 Q4_0 stages, against K8's 8): at Orpheus-3B width
// 8 rows staged at K 8192 (131 KB), the rings (61 KB), the range sums (8 KB)
// and the static attention state fit; 9 rows do not. ops/llama_persistent.py max_rows reckons R, the rows one launch
// takes, and the wrappers run larger batches in slot groups of at most R.
// Like K8, a warp issues the ring stages of its items in the next GEMV
// phase before the barrier (gemv_begin). Unlike K8, it prefetches no K / V
// rows into L2 during the qkv phase: 8 slots' rows (30 MB a layer at
// chip_smoke's positions) compete with the weights for device memory, and
// the step ran slower with the prefetch than without it (an A/B of the two
// on the H100).
//
// Memory: data written inside the launch (x, qkv, the attention output and
// partials, the cache rows, the SiLU output) is read through coherent
// loads; the weights stream through cp.async (L2).
#include <cuda_runtime.h>

#include "attention.cuh"
#include "flat_gemv.cuh"
#include "grid_sync.cuh"

namespace {

using tts::attn::PAGE;

constexpr int MAX_SLOTS = FLAT_NT * 8;   // the rows of one n-tile
constexpr int RING_BYTES = 7680;         // a warp's ring: 6 Q4_0 stages, 3 of Q5_0 / Q8_0
constexpr int ATTN_PF = 4;               // passes whose K / V loads a page's warp keeps in flight
constexpr int MAX_STEP_D = 128;          // head sizes 64 and 128

struct BatchedArgs {
  float* x;                  // (B, H), updated in place
  const float* norms;        // (L, 2, H): attn_norm, ffn_norm
  const uint8_t* qkv_c;      // tiled codes, stacked on L (gemv_tile)
  const uint8_t* qkv_s;      // their scales: f32 or bf16 (QSB)
  const uint8_t* o_c;
  const uint8_t* o_s;        // bf16
  const uint8_t* gu_c;       // gate / up pairs
  const uint8_t* gu_s;
  const uint8_t* down_c;
  const uint8_t* down_s;
  long long qkv_lc, qkv_ls, o_lc, o_ls, gu_lc, gu_ls, down_lc, down_ls;  // bytes a layer
  void* kv_k;                // layer l at + l * kv_ls elements, slot s at + s * kv_bs, (n_kv, ctx, d)
  void* kv_v;
  long long kv_ls, kv_bs;
  const int* pos;            // (B,)
  const float* inv;          // (d / 2) RoPE inverse frequencies
  float scale;               // the softmax scale
  float* qkv;                // (L, B, H + 2 KV): q, k_new, v_new of every layer
  float* attn;               // (B, heads, d)
  float* act;                // (B, F)
  float* part_ml;            // (B * heads, n_pages, 2)
  float* part_acc;           // (B * heads, n_pages, d)
  unsigned int* arrivals;    // B * heads counters, zero on entry and exit
  unsigned int* bar;         // grid_sync's 2 words
  int rows, n_layers, hidden, ffn, heads, n_kv, d, ctx, n_pages, cache_bf16;
};

enum Which { W_QKV = 0, W_O = 1, W_GATE_UP = 2, W_DOWN = 3 };

// The larger of the qkv phase's stage and the others' (K8's qkv scales are
// f32), and the ring stages of RING_BYTES a warp keeps of it.
template <bool PACKED, bool QSB>
__host__ __device__ constexpr int stage_bytes() {
  return Stage<PACKED, QSB>::BYTES > Stage<PACKED, true>::BYTES
             ? Stage<PACKED, QSB>::BYTES : Stage<PACKED, true>::BYTES;
}

template <bool PACKED, bool QSB>
__host__ __device__ constexpr int batched_stages() {
  return RING_BYTES / stage_bytes<PACKED, QSB>() > 2
             ? RING_BYTES / stage_bytes<PACKED, QSB>() : 2;
}

// Phase `which` of layer l over the B rows; pos and inv are shared-memory
// copies of a.pos and a.inv.
__device__ __forceinline__ Gemv gemv_of(const BatchedArgs& a, int l, int which,
                                        const int* pos, const float* inv) {
  const int H = a.hidden, kvh = a.n_kv * a.d, kvn = H + 2 * kvh;
  const RopeArgs rope{inv, pos, 1, nullptr, nullptr, H, kvh, a.d, a.ctx,
                      a.cache_bf16, a.kv_bs};
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
    g.out = a.qkv + (size_t)l * a.rows * kvn;
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
  } else {   // W_DOWN
    g.codes = a.down_c + l * a.down_lc;
    g.scales = a.down_s + l * a.down_ls;
    g.x = a.act;
    g.K = a.ffn;
    g.N = H;
    g.P = H / 2;
    g.epi = EPI_RESIDUAL;
    g.res = a.x;
    g.out = a.x;
  }
  return g;
}

// The self-attention of layer l: slot s's items are (group of G q heads) x
// its live pages, slot after slot (live[s] pages from item first[s] / (heads
// / G)); a block that finishes a (slot, group)'s last page merges them.
template <typename T, int D, int G>
__device__ __forceinline__ void self_attention(const BatchedArgs& a, int l,
                                               const int* pos,
                                               const int* first) {
  const int kvn = a.hidden + 2 * a.n_kv * D, n_rep = a.heads / a.n_kv;
  const int groups = a.heads / G;
  const T* kc = reinterpret_cast<const T*>(a.kv_k) + l * a.kv_ls;
  const T* vc = reinterpret_cast<const T*>(a.kv_v) + l * a.kv_ls;
  const float* q = a.qkv + (size_t)l * a.rows * kvn;
  const int items = groups * first[a.rows];
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    int s = 0;
    while (it >= groups * first[s + 1]) ++s;
    const int live = first[s + 1] - first[s], j = it - groups * first[s];
    const int bg = s * groups + j / live, page = j % live;
    tts::attn::attn_page<T, D, G, false, ATTN_PF>(
        q, kc, vc, pos[s], a.attn, a.part_ml, a.part_acc, bg, page, a.n_pages,
        a.heads, n_rep, a.ctx, kvn, a.kv_bs, a.scale, nullptr, 0.f);
    if (live > 1) {
      tts::attn::attn_finish_acq_rel<D, G>(a.part_ml, a.part_acc, a.arrivals,
                                           pos[s], a.attn, bg, a.n_pages, a.heads);
    }
    __syncthreads();   // the next item reuses the page's shared memory
  }
}

// One q head a page block while the items fit the grid in one round; past
// that, two heads a block (every warp), as K8 does. The outputs do not
// depend on it.
template <typename T, int D>
__device__ __forceinline__ void attention_of(const BatchedArgs& a, int l,
                                             const int* pos, const int* first) {
  if (a.heads % 2 == 0 && a.heads * first[a.rows] > (int)gridDim.x) {
    self_attention<T, D, 2>(a, l, pos, first);
  } else {
    self_attention<T, D, 1>(a, l, pos, first);
  }
}

__device__ __forceinline__ void attention(const BatchedArgs& a, int l,
                                          const int* pos, const int* first) {
  if (a.cache_bf16) {
    if (a.d == 128) {
      attention_of<__nv_bfloat16, 128>(a, l, pos, first);
    } else {
      attention_of<__nv_bfloat16, 64>(a, l, pos, first);
    }
  } else if (a.d == 128) {
    attention_of<float, 128>(a, l, pos, first);
  } else {
    attention_of<float, 64>(a, l, pos, first);
  }
}

template <int QT, bool PACKED, bool QSB>
__global__ void __launch_bounds__(THREADS, 1) llama_batched_kernel(BatchedArgs a) {
  constexpr int RING = stage_bytes<PACKED, QSB>();
  constexpr int STAGES = batched_stages<PACKED, QSB>();
  extern __shared__ __align__(16) uint8_t smem[];   // batched_smem_bytes
  __shared__ double rms_part[MAX_KS][MAX_ROWS];
  __shared__ float rstd[MAX_ROWS];
  __shared__ int pos_s[MAX_SLOTS];          // each slot's position (the RoPE angle)
  __shared__ int last_s[MAX_SLOTS];         // min(pos, ctx - 1): the row written, attended up to
  __shared__ int first_s[MAX_SLOTS + 1];    // live pages of the slots before each
  __shared__ float inv_s[MAX_STEP_D / 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Smem sm;
  sm.ring = smem + warp * STAGES * RING;
  sm.slots = reinterpret_cast<float4*>(smem + WARPS * STAGES * RING);
  sm.raw = nullptr;
  sm.xs = reinterpret_cast<uint8_t*>(sm.slots + 2 * WARPS * 32);
  WeightStream<PACKED, QSB> wq;     // the qkv phase's stream
  WeightStream<PACKED, true> wb;    // every other GEMV phase's
  Gemv gq = gemv_of(a, 0, W_QKV, pos_s, inv_s);
  gemv_begin<PACKED, QSB, STAGES>(wq, gq, sm.ring, warp, lane);
  if (threadIdx.x < a.rows) {
    pos_s[threadIdx.x] = a.pos[threadIdx.x];
    last_s[threadIdx.x] = min(pos_s[threadIdx.x], a.ctx - 1);
  }
  if (threadIdx.x < a.d / 2) inv_s[threadIdx.x] = a.inv[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    first_s[0] = 0;
    for (int s = 0; s < a.rows; ++s) first_s[s + 1] = first_s[s] + last_s[s] / PAGE + 1;
  }
  __syncthreads();
#pragma unroll 1
  for (int l = 0; l < a.n_layers; ++l) {
    // 1. RMS -> qkv, RoPE; k, v into each slot's cache row
    gemv_run_rows<QT, PACKED, QSB, STAGES>(wq, gq, sm, a.rows, rms_part, rstd);
    Gemv gb = gemv_of(a, l, W_O, pos_s, inv_s);
    gemv_begin<PACKED, true, STAGES>(wb, gb, sm.ring, warp, lane);
    grid_sync(a.bar);
    // 2. self-attention, each slot over rows [0, pos[s]]
    attention(a, l, last_s, first_s);
    grid_sync(a.bar);
    // 3. o, x += .; 4. RMS -> gate / up, SiLU(gate) * up; 5. down, x += .
#pragma unroll 1
    for (int w = W_O; w <= W_DOWN; ++w) {
      gemv_run_rows<QT, PACKED, true, STAGES>(wb, gb, sm, a.rows, rms_part, rstd);
      if (w < W_DOWN) {
        gb = gemv_of(a, l, w + 1, pos_s, inv_s);
        gemv_begin<PACKED, true, STAGES>(wb, gb, sm.ring, warp, lane);
        grid_sync(a.bar);
      }
    }
    if (l + 1 < a.n_layers) {
      gq = gemv_of(a, l + 1, W_QKV, pos_s, inv_s);
      gemv_begin<PACKED, QSB, STAGES>(wq, gq, sm.ring, warp, lane);
      grid_sync(a.bar);
    }
  }
  grid_exit(a.bar);
}

// A stage's bytes of f32 (qsb 0) or bf16 scales.
inline long long scale_bytes(int qsb) { return 16LL * UNIT_BLOCKS * (qsb ? 2 : 4); }

// Dynamic shared memory of a block for `rows` slots (ops/llama_persistent.py
// batched_smem_bytes reckons the same): 8 warps' rings of batched_stages of
// the larger stage, the two buffers of range sums, the rows staged as bf16
// at the larger K.
template <bool PACKED, bool QSB>
int batched_smem_bytes(int rows, int hidden, int ffn) {
  return WARPS * batched_stages<PACKED, QSB>() * stage_bytes<PACKED, QSB>() +
         2 * WARPS * 32 * 16 + rows * xs_stride(hidden > ffn ? hidden : ffn);
}

template <int QT, bool PACKED, bool QSB>
int launch(BatchedArgs a, int smem, cudaStream_t s, int* grid, int* per_sm) {
  if (smem != batched_smem_bytes<PACKED, QSB>(a.rows, a.hidden, a.ffn)) {
    return (int)cudaErrorInvalidValue;
  }
  return launch_cooperative(
      reinterpret_cast<const void*>(llama_batched_kernel<QT, PACKED, QSB>), a, smem, s,
      grid, per_sm);
}

template <bool QSB>
int dispatch_qtype(const BatchedArgs& a, int qtype, int packed, int smem,
                   cudaStream_t s, int* grid, int* per_sm) {
  if (qtype == Q4_0 && packed) return launch<Q4_0, true, QSB>(a, smem, s, grid, per_sm);
  if (qtype == Q5_0 && !packed) return launch<Q5_0, false, QSB>(a, smem, s, grid, per_sm);
  if (qtype == Q8_0 && !packed) return launch<Q8_0, false, QSB>(a, smem, s, grid, per_sm);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Floats of scratch one step of `rows` slots needs (ops/llama_persistent.py
// batched_scratch_floats reckons the same): the attention output (B, H),
// the SiLU output (B, F) and the page partials (B * heads, n_pages, 2 + d).
extern "C" long long tts_llama_flat_batched_scratch(int rows, int hidden,
                                                    int ffn, int heads, int d,
                                                    int ctx) {
  const long long pages = (ctx + PAGE - 1) / PAGE;
  return (long long)rows * (hidden + ffn + (long long)heads * pages * (2 + d));
}

// One Orpheus decode step of L layers for `rows` (1-8) slots: x (B, H) f32,
// updated in place to the pre-final-norm output. Weights as LlamaMegaLayers
// (ops/llama_megastep.py: tiled, Q4_0 packed, Q5_0 or Q8_0 codes,
// contiguous, stacked on L), the qkv scales f32 (qkv_sbf16 0: K8's prep) or
// bf16, every other scale bf16. kv_k / kv_v bf16 (cache_bf16) or f32, layer
// l at + l * kv_ls elements, slot s at + s * kv_bs, each (n_kv, ctx, d)
// dense; slot s's row min(pos[s], ctx - 1) written in place. pos (B,) device
// int32; inv the (d / 2) RoPE inverse frequencies; scale the softmax scale.
// qkv (L, B, H + 2 n_kv d) receives q, k_new, v_new of every layer. scratch
// holds tts_llama_flat_batched_scratch floats, 16-byte aligned; words
// B * heads + 2 zeroed uint32 (the arrival counters and the barrier), left
// zeroed, shared only by launches in stream order. smem: the block's
// dynamic shared memory as the caller reckons it (must equal the
// kernel's). *grid and *per_sm receive the blocks launched and the blocks
// an SM holds. d must be 64 or 128. Returns a CUDA error code (0: ok).
extern "C" int tts_llama_flat_batched(
    float* x, const float* norms, const uint8_t* qkv_c, const void* qkv_s,
    int qkv_sbf16, const uint8_t* o_c, const void* o_s, const uint8_t* gu_c,
    const void* gu_s, const uint8_t* down_c, const void* down_s, void* kv_k,
    void* kv_v, long long kv_ls, long long kv_bs, const int* pos,
    const float* inv, float scale, float* qkv, float* scratch,
    long long scratch_floats, unsigned int* words, int n_words, int qtype,
    int packed, int rows, int n_layers, int hidden, int ffn, int heads,
    int n_kv, int d, int ctx, int cache_bf16, int smem, int* grid,
    int* per_sm, void* stream) {
  if (rows <= 0 || rows > MAX_SLOTS || n_layers <= 0 || heads <= 0 ||
      n_kv <= 0 || heads % n_kv || hidden != heads * d ||
      (d != 64 && d != 128) || ctx <= 0 || kv_bs < (long long)n_kv * ctx * d ||
      hidden % (UNIT_K * k_split(hidden)) || ffn % (UNIT_K * k_split(ffn)) ||
      ffn % TILE_PAIRS || hidden % (2 * TILE_PAIRS) ||
      n_words < rows * heads + 2 ||
      scratch_floats < tts_llama_flat_batched_scratch(rows, hidden, ffn, heads,
                                                      d, ctx)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long cb = packed ? Stage<true, true>::CODES : Stage<false, true>::CODES;
  const long long st_h = hidden / UNIT_K, st_f = ffn / UNIT_K;
  const long long kvn = hidden + 2LL * n_kv * d;
  const long long t_qkv = (kvn / 2 + TILE_PAIRS - 1) / TILE_PAIRS;
  const long long t_h = hidden / (2 * TILE_PAIRS);
  const long long t_gu = ffn / TILE_PAIRS;
  const long long pages = (ctx + PAGE - 1) / PAGE;
  BatchedArgs a;
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
  a.kv_k = kv_k;
  a.kv_v = kv_v;
  a.kv_ls = kv_ls;
  a.kv_bs = kv_bs;
  a.pos = pos;
  a.inv = inv;
  a.scale = scale;
  a.qkv = qkv;
  float* p = scratch;
  a.attn = p;
  p += (size_t)rows * hidden;
  a.act = p;
  p += (size_t)rows * ffn;
  a.part_ml = p;
  p += (size_t)rows * heads * pages * 2;
  a.part_acc = p;
  a.arrivals = words;
  a.bar = words + rows * heads;
  a.rows = rows;
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
