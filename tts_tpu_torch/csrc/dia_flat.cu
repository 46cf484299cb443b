// K10: the Dia decode step over all L decoder layers of one CFG pair as ONE
// persistent, cooperative launch.
//
// Replaces the TPU kernel tts_tpu/ops/dia_megastep.py:_dia_kernel (wrapper
// dia_megastep): the conditional and the unconditional sequence as two
// input rows, per layer RMS -> qkv -> NeoX RoPE -> GQA self-attention at
// softmax scale 1.0 -> o -> RMS -> cross q + RoPE -> cross-attention over
// the bucketed cross K/V with the analytic pad-tail fold -> cross o -> RMS
// -> SiLU(gate) * up -> down, every projection block-quantized with bf16
// scales (`_dqdot` numerics). The TPU kernel is one pallas_call over the 18
// layers whose weight DMA of phase p + 1 overlaps phase p's compute. Its
// contract here is the port's (ops/dia_megastep.py): the step writes this
// token's k / v into cache row pos in place and attends rows [0, pos].
//
// What bounds it on the H100: every weight read once (0.70 GB of Q4_0 at
// Dia-1.6B width) plus the K/V rows up to pos and the bucketed cross K/V,
// about 0.25 ms at 3.35 TB/s at pos 1000 (bytes). The launch sequence
// before it (dia_megastep.cu, still K11's route) issued 144 launches a
// step, each GEMV launch paying a 4-7 us ramp beyond its bytes, and the
// host issuing them was the single stream's bound.
//
// Design: a grid of (SMs x the blocks per SM that fit) blocks of 8 warps,
// launched with cudaLaunchCooperativeKernel, which refuses a grid that
// cannot be resident at once. Each layer runs eight phases, each ended by a
// grid barrier (grid_sync.cuh; none after the last layer's last phase: 143
// a step at 18 layers):
//   1. RMS -> qkv, RoPE, k / v into cache row pos   2. self-attention
//   3. o, x += .      4. RMS -> cross q, RoPE        5. cross-attention
//   6. cross o, x += .  7. RMS -> gate / up, SiLU(gate) * up
//   8. down, x += .
// A GEMV phase runs gemv.cuh's per-item device code (the weight stream, the
// mma over a stage, the RMS sums, the epilogues; the phase functions are
// flat_gemv.cuh's, shared with the llama step): k_split(K) warps of one
// block take the K ranges of one tile (2 at K 2048, 4 at K 8192), and the
// first adds the others' sums in range order through shared memory, the
// order in which the launch sequence's cluster rank 0 adds its ranks'. A
// block stages all of K of the two rows (its warps hold every range of
// their tiles), by the same operations, so the staged bf16 values are the
// same. Tiles spread over the blocks first. The attention phases run
// attention.cuh's pages and their merge by the last block to finish (the
// arrival counters, as K4 does; no extra barrier): the self-attention with
// 2 q heads a page block (K4 takes 4; the outputs do not depend on it), the
// cross-attention with 1 (MHA) and the tail merged last. So every output
// and cache row equals the launch sequence's bit for bit, and each K11 pair
// K10's.
//
// Hiding the ramp: weights are never written during the launch, so a warp
// issues the ring stages of its items in the next GEMV phase as soon as it
// is done with the current one, before the barrier (the counterpart of the
// copies gemv.cuh issues before griddepcontrol.wait; across an attention
// phase they wait in the ring). The ring holds a whole item at K 2048, so
// qkv, o, cq and co (one item a warp at Dia-1.6B width) start with all
// their weights at hand. A phase's chain of dependent loads is kept short:
// the input rows are staged in one round of loads (with an RMS prologue
// the rows and norm weights are copied to shared memory and the sums
// taken there), and pos and the RoPE frequencies are read once a launch
// into shared memory. The attention operands that the step does not write
// (the self K / V rows up to pos, the cross K / V) are prefetched into L2
// two phases ahead (cp.async.bulk.prefetch.L2, split over the blocks): the
// self K / V of layer l from phase 1, its cross K / V from phase 3.
// Prefetching later phases' weights into L2 the same way made the step
// slower (it competed with those latency-bound loads): the rings take the
// weights. Computing a warp's stages two to eight at a time, to interleave
// their chains, made it slower too (255 registers and spills: PERF.md).
//
// Memory: data written inside the launch (x, qkv, the attention output and
// partials, cache row pos, cq, the SiLU output) is read through coherent
// loads; the weights stream through cp.async (L2) and the cross K/V through
// the read-only path.
#include <cuda_runtime.h>

#include "attention.cuh"
#include "flat_gemv.cuh"
#include "grid_sync.cuh"

namespace {

using tts::attn::PAGE;

constexpr int ROWS = 2;       // the CFG pair
// Ring stages a warp keeps: a whole (tile, K range) item at K 2048, so
// that the qkv, o, cq and co phases (one item a warp at Dia-1.6B width)
// find all their weights in shared memory when their barrier opens.
constexpr int FLAT_STAGES = 8;
// passes whose K / V loads a page's warp keeps in flight (K4 keeps 8 for
// one sequence, 2% slower here; the outputs do not depend on it)
constexpr int ATTN_PF = 4;

struct DiaArgs {
  float* x;                  // (2, H), updated in place
  const float* norms;        // (L, 3, H): sa, ca, mlp
  const uint8_t* qkv_c;      // tiled codes, stacked on L (gemv_tile)
  const uint8_t* qkv_s;      // their bf16 scales
  const uint8_t* occ_c;      // o, cross q, cross o
  const uint8_t* occ_s;
  const uint8_t* gu_c;       // gate / up pairs
  const uint8_t* gu_s;
  const uint8_t* down_c;
  const uint8_t* down_s;
  long long qkv_lc, qkv_ls, occ_lc, occ_ls, gu_lc, gu_ls, down_lc, down_ls;  // bytes a layer
  void* kv_k;                // layer l at + l * kv_ls elements, row r at + r * kv_rs
  void* kv_v;
  long long kv_ls, kv_rs;
  const __nv_bfloat16* ck;   // layer l at + l * cross_ls, row r at + r * heads * sb * D
  const __nv_bfloat16* cv;
  long long cross_ls;
  const float* vtail;        // layer l at + l * vtail_ls, (2 heads, D); null: no tail
  long long vtail_ls;
  float n_tail;
  const int* pos;            // (1,)
  const float* inv;          // (D / 2) RoPE inverse frequencies
  float* qkv;                // (L, 2, H + 2 KV): q, k_new, v_new of every layer
  float* attn;               // (2, heads, D)
  float* cq;                 // (2, H)
  float* act;                // (2, F)
  float* part_ml;            // (2 heads, n_pages, 2)
  float* part_acc;           // (2 heads, n_pages, D)
  unsigned int* arrivals;    // 2 heads counters, zero on entry and exit
  unsigned int* bar;         // grid_sync's 2 words
  int n_layers, hidden, ffn, heads, n_kv, ctx, sb, n_pages, cache_bf16;
};

enum Which { W_QKV = 0, W_O = 1, W_CQ = 2, W_CO = 3, W_GATE_UP = 4, W_DOWN = 5 };

// pos and inv: shared-memory copies of a.pos[0] and a.inv.
template <bool PACKED>
__device__ __forceinline__ Gemv gemv_of(const DiaArgs& a, int l, int which,
                                        const int* pos, const float* inv) {
  using S = Stage<PACKED, true>;
  constexpr int SC = S::BYTES - S::CODES;
  const int H = a.hidden, D = H / a.heads, kvh = a.n_kv * D;
  const int kvn = H + 2 * kvh;
  // the tiles of o, cross q and cross o follow one another in occ
  const long long t1 = H / (2 * TILE_PAIRS), st_h = H / UNIT_K;
  const RopeArgs rope{inv, pos, 0, nullptr, nullptr, H, 0, D, a.ctx,
                      a.cache_bf16, a.kv_rs};
  Gemv g{};
  g.ra = rope;
  g.K = H;
  if (which == W_QKV) {
    g.codes = a.qkv_c + l * a.qkv_lc;
    g.scales = a.qkv_s + l * a.qkv_ls;
    g.x = a.x;
    g.norm_w = a.norms + (size_t)(3 * l) * H;
    g.N = kvn;
    g.P = kvn / 2;
    g.epi = EPI_ROPE_QKV;
    g.out = a.qkv + (size_t)l * ROWS * kvn;
    const size_t el = (a.cache_bf16 ? 2 : 4) * (size_t)(l * a.kv_ls);
    g.ra.kc = reinterpret_cast<uint8_t*>(a.kv_k) + el;
    g.ra.vc = reinterpret_cast<uint8_t*>(a.kv_v) + el;
    g.ra.kvh = kvh;
  } else if (which == W_O || which == W_CQ || which == W_CO) {
    const long long tile0 = (which - W_O) * t1 * st_h;
    g.codes = a.occ_c + l * a.occ_lc + tile0 * S::CODES;
    g.scales = a.occ_s + l * a.occ_ls + tile0 * SC;
    g.N = H;
    g.P = H / 2;
    if (which == W_CQ) {
      g.x = a.x;
      g.norm_w = a.norms + (size_t)(3 * l + 1) * H;
      g.epi = EPI_ROPE_QKV;   // no k or v features: rotates q, writes no cache
      g.out = a.cq;
    } else {
      g.x = a.attn;
      g.epi = EPI_RESIDUAL;
      g.res = a.x;
      g.out = a.x;
    }
  } else if (which == W_GATE_UP) {
    g.codes = a.gu_c + l * a.gu_lc;
    g.scales = a.gu_s + l * a.gu_ls;
    g.x = a.x;
    g.norm_w = a.norms + (size_t)(3 * l + 2) * H;
    g.N = a.ffn;
    g.P = a.ffn;
    g.epi = EPI_SILU_MUL;
    g.out = a.act;
  } else {
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

// The self-attention of layer l: the (pair row, q-head group) x 256-row
// page items over the blocks, each block merging an item's pages when it
// finishes its last (attn_finish). G q heads share a page block.
template <typename T, int D, int G>
__device__ __forceinline__ void self_attention(const DiaArgs& a, int l, int pos) {
  const int kvn = a.hidden + 2 * a.n_kv * D, n_rep = a.heads / a.n_kv;
  const int live = pos / PAGE + 1;
  const T* kc = reinterpret_cast<const T*>(a.kv_k) + l * a.kv_ls;
  const T* vc = reinterpret_cast<const T*>(a.kv_v) + l * a.kv_ls;
  const float* q = a.qkv + (size_t)l * ROWS * kvn;
  const int items = ROWS * (a.heads / G) * live;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int bg = it / live, page = it % live;
    tts::attn::attn_page<T, D, G, false, ATTN_PF>(
        q, kc, vc, pos, a.attn, a.part_ml, a.part_acc, bg, page, a.n_pages,
        a.heads, n_rep, a.ctx, kvn, a.kv_rs, 1.f, nullptr, 0.f);
    if (live > 1) {
      tts::attn::attn_finish<D, G>(a.part_ml, a.part_acc, a.arrivals, pos,
                                   a.attn, bg, a.n_pages, a.heads, nullptr, 0.f);
    }
    __syncthreads();   // the next item reuses the page's shared memory
  }
}

// The cross-attention of layer l: every one of the sb bucket rows of each
// (pair row, head), one head a page block, the tail merged last.
template <int D>
__device__ __forceinline__ void cross_attention(const DiaArgs& a, int l) {
  const int last = a.sb - 1, live = last / PAGE + 1;
  const __nv_bfloat16* kc = a.ck + l * a.cross_ls;
  const __nv_bfloat16* vc = a.cv + l * a.cross_ls;
  const float* tail = a.vtail != nullptr ? a.vtail + l * a.vtail_ls : nullptr;
  const long long kv_rs = (long long)a.heads * a.sb * D;
  const int items = ROWS * a.heads * live;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int bg = it / live, page = it % live;
    tts::attn::attn_page<__nv_bfloat16, D, 1, true, ATTN_PF>(
        a.cq, kc, vc, last, a.attn, a.part_ml, a.part_acc, bg, page,
        a.n_pages, a.heads, 1, a.sb, a.hidden, kv_rs, 1.f, tail, a.n_tail);
    if (live > 1) {
      tts::attn::attn_finish<D, 1>(a.part_ml, a.part_acc, a.arrivals, last,
                                   a.attn, bg, a.n_pages, a.heads, tail, a.n_tail);
    }
    __syncthreads();
  }
}

template <int QT, bool PACKED, typename T, int D>
__global__ void __launch_bounds__(THREADS, 1) dia_flat_kernel(DiaArgs a) {
  using S = Stage<PACKED, true>;
  extern __shared__ __align__(16) uint8_t smem[];   // flat_smem_bytes
  __shared__ double rms_part[MAX_KS][MAX_ROWS];
  __shared__ float rstd[MAX_ROWS];
  __shared__ int pos_s;
  __shared__ float inv_s[D / 2];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Smem sm;
  sm.ring = smem + warp * FLAT_STAGES * S::BYTES;
  sm.slots = reinterpret_cast<float4*>(smem + WARPS * FLAT_STAGES * S::BYTES);
  sm.raw = sm.slots + 2 * WARPS * 32;
  sm.xs = reinterpret_cast<uint8_t*>(sm.raw) + (ROWS + 1) * a.hidden * sizeof(float);
  const bool pairs_of_heads = (a.heads / a.n_kv) % 2 == 0;
  WeightStream<PACKED, true> ws;
  Gemv gv = gemv_of<PACKED>(a, 0, W_QKV, &pos_s, inv_s);
  gemv_begin<PACKED, true, FLAT_STAGES>(ws, gv, sm.ring, warp, lane);
  if (threadIdx.x == 0) pos_s = a.pos[0];
  if (threadIdx.x < D / 2) inv_s[threadIdx.x] = a.inv[threadIdx.x];
  __syncthreads();
  const int pos = min(pos_s, a.ctx - 1);   // the cache row written and attended up to
  const long long kv_bytes = (long long)(pos + 1) * D * sizeof(T);
  const long long cross_bytes = (long long)ROWS * a.heads * a.sb * D * sizeof(__nv_bfloat16);
  for (int l = 0; l < a.n_layers; ++l) {
    // 1. RMS -> qkv, RoPE; k, v into cache row pos (this layer's self K / V
    //    rows into L2 meanwhile: each row's kv heads, K and V)
    const T* kc = reinterpret_cast<const T*>(a.kv_k) + l * a.kv_ls;
    const T* vc = reinterpret_cast<const T*>(a.kv_v) + l * a.kv_ls;
    prefetch_l2(kc, (long long)a.ctx * D, ROWS * a.n_kv, kv_bytes);
    prefetch_l2(vc, (long long)a.ctx * D, ROWS * a.n_kv, kv_bytes);
    gemv_run<QT, PACKED, true, ROWS, FLAT_STAGES>(ws, gv, sm, rms_part, rstd);
    gv = gemv_of<PACKED>(a, l, W_O, &pos_s, inv_s);
    gemv_begin<PACKED, true, FLAT_STAGES>(ws, gv, sm.ring, warp, lane);
    grid_sync(a.bar);
    // 2. self-attention over rows [0, pos]
    if (pairs_of_heads) {
      self_attention<T, D, 2>(a, l, pos);
    } else {
      self_attention<T, D, 1>(a, l, pos);
    }
    grid_sync(a.bar);
    // 3. o; x += .  (this layer's cross K / V into L2 meanwhile)
    prefetch_l2(a.ck + l * a.cross_ls, 0, 1, cross_bytes);
    prefetch_l2(a.cv + l * a.cross_ls, 0, 1, cross_bytes);
    gemv_run<QT, PACKED, true, ROWS, FLAT_STAGES>(ws, gv, sm, rms_part, rstd);
    gv = gemv_of<PACKED>(a, l, W_CQ, &pos_s, inv_s);
    gemv_begin<PACKED, true, FLAT_STAGES>(ws, gv, sm.ring, warp, lane);
    grid_sync(a.bar);
    // 4. RMS -> cross q, RoPE
    gemv_run<QT, PACKED, true, ROWS, FLAT_STAGES>(ws, gv, sm, rms_part, rstd);
    gv = gemv_of<PACKED>(a, l, W_CO, &pos_s, inv_s);
    gemv_begin<PACKED, true, FLAT_STAGES>(ws, gv, sm.ring, warp, lane);
    grid_sync(a.bar);
    // 5. cross-attention over the bucket, the tail folded last
    cross_attention<D>(a, l);
    grid_sync(a.bar);
    // 6. cross o; x += .
    gemv_run<QT, PACKED, true, ROWS, FLAT_STAGES>(ws, gv, sm, rms_part, rstd);
    gv = gemv_of<PACKED>(a, l, W_GATE_UP, &pos_s, inv_s);
    gemv_begin<PACKED, true, FLAT_STAGES>(ws, gv, sm.ring, warp, lane);
    grid_sync(a.bar);
    // 7. RMS -> gate / up, SiLU(gate) * up
    gemv_run<QT, PACKED, true, ROWS, FLAT_STAGES>(ws, gv, sm, rms_part, rstd);
    gv = gemv_of<PACKED>(a, l, W_DOWN, &pos_s, inv_s);
    gemv_begin<PACKED, true, FLAT_STAGES>(ws, gv, sm.ring, warp, lane);
    grid_sync(a.bar);
    // 8. down; x += .
    gemv_run<QT, PACKED, true, ROWS, FLAT_STAGES>(ws, gv, sm, rms_part, rstd);
    if (l + 1 < a.n_layers) {
      gv = gemv_of<PACKED>(a, l + 1, W_QKV, &pos_s, inv_s);
      gemv_begin<PACKED, true, FLAT_STAGES>(ws, gv, sm.ring, warp, lane);
      grid_sync(a.bar);
    }
  }
  grid_exit(a.bar);
}

// Dynamic shared memory of a block (Smem; ops/dia_flat.py smem_bytes
// reckons the same).
template <bool PACKED>
int flat_smem_bytes(int hidden, int ffn) {
  return WARPS * FLAT_STAGES * Stage<PACKED, true>::BYTES + 2 * WARPS * 32 * 16 +
         (ROWS + 1) * hidden * (int)sizeof(float) +
         ROWS * xs_stride(hidden > ffn ? hidden : ffn);
}

template <int QT, bool PACKED, typename T, int D>
int launch(DiaArgs a, int smem, cudaStream_t s, int* grid_out, int* per_sm_out) {
  if (smem != flat_smem_bytes<PACKED>(a.hidden, a.ffn)) return (int)cudaErrorInvalidValue;
  return launch_cooperative(reinterpret_cast<const void*>(dia_flat_kernel<QT, PACKED, T, D>),
                            a, smem, s, grid_out, per_sm_out);
}

template <typename T, int D>
int dispatch_qtype(const DiaArgs& a, int qtype, int packed, int smem,
                   cudaStream_t s, int* grid, int* per_sm) {
  if (qtype == Q4_0 && packed) return launch<Q4_0, true, T, D>(a, smem, s, grid, per_sm);
  if (qtype == Q5_0 && !packed) return launch<Q5_0, false, T, D>(a, smem, s, grid, per_sm);
  if (qtype == Q8_0 && !packed) return launch<Q8_0, false, T, D>(a, smem, s, grid, per_sm);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Floats of scratch one step needs (ops/dia_flat.py scratch_floats reckons
// the same): the attention output (2H), cross q (2H), the SiLU output (2F)
// and the page partials (2 heads, n_pages, 2 + D), n_pages covering the
// larger of ctx and sb.
extern "C" long long tts_dia_flat_scratch(int hidden, int ffn, int heads,
                                          int d, int ctx, int sb) {
  const long long pages = ((ctx > sb ? ctx : sb) + PAGE - 1) / PAGE;
  return 4LL * hidden + 2LL * ffn + 2LL * heads * pages * (2 + d);
}

// One Dia decode step of L layers for one CFG pair: x (2, H) f32, updated
// in place to the pre-final-norm output. Weights as DiaMegaLayers
// (ops/dia_megastep.py: tiled, Q4_0 packed, Q5_0 or Q8_0 codes, bf16
// scales, contiguous, stacked on L). kv_k / kv_v bf16 (cache_bf16) or f32,
// row r of layer l at + l * kv_ls + r * kv_rs elements, (n_kv, ctx, d)
// dense; row min(pos, ctx - 1) written in place. ck / cv bf16, (2, heads,
// sb, d) dense a layer, layer l at + l * cross_ls; vtail f32 (2 heads, d)
// at + l * vtail_ls, null exactly when n_tail is 0. pos a device int32;
// inv the (d / 2) RoPE inverse frequencies. qkv (L, 2, H + 2 n_kv d)
// receives q, k_new, v_new of every layer. scratch holds
// tts_dia_flat_scratch floats, 16-byte aligned; words 2 heads + 2 zeroed
// uint32 (the arrival counters and the barrier), left zeroed, shared only
// by launches in stream order. smem: the block's dynamic shared memory as
// the caller reckons it (must equal the kernel's). *grid and *per_sm
// receive the blocks launched and the blocks an SM holds. Returns a CUDA
// error code (0: ok).
extern "C" int tts_dia_flat(
    float* x, const float* norms, const uint8_t* qkv_c, const void* qkv_s,
    const uint8_t* occ_c, const void* occ_s, const uint8_t* gu_c,
    const void* gu_s, const uint8_t* down_c, const void* down_s, void* kv_k,
    void* kv_v, long long kv_ls, const void* ck, const void* cv,
    long long cross_ls, const float* vtail, long long vtail_ls, float n_tail,
    const int* pos, const float* inv, float* qkv, float* scratch,
    long long scratch_floats, unsigned int* words, int n_words, int qtype,
    int packed, int n_layers, int hidden, int ffn, int heads, int n_kv, int d,
    int ctx, int sb, int cache_bf16, int smem, int* grid, int* per_sm,
    void* stream) {
  if (n_layers <= 0 || heads <= 0 || n_kv <= 0 || heads % n_kv ||
      hidden != heads * d || (d != 64 && d != 128) || ctx <= 0 || sb <= 0 ||
      hidden % (UNIT_K * k_split(hidden)) || ffn % (UNIT_K * k_split(ffn)) ||
      ffn % TILE_PAIRS || hidden % (2 * TILE_PAIRS) ||
      (vtail == nullptr) != (n_tail == 0.f) || n_tail < 0.f ||
      n_words < 2 * heads + 2 ||
      scratch_floats < tts_dia_flat_scratch(hidden, ffn, heads, d, ctx, sb)) {
    return (int)cudaErrorInvalidValue;
  }
  using S4 = Stage<true, true>;
  using S8 = Stage<false, true>;
  const long long cb = packed ? S4::CODES : S8::CODES;
  const long long sc = S4::BYTES - S4::CODES;   // bf16 scales of a stage
  const long long st_h = hidden / UNIT_K, st_f = ffn / UNIT_K;
  const long long kvn = hidden + 2LL * n_kv * d;
  const long long t_qkv = (kvn / 2 + TILE_PAIRS - 1) / TILE_PAIRS;
  const long long t_h = hidden / (2 * TILE_PAIRS);
  const long long t_gu = ffn / TILE_PAIRS;
  const long long pages = ((ctx > sb ? ctx : sb) + PAGE - 1) / PAGE;
  DiaArgs a;
  a.x = x;
  a.norms = norms;
  a.qkv_c = qkv_c;
  a.qkv_s = reinterpret_cast<const uint8_t*>(qkv_s);
  a.occ_c = occ_c;
  a.occ_s = reinterpret_cast<const uint8_t*>(occ_s);
  a.gu_c = gu_c;
  a.gu_s = reinterpret_cast<const uint8_t*>(gu_s);
  a.down_c = down_c;
  a.down_s = reinterpret_cast<const uint8_t*>(down_s);
  a.qkv_lc = t_qkv * st_h * cb;
  a.qkv_ls = t_qkv * st_h * sc;
  a.occ_lc = 3 * t_h * st_h * cb;
  a.occ_ls = 3 * t_h * st_h * sc;
  a.gu_lc = t_gu * st_h * cb;
  a.gu_ls = t_gu * st_h * sc;
  a.down_lc = t_h * st_f * cb;
  a.down_ls = t_h * st_f * sc;
  a.kv_k = kv_k;
  a.kv_v = kv_v;
  a.kv_ls = kv_ls;
  a.kv_rs = (long long)n_kv * ctx * d;
  a.ck = reinterpret_cast<const __nv_bfloat16*>(ck);
  a.cv = reinterpret_cast<const __nv_bfloat16*>(cv);
  a.cross_ls = cross_ls;
  a.vtail = vtail;
  a.vtail_ls = vtail_ls;
  a.n_tail = n_tail;
  a.pos = pos;
  a.inv = inv;
  a.qkv = qkv;
  float* p = scratch;
  a.attn = p;
  p += 2 * hidden;
  a.cq = p;
  p += 2 * hidden;
  a.act = p;
  p += 2 * ffn;
  a.part_ml = p;
  p += 2 * heads * pages * 2;
  a.part_acc = p;
  a.arrivals = words;
  a.bar = words + 2 * heads;
  a.n_layers = n_layers;
  a.hidden = hidden;
  a.ffn = ffn;
  a.heads = heads;
  a.n_kv = n_kv;
  a.ctx = ctx;
  a.sb = sb;
  a.n_pages = (int)pages;
  a.cache_bf16 = cache_bf16;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TTS_FLAT_ARGS a, qtype, packed, smem, s, grid, per_sm
  if (cache_bf16 && d == 128) return dispatch_qtype<__nv_bfloat16, 128>(TTS_FLAT_ARGS);
  if (cache_bf16 && d == 64) return dispatch_qtype<__nv_bfloat16, 64>(TTS_FLAT_ARGS);
  if (!cache_bf16 && d == 128) return dispatch_qtype<float, 128>(TTS_FLAT_ARGS);
  return dispatch_qtype<float, 64>(TTS_FLAT_ARGS);
#undef TTS_FLAT_ARGS
}
