// K12: the Parler decode step over all L layers of one stream as ONE
// persistent, cooperative launch.
//
// Replaces the TPU kernel tts_tpu/ops/parler_flat.py:_pflat_kernel (wrapper
// parler_flat_megastep): K2's function, LN -> qkv -> self-attention -> o ->
// LN -> cross-q -> cross-attention -> co -> LN -> fc1 -> tanh-GELU -> fc2
// per layer, weights block-quantized with bf16 scales (`_dqdot` numerics),
// as one kernel over the layer stack. The TPU kernel streams uniform weight
// tiles through VMEM in a sequential grid driven by a prefetched schedule;
// none of that carries over. Its contract here is the port's K2 contract
// (ops/parler_megastep.py): the step writes this token's k / v into cache
// row pos in place and attends rows [0, pos].
//
// What bounds it on the H100: the same bytes as K2, every weight read once
// (198 MB at Parler-Mini width, 59 us at 3.35 TB/s) plus the K/V rows up to
// pos. K2 issues 8 launches per layer (192 per step at 24 layers) and the
// single stream is host-bound on them (PERF.md); K12 issues one.
//
// Design: a grid of (SMs x the blocks per SM that fit) blocks of 8 warps,
// launched with cudaLaunchCooperativeKernel, which refuses a grid that
// cannot be resident at once (so no wait below can deadlock). The step is
// a chain of short phases (a GEMV phase moves ~1.5 MB of weights, 0.44 us
// at 3.35 TB/s), so what costs is the wait at each phase's end and the
// weight stream's ramp after it. Per layer:
//   1. LN1 -> qkv: the GEMV's tile groups over the blocks, each block
//      normalizing x into shared memory itself; the epilogue writes k, v
//      into cache row pos, and each tile's first warp, done with the
//      phase, counts its tiles on their heads' readiness counters
//      (parler_gemv.cuh gemv_run)
//   2. self-attention: the (head, 256-row page) items up to pos over the
//      blocks, an item starting once its head's 3 D / 16 tiles (q, k and v:
//      12 at D 64) have arrived, with no grid barrier after the qkv phase;
//      a head's pages merged by the block that finishes its last page
//      (attention.cuh attn_finish_acq_rel, on arrival counters as K3 and
//      the llama step merge), with no barrier before a combine
//   == grid barrier (o reads every head's output)
//   3. o, x += .           == grid barrier (LNc reads all of x)
//   4. LNc -> cross-q, each tile counted on its head's cross counter
//   5. cross-attention pages, a head's once its D / 16 cross-q tiles have
//      arrived, merged by arrival        == grid barrier
//   6. co, x += .          == grid barrier (LN2 reads all of x)
//   7. LN2, fc1, GELU      == grid barrier (fc2 reads all of the GELU output)
//   8. fc2, x += .         == grid barrier (the next LN1), none after the last
// So 6 grid barriers a layer with the cross block and 4 without (6 L - 1 and
// 4 L - 1 a step), where the launch sequence's eight phases took 8-9 (9 once
// a page past the first is live, a combine barrier more). Phases 4-6 drop
// when use_cross is off. A warp issues the first ring stages of its items in
// the next GEMV phase as soon as it is done with the current one
// (gemv_begin: weights are never written during a launch), so they land
// while the block waits at the barrier or serves attention pages. The
// readiness counters rise monotonically over the launch (layer l's target
// is (l + 1) times the tiles), the barrier's words and the counters are
// zeroed before each launch, and block 0 leaves the count of grid barriers
// it passed in a scratch word that the host reads back (ops/parler_flat.py
// barriers_passed) against the plan.
// Each GEMV phase and each attention page / combine is computed by the very
// device code K2 and K3 launch (parler_gemv.cuh's gemv_run, attention.cuh),
// with the same block shape (8 warps: a GEMV tile's K split over them, the
// first 4 walking a page's rows), so a feature sums in the same order on
// both routes and K12 equals K2 bit for bit; what changed is when a block
// may start an item, never what it sums. The GEMV splits K over the warps
// of a block, not over a cluster, so that this cooperative launch runs the
// same order.
//
// The barrier is grid_sync.cuh's, shared with K10 (dia_flat.cu), and so is
// the readiness wait (wait_count): a count in device memory, polled with
// acquire loads, the wait giving up with a trap after about ten seconds
// rather than hang. Data that blocks of the launch write (x, qkv, the
// attention output and partials, the cache row pos, cq, the GELU output)
// is read through plain loads, never the read-only cache, and a writer
// fences it before it counts; the weights stream through cp.async (L2),
// the cross K/V through the read-only cache.
#include <cuda_runtime.h>

#include "attention.cuh"
#include "grid_sync.cuh"
#include "parler_gemv.cuh"

namespace {

using namespace tts;
using namespace tts::parler;
using tts::attn::PAGE;

constexpr int HEAD_D = 64;  // Parler's head size (hidden / heads)
// passes whose K / V loads a page's warp keeps in flight: fewer than K3's,
// so that the page code does not raise the step's registers per thread,
// which set how many blocks of the one launch fit on an SM
constexpr int PAGE_PF = 2;

struct FlatArgs {
  float* x;                 // (H) the residual stream, updated in place
  const float* norms;       // (L, 6, H)
  const uint8_t* qkv_c;     // (L, 3H / 16, H / 128, .) tiled codes (gemv_tile),
  const __nv_bfloat16* qkv_s;  // bf16 scales beside
  const uint8_t* occ_c;     // (L, 3H / 16, H / 128, .): o, cross-q, cross-o
  const __nv_bfloat16* occ_s;
  const uint8_t* fc1_c;     // (L, F / 16, H / 128, .)
  const __nv_bfloat16* fc1_s;
  const uint8_t* fc2_c;     // (L, H / 16, F / 128, .)
  const __nv_bfloat16* fc2_s;
  const float* cross_k;     // (L, heads, Tc, D) f32
  const float* cross_v;
  void* kv_k;               // (L, heads, ctx, D) bf16 or f32
  void* kv_v;
  const int* pos;           // (1,) device position
  float* qkv;               // (L, 3H): q, k_new, v_new of every layer
  float* attn;              // (heads, D) attention output
  float* cq;                // (H) cross-attention query
  float* up;                // (F) GELU(fc1)
  float* part_ml;           // (heads, n_pages, 2) page partials
  float* part_acc;          // (heads, n_pages, D)
  unsigned int* bar;        // grid_sync's 2 words, then the barriers passed
  unsigned int* ready;      // (heads) qkv tiles arrived a head, over the launch
  unsigned int* ready_cross;  // (heads) cross-q tiles arrived a head
  unsigned int* arrivals;   // (heads) pages done a head (attn_finish_acq_rel)
  int n_layers, hidden, ffn, heads, ctx, tc, use_cross;
  float scale;              // D ** -0.5
};

constexpr int BAR_WORDS = 4;   // the barrier's 2, the count, a pad word

// The GEMV phases' tiles that write one head's outputs: q, k and v for the
// self-attention, the cross query for the cross-attention.
constexpr unsigned int QKV_TILES = 3 * HEAD_D / TILE;
constexpr unsigned int CQ_TILES = HEAD_D / TILE;

// A grid barrier, counted in a register (block 0 stores the count into
// bar[2] as it leaves: a store after each barrier would delay it there).
__device__ __forceinline__ void step_sync(const FlatArgs& a, unsigned int& n) {
  grid_sync(a.bar);
  ++n;
}

// One attention over heads x ceil(rows / 256) pages of (heads, rows, D)
// K/V up to row `last`, out (heads, D): head h's pages start once
// ready[h] reaches `target`, and where more than the first page is live
// the block that finishes a head's last page merges its pages.
template <typename T, bool NC>
__device__ __forceinline__ void attention_phase(const FlatArgs& a,
                                                const float* q, const T* kc,
                                                const T* vc, int rows,
                                                int last,
                                                const unsigned int* ready,
                                                unsigned int target) {
  const int n_pages = (rows + PAGE - 1) / PAGE, live = last / PAGE + 1;
  for (int it = blockIdx.x; it < a.heads * live; it += gridDim.x) {
    const int h = it / live;
    wait_count(ready + h, target);
    tts::attn::attn_page<T, HEAD_D, 1, NC, PAGE_PF>(
        q, kc, vc, last, a.attn, a.part_ml, a.part_acc, h, it % live,
        n_pages, a.heads, 1, rows, 0, 0, a.scale, nullptr, 0.f);
    if (live > 1) {
      tts::attn::attn_finish_acq_rel<HEAD_D, 1>(a.part_ml, a.part_acc,
                                                a.arrivals, last, a.attn, h,
                                                n_pages, a.heads);
    }
    __syncthreads();  // the next item reuses the page's shared memory
  }
}

template <int QT, bool PACKED, typename T>
__global__ void __launch_bounds__(WARPS * 32, 1) pflat_kernel(FlatArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];  // the GEMV's (smem_bytes)
  const int H = a.hidden, F = a.ffn;
  const size_t rb_h = PACKED ? H / 2 : H, rb_f = PACKED ? F / 2 : F;
  const size_t sb_h = H / QK, sb_f = F / QK;
  const size_t kv_layer = (size_t)a.heads * a.ctx * HEAD_D;
  const size_t cross_layer = (size_t)a.heads * a.tc * HEAD_D;
  const int pos = min(a.pos[0], a.ctx - 1);
  uint8_t* ring = smem + threadIdx.x / 32 * RING * Stage<PACKED, true>::BYTES;
  WeightStream<PACKED, true> ws;
  unsigned int n_bar = 0;   // grid barriers passed
  gemv_begin<PACKED>(ws, a.qkv_c, a.qkv_s, 3 * H, H, ring);
  for (int l = 0; l < a.n_layers; ++l) {
    const float* nm = a.norms + (size_t)l * 6 * H;
    float* qkv = a.qkv + (size_t)l * 3 * H;
    T* kc = reinterpret_cast<T*>(a.kv_k) + l * kv_layer;
    T* vc = reinterpret_cast<T*>(a.kv_v) + l * kv_layer;
    const CacheArgs c{kc, vc, a.pos, H, HEAD_D, a.ctx,
                      sizeof(T) == 2 ? 1 : 0, 0};
    const uint8_t* occ_c = a.occ_c + (size_t)l * 3 * H * rb_h;
    const __nv_bfloat16* occ_s = a.occ_s + (size_t)l * 3 * H * sb_h;
    // 1. LN1 -> qkv; k, v into cache row pos; each tile counted on its head
    gemv_run<QT, PACKED, 1, true, EPI_QKV>(
        ws, a.x, nm, nm + H, 1, 3 * H, H, nullptr, qkv, c, smem, a.ready);
    gemv_begin<PACKED>(ws, occ_c, occ_s, H, H, ring);
    // 2. self-attention over rows [0, pos], a head once its tiles are in
    attention_phase<T, false>(a, qkv, kc, vc, a.ctx, pos, a.ready,
                              QKV_TILES * (l + 1));
    step_sync(a, n_bar);
    // 3. o; x += .
    gemv_run<QT, PACKED, 1, false, EPI_RESIDUAL>(
        ws, a.attn, nullptr, nullptr, 1, H, H, a.x, a.x, c, smem);
    if (a.use_cross) {
      gemv_begin<PACKED>(ws, occ_c + H * rb_h, occ_s + H * sb_h, H, H, ring);
      step_sync(a, n_bar);
      // 4. LNc -> cross-q; each tile counted on its head
      gemv_run<QT, PACKED, 1, true, EPI_STORE>(
          ws, a.x, nm + 2 * H, nm + 3 * H, 1, H, H, nullptr, a.cq, c, smem,
          a.ready_cross);
      gemv_begin<PACKED>(ws, occ_c + 2 * H * rb_h, occ_s + 2 * H * sb_h, H, H,
                         ring);
      // 5. cross-attention over every row of the cross K/V
      attention_phase<float, true>(a, a.cq, a.cross_k + l * cross_layer,
                                   a.cross_v + l * cross_layer, a.tc,
                                   a.tc - 1, a.ready_cross,
                                   CQ_TILES * (l + 1));
      step_sync(a, n_bar);
      // 6. co; x += .
      gemv_run<QT, PACKED, 1, false, EPI_RESIDUAL>(
          ws, a.attn, nullptr, nullptr, 1, H, H, a.x, a.x, c, smem);
    }
    gemv_begin<PACKED>(ws, a.fc1_c + (size_t)l * F * rb_h,
                       a.fc1_s + (size_t)l * F * sb_h, F, H, ring);
    step_sync(a, n_bar);
    // 7. LN2 -> fc1 -> GELU
    gemv_run<QT, PACKED, 1, true, EPI_GELU>(
        ws, a.x, nm + 4 * H, nm + 5 * H, 1, F, H, nullptr, a.up, c, smem);
    gemv_begin<PACKED>(ws, a.fc2_c + (size_t)l * H * rb_f,
                       a.fc2_s + (size_t)l * H * sb_f, H, F, ring);
    step_sync(a, n_bar);
    // 8. fc2; x += .
    gemv_run<QT, PACKED, 1, false, EPI_RESIDUAL>(
        ws, a.up, nullptr, nullptr, 1, H, F, a.x, a.x, c, smem);
    if (l + 1 < a.n_layers) {
      gemv_begin<PACKED>(ws, a.qkv_c + (size_t)(l + 1) * 3 * H * rb_h,
                         a.qkv_s + (size_t)(l + 1) * 3 * H * sb_h, 3 * H, H,
                         ring);
      step_sync(a, n_bar);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.bar[2] = n_bar;
}

template <int QT, bool PACKED, typename T>
int launch(FlatArgs a, cudaStream_t s, int* grid_out) {
  auto kern = pflat_kernel<QT, PACKED, T>;
  const int smem = smem_bytes<PACKED, 1>(1, a.hidden > a.ffn ? a.hidden : a.ffn);
  cudaError_t e;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // opted in at every size: the page code's static shared memory counts
  // toward the 48 KB a block gets without
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess) {
    return (int)e;
  }
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, WARPS * 32, smem)) != cudaSuccess) {
    return (int)e;
  }
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sms * per_sm;
  if (grid_out) *grid_out = grid;
  // the barrier's words, the count, the readiness and arrival counters
  if ((e = cudaMemsetAsync(a.bar, 0, (BAR_WORDS + 3 * a.heads) * sizeof(unsigned int),
                           s)) != cudaSuccess) {
    return (int)e;
  }
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kern),
                                  dim3(grid), dim3(WARPS * 32), args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const FlatArgs& a, int qtype, int packed, cudaStream_t s,
             int* grid) {
  if (qtype == Q4_0 && packed) return launch<Q4_0, true, T>(a, s, grid);
  if (qtype == Q5_0 && !packed) return launch<Q5_0, false, T>(a, s, grid);
  if (qtype == Q8_0 && !packed) return launch<Q8_0, false, T>(a, s, grid);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Floats of scratch one step needs (the Python wrapper allocates them):
// qkv (L, 3H) first, then attn (H), cq (H), up (F), the page partials
// (heads, n_pages, 2 + D), then words: the barrier's 2, the barriers
// passed, a pad word, and per head the qkv and cross-q readiness counters
// and the pages' arrival counter.
extern "C" long long tts_parler_flat_scratch(int n_layers, int hidden,
                                             int ffn, int heads, int ctx,
                                             int tc) {
  const long long pages = ((ctx > tc ? ctx : tc) + PAGE - 1) / PAGE;
  return (long long)n_layers * 3 * hidden + 2LL * hidden + ffn +
         (long long)heads * pages * (2 + HEAD_D) + BAR_WORDS + 3LL * heads;
}

// One decode step of L Parler layers for one stream: x (H) f32, updated in
// place to the pre-final-norm output; weights as MegaLayers
// (ops/parler_megastep.py: tiled, Q4_0 packed, Q5_0 or Q8_0 codes, bf16
// scales, contiguous, stacked on L; H and F multiples of 128); kv_k / kv_v (L, heads, ctx, 64) bf16
// (cache_bf16) or f32, row min(pos, ctx - 1) written in place; pos a
// device int32; scratch of tts_parler_flat_scratch floats, 16-byte
// aligned, whose first L * 3H floats receive q, k_new, v_new per layer
// and whose word L * 3H + 2H + F + heads * n_pages * (2 + D) + 2 receives
// the grid barriers the step passed. *grid receives the blocks launched. Returns a CUDA error code (0: ok).
extern "C" int tts_parler_flat(
    float* x, const float* norms, const uint8_t* qkv_c, const void* qkv_s,
    const uint8_t* occ_c, const void* occ_s, const uint8_t* fc1_c,
    const void* fc1_s, const uint8_t* fc2_c, const void* fc2_s,
    const float* cross_k, const float* cross_v, void* kv_k, void* kv_v,
    const int* pos, float* scratch, long long scratch_floats, int qtype,
    int packed, int n_layers, int hidden, int ffn, int heads, int ctx,
    int tc, int cache_bf16, int use_cross, float scale, int* grid,
    void* stream) {
  if (n_layers <= 0 || hidden <= 0 || hidden != heads * HEAD_D ||
      hidden % UNIT_K || ffn <= 0 || ffn % UNIT_K || ctx <= 0 || tc <= 0 ||
      scratch_floats < tts_parler_flat_scratch(n_layers, hidden, ffn, heads,
                                               ctx, tc)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long pages = ((ctx > tc ? ctx : tc) + PAGE - 1) / PAGE;
  FlatArgs a;
  a.x = x;
  a.norms = norms;
  a.qkv_c = qkv_c;
  a.qkv_s = reinterpret_cast<const __nv_bfloat16*>(qkv_s);
  a.occ_c = occ_c;
  a.occ_s = reinterpret_cast<const __nv_bfloat16*>(occ_s);
  a.fc1_c = fc1_c;
  a.fc1_s = reinterpret_cast<const __nv_bfloat16*>(fc1_s);
  a.fc2_c = fc2_c;
  a.fc2_s = reinterpret_cast<const __nv_bfloat16*>(fc2_s);
  a.cross_k = cross_k;
  a.cross_v = cross_v;
  a.kv_k = kv_k;
  a.kv_v = kv_v;
  a.pos = pos;
  float* p = scratch;
  a.qkv = p;
  p += (size_t)n_layers * 3 * hidden;
  a.attn = p;
  p += hidden;
  a.cq = p;
  p += hidden;
  a.up = p;
  p += ffn;
  a.part_ml = p;
  p += (size_t)heads * pages * 2;
  a.part_acc = p;
  p += (size_t)heads * pages * HEAD_D;
  a.bar = reinterpret_cast<unsigned int*>(p);
  a.ready = a.bar + BAR_WORDS;
  a.ready_cross = a.ready + heads;
  a.arrivals = a.ready_cross + heads;
  a.n_layers = n_layers;
  a.hidden = hidden;
  a.ffn = ffn;
  a.heads = heads;
  a.ctx = ctx;
  a.tc = tc;
  a.use_cross = use_cross;
  a.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return cache_bf16 ? dispatch<__nv_bfloat16>(a, qtype, packed, s, grid)
                    : dispatch<float>(a, qtype, packed, s, grid);
}
