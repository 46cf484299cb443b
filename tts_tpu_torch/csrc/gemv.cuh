// The block-dequant GEMV of the llama-family decode steps (K6-K9, and the
// Dia steps K10/K11): x (B, K) @ dequant(W)^T for 1 <= B <= 16 input rows,
// with the RMS norm fused as a prologue and the step's epilogues fused
// after it (RoPE + KV-row write, SiLU(gate) * up, residual add, store).
// Each source that launches it (llama_megastep.cu, dia_megastep.cu)
// instantiates the types and n-tile counts it needs, so the sources build
// in parallel. Its per-item device code (WeightStream, stage_mma, rms_sum /
// rms_rstd / norm4 / pack4, tile_epilogue) also runs inside the persistent
// Dia step (dia_flat.cu), so that a row's sums have one order on both. The
// design notes are in llama_megastep.cu's header; the stage layout, its copier and the dequantization into A fragments are
// gemv_tiles.cuh's, shared with the Parler GEMV (parler_gemv.cuh).
//
// In short: the products run on the tensor cores (mma.sync m16n8k16, bf16
// in, f32 out). A warp's M tile is 16 weight rows, the two rows of 8
// feature pairs (rows 0-7 the pairs' "a" rows, 8-15 their "b" rows), so the
// D fragment hands each thread both features of pair lane / 4 for input
// rows 2 (lane % 4) and + 1, and every epilogue stays in registers. The
// input rows are the B operand (one n-tile of 8 rows, two for 9-16 rows),
// staged once per block as bf16 in shared memory. The weights, tiled at
// prep so that a warp's stages are contiguous runs, stream through a ring
// of shared-memory stages per warp, fed by 16-byte cp.async copies, and
// are dequantized straight into A fragments. K is split over
// the blocks of a cluster (2, or 4 past K 4096), each staging only its
// part of the rows; the blocks' partial sums meet in rank 0's shared
// memory. The launch uses programmatic dependent launch: a block issues
// its first weight copies, then waits for the kernel before it.
#pragma once

#include <map>
#include <mutex>
#include <utility>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gemv_tiles.cuh"

namespace {

using namespace tts;
namespace cg = cooperative_groups;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_PAIRS = 8;        // feature pairs of a warp's M tile (16 rows)
constexpr int NBUF = 2;              // partial-sum slots a warp has in rank 0
constexpr int MAX_KS = 4;
constexpr int MAX_ROWS = 16;
constexpr float RMS_EPS = 1e-5f;
// Blocks of one launch an SM may hold at most. A launch takes the second
// only where its (tile, K range) items are at least twice the warps of one
// block an SM (the LM head): there 16 warps an SM hide each other's
// latency; a smaller launch runs faster on one (gemv_ab, PERF.md).
constexpr int MAX_BLOCKS_PER_SM = 2;
// Dynamic shared memory a block may have: the H100's 227 KB, less the
// static shared memory below (under 1 KB).
constexpr int SMEM_LIMIT = 226 * 1024;

enum Epi { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_SILU_MUL = 2, EPI_ROPE_QKV = 3 };

// What the RoPE + KV-row epilogue reads: the inverse frequencies (d/2), the
// position of row r at pos[r * pos_stride], and this layer's cache, row r's
// (n_kv, ctx, d) at kc/vc + r * bstride elements. q occupies features
// [0, hidden), k [hidden, hidden + kvh), v [hidden + kvh, hidden + 2 kvh).
struct RopeArgs {
  const float* inv;
  const int* pos;
  int pos_stride;
  void* kc;
  void* vc;
  int hidden, kvh, d, ctx, bf16;
  long long bstride;
};

// Blocks of a cluster, each taking K / k_split(K) of every row: fixed by K
// alone, so a row's sum has one order whatever B is.
__host__ __device__ constexpr int k_split(int K) { return K > 4096 ? 4 : 2; }

// Ring stages a warp keeps: about 7 KB in flight a warp at one n-tile,
// 4.5 KB at two (whose input rows take twice the room).
template <bool PACKED, bool SBF16, int NT>
__host__ __device__ constexpr int ring_stages() {
  const int s = (NT == 1 ? 7168 : 4608) / Stage<PACKED, SBF16>::BYTES;
  return s < 2 ? 2 : s;
}

template <bool PACKED, bool SBF16, int NT>
inline int smem_bytes(int ks, int B, int K) {
  return WARPS * ring_stages<PACKED, SBF16, NT>() * Stage<PACKED, SBF16>::BYTES +
         (ks - 1) * WARPS * NBUF * NT * 32 * 16 + B * xs_stride(K / ks);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Arrive on `bar` of cluster block `rank` (this block's own too), with
// release at cluster scope: this thread's earlier stores and loads are
// ordered before the arrival.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, int rank) {
  asm volatile(
      "{\n\t.reg .b32 ra;\n\t"
      "mapa.shared::cluster.u32 ra, %0, %1;\n\t"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n\t}\n" ::"r"(
          smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// Wait for the phase of parity `parity` of this block's `bar` to complete,
// with acquire at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// Epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_cache(void* cache, size_t idx, float v,
                                            int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(cache)[idx] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(cache)[idx] = v;
  }
}

// The two output features of pair p, the rows its tile holds (gemv_tile's
// pairing: see llama_megastep.cu's header).
__device__ __forceinline__ void pair_rows(int p, int epi, const RopeArgs& ra,
                                          int& row_a, int& row_b) {
  if (epi == EPI_ROPE_QKV) {
    const int h2 = ra.d / 2;
    row_a = (p / h2) * ra.d + p % h2;
    row_b = row_a + h2;
  } else if (epi == EPI_SILU_MUL) {
    row_a = p;
    row_b = p;
  } else {
    row_a = 2 * p;
    row_b = 2 * p + 1;
  }
}

// Input row `row`'s outputs of pair p: va of its "a" weight row, vb of "b".
__device__ __forceinline__ void epilogue(int epi, int p, int row, float va,
                                         float vb, int N, const float* res,
                                         float* out, const RopeArgs& ra) {
  int row_a, row_b;
  pair_rows(p, epi, ra, row_a, row_b);
  float* o = out + (size_t)row * N;
  if (epi == EPI_SILU_MUL) {
    o[p] = va / (1.f + expf(-va)) * vb;
  } else if (epi == EPI_RESIDUAL) {
    const float* rs = res + (size_t)row * N;
    o[row_a] = rs[row_a] + va;
    o[row_b] = rs[row_b] + vb;
  } else if (epi == EPI_STORE) {
    o[row_a] = va;
    o[row_b] = vb;
  } else {  // EPI_ROPE_QKV
    const int h2 = ra.d / 2;
    const int pr = ra.pos[row * ra.pos_stride];
    float ya = va, yb = vb;
    if (row_a < ra.hidden + ra.kvh) {  // q and k rotate, v does not
      const float ang = (float)pr * ra.inv[p % h2];
      const float c = cosf(ang), s = sinf(ang);
      ya = va * c - vb * s;
      yb = vb * c + va * s;
    }
    o[row_a] = ya;
    o[row_b] = yb;
    if (row_a >= ra.hidden) {
      const bool is_v = row_a >= ra.hidden + ra.kvh;
      const int j = row_a - ra.hidden - (is_v ? ra.kvh : 0);
      const int crow = min(pr, ra.ctx - 1);
      const size_t idx = (size_t)row * ra.bstride +
                         ((size_t)(j / ra.d) * ra.ctx + crow) * ra.d + j % ra.d;
      void* cache = is_v ? ra.vc : ra.kc;
      store_cache(cache, idx, ya, ra.bf16);
      store_cache(cache, idx + h2, yb, ra.bf16);
    }
  }
}

// The outputs of the tile's pairs to thread (g, t): pair p = the tile's
// first pair + g, features of input rows n * 8 + 2 t + h (acc[n][h] its "a"
// row, acc[n][2 + h] its "b" row), through the epilogue.
template <int NT>
__device__ __forceinline__ void tile_epilogue(float acc[NT][4], int p,
                                              int P, int t, int B, int epi,
                                              int N, const float* res,
                                              float* out, const RopeArgs& ra) {
  if (p >= P) return;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = n * 8 + 2 * t + h;
      if (row < B) epilogue(epi, p, row, acc[n][h], acc[n][2 + h], N, res, out, ra);
    }
  }
}

// ---------------------------------------------------------------------------
// One (tile, K range) item, shared by the cluster kernel below and the
// persistent Dia step (dia_flat.cu), so that a row's sums run in one order
// on both
// ---------------------------------------------------------------------------

// A warp's weight stream: the K range [first_stage, first_stage +
// per_item) of tiles first, first + stride, ... (n_items of them), stage
// after stage, each copied into a ring slot as one commit group.
template <bool PACKED, bool SBF16>
struct WeightStream {
  Copier<PACKED, SBF16> cp;
  const uint8_t* codes;
  const void* scales;
  int first, stride, n_items, per_item, stages, first_stage;
  int c_item, c_stage;   // the next stage to copy

  __device__ __forceinline__ void init(const uint8_t* codes_t, const void* scales_t,
                                       int first_tile, int tile_stride, int items,
                                       int item_stages, int tile_stages,
                                       int range_stage) {
    codes = codes_t;
    scales = scales_t;
    first = first_tile;
    stride = tile_stride;
    n_items = items;
    per_item = item_stages;
    stages = tile_stages;
    first_stage = range_stage;
    c_item = c_stage = 0;
    if (n_items > 0) cp.set_tile(first, codes, scales, stages, first_stage);
  }

  // The copies of the next stage (if any) into st; always one commit group,
  // so that cp_async_wait counts stages.
  __device__ __forceinline__ void next(uint8_t* st, int lane) {
    if (c_item < n_items) {
      cp.issue(st, c_stage, lane);
      if (++c_stage == per_item) {
        c_stage = 0;
        if (++c_item < n_items) {
          cp.set_tile(first + stride * c_item, codes, scales, stages, first_stage);
        }
      }
    }
    cp_async_commit();
  }
};

// One ring stage's products into acc: its UNIT_BLOCKS 32-weight blocks in
// order, each block's two mma products summed apart (d) and then added into
// the f32 sums. The staged input rows (bf16, xstride bytes apart, groups of
// 4 in the order 0, 2, 1, 3) are read at element kl of the staged K.
template <int QT, bool PACKED, bool SBF16, int NT>
__device__ __forceinline__ void stage_mma(const uint8_t* st, const uint8_t* xs,
                                          int xstride, int B, int kl, int g,
                                          int t, float acc[NT][4]) {
#pragma unroll
  for (int jb = 0; jb < UNIT_BLOCKS; ++jb) {
    uint32_t a[2][4];
    a_frags<QT, PACKED, SBF16>(st, jb, g, t, a);
    float d[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + g;
        uint2 b = make_uint2(0u, 0u);
        if (col < B) {
          b = *reinterpret_cast<const uint2*>(
              xs + (size_t)col * xstride + (kl + jb * QK + 16 * s + 4 * t) * 2);
        }
        mma_bf16(d[n], a[s], b.x, b.y);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[n][i] += d[n][i];
    }
  }
}

// The RMS prologue follows the plain version's operations, so that its
// rstd agrees with the plain version's (each disagreement may flip the
// bf16 rounding of an input): the squares rounded to f32, their sum in
// f64 (one warp per row and K range, lane l taking float4s l, l + 32, ...
// in order, then the lanes (rms_sum), then the ranges in order) rounded
// once to f32, times 1 / K, plus eps, rsqrtf (rms_rstd), then x * rstd * w
// (norm4).
__device__ __forceinline__ double rms_sum(const float* xr, int n4, int lane) {
  double ss = 0.0;
  const float4* v4 = reinterpret_cast<const float4*>(xr);
#pragma unroll 4
  for (int j = lane; j < n4; j += 32) {
    const float4 v = v4[j];
    ss += (double)__fmul_rn(v.x, v.x) + (double)__fmul_rn(v.y, v.y) +
          (double)__fmul_rn(v.z, v.z) + (double)__fmul_rn(v.w, v.w);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  return ss;
}

// parts[q * stride] is range q's sum.
__device__ __forceinline__ float rms_rstd(const double* parts, int stride,
                                          int ks, int K) {
  double s = 0.0;
  for (int q = 0; q < ks; ++q) s += parts[q * stride];
  const float mean = __fmul_rn((float)s, 1.f / (float)K);
  return rsqrtf(__fadd_rn(mean, RMS_EPS));
}

// Four input elements normalized: x * rstd * w, each product rounded.
__device__ __forceinline__ float4 norm4(float4 v, float4 w, float rs) {
  return make_float4(__fmul_rn(__fmul_rn(v.x, rs), w.x), __fmul_rn(__fmul_rn(v.y, rs), w.y),
                     __fmul_rn(__fmul_rn(v.z, rs), w.z), __fmul_rn(__fmul_rn(v.w, rs), w.w));
}

// Four input elements as two bf16x2 words in the order 0, 2, 1, 3.
__device__ __forceinline__ uint2 pack4(float4 v) {
  return make_uint2(pack_bf16x2(v.x, v.z), pack_bf16x2(v.y, v.w));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// A grid of clusters of ks = k_split(K) blocks of 8 warps, one block an SM
// (two for the LM head's launch). Block rank r of a cluster takes K range
// [r K / ks, (r + 1) K / ks) of every row. Warp w of cluster c walks tiles c + C (w + 8 j) (C
// clusters): tiles spread over the clusters first. For each tile, the warp
// streams its range through its ring (stage u + STAGES is copied while
// stage u is computed; the first copies are issued before the wait for the
// kernel before), sums each 32-weight block's two mma products apart and
// adds them into its f32 accumulators in block order, then ships them to
// warp w of rank 0 (remote stores into rank 0's slot, an mbarrier arrive
// with release at cluster scope), which adds the ranks' sums in rank order
// and applies the epilogue. out (B, N). norm_w null: no RMS prologue. x is
// not __restrict__: the kernel before may have written it, so it is read
// through the coherent path, after griddepcontrol.wait.
template <int QT, bool PACKED, bool SBF16, int NT>
__global__ void __launch_bounds__(THREADS, 2)
llama_gemv_kernel(const float* x, const float* __restrict__ norm_w,
                  const uint8_t* __restrict__ codes, const void* __restrict__ scales,
                  int B, int P, int N, int K, int epi, const float* res,
                  float* out, RopeArgs ra) {
  using S = Stage<PACKED, SBF16>;
  constexpr int STAGES = ring_stages<PACKED, SBF16, NT>();
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ double rms_part[MAX_KS][MAX_ROWS];
  __shared__ float rstd[MAX_ROWS];
  __shared__ __align__(8) uint64_t full[WARPS][NBUF];
  __shared__ __align__(8) uint64_t empty[WARPS][NBUF];

  cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / ks, ncl = gridDim.x / ks;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int nb = K / QK, kr = K / ks;
  const int per_item = kr / UNIT_K;   // stages of one tile
  const int tiles = (P + TILE_PAIRS - 1) / TILE_PAIRS;
  const int first = cid + ncl * warp, stride = ncl * WARPS;
  const int n_items = first < tiles ? (tiles - 1 - first) / stride + 1 : 0;
  const int n_units = n_items * per_item;
  uint8_t* ring = smem + warp * STAGES * S::BYTES;
  float4* slots = reinterpret_cast<float4*>(smem + WARPS * STAGES * S::BYTES);
  const int xstride = xs_stride(kr);
  uint8_t* xs = smem + WARPS * STAGES * S::BYTES + (ks - 1) * WARPS * NBUF * NT * 512;

  if (threadIdx.x < WARPS * NBUF) {
    mbar_init(&full[0][0] + threadIdx.x, 32 * (ks - 1));
    mbar_init(&empty[0][0] + threadIdx.x, 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  cluster_arrive();   // waited on before the first access to another block

  // the first stages' weight copies: weights are never written by a kernel
  WeightStream<PACKED, SBF16> ws;
  ws.init(codes, scales, first, stride, n_items, per_item, nb / UNIT_BLOCKS,
          rank * per_item);
#pragma unroll
  for (int f = 0; f < STAGES; ++f) ws.next(ring + f * S::BYTES, lane);

  // Nothing before this point reads what a kernel before writes, or writes
  // anything in device memory.
  launch_dependents();
  grid_dependency_wait();

  // The input rows, this rank's K range, as bf16 (RMS-normalized first,
  // rms_sum / rms_rstd / norm4; the ranges are the cluster's ranks).
  const float* xk = x + (size_t)rank * kr;
  if (norm_w != nullptr) {
    double ss[MAX_ROWS / WARPS];
#pragma unroll
    for (int i = 0; i < MAX_ROWS / WARPS; ++i) {
      const int r = warp + WARPS * i;
      ss[i] = r < B ? rms_sum(xk + (size_t)r * K, kr / 4, lane) : 0.0;
    }
    cluster_wait();     // every block has started: its shared memory is ours to write
#pragma unroll
    for (int i = 0; i < MAX_ROWS / WARPS; ++i) {
      const int r = warp + WARPS * i;
      if (r < B && lane < ks) *cluster.map_shared_rank(&rms_part[rank][r], lane) = ss[i];
    }
    cluster_arrive();
    cluster_wait();     // every block's sums have landed
    if (threadIdx.x < B) {
      rstd[threadIdx.x] = rms_rstd(&rms_part[0][threadIdx.x], MAX_ROWS, ks, K);
    }
    __syncthreads();
  } else {
    cluster_wait();
  }
  // the B rows' float4s over the block's threads, 8 loads in flight a thread
  const float* nw = norm_w != nullptr ? norm_w + (size_t)rank * kr : nullptr;
  const int per_row = kr / 4;
#pragma unroll 8
  for (int idx = threadIdx.x; idx < B * per_row; idx += THREADS) {
    const int r = idx / per_row, i = idx - r * per_row;
    float4 v = reinterpret_cast<const float4*>(xk + (size_t)r * K)[i];
    if (nw != nullptr) v = norm4(v, reinterpret_cast<const float4*>(nw)[i], rstd[r]);
    reinterpret_cast<uint2*>(xs + (size_t)r * xstride)[i] = pack4(v);
  }
  __syncthreads();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  int item = 0, stage = 0;   // the stage being computed
#pragma unroll 1
  for (int u = 0; u < n_units; ++u) {
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    uint8_t* st = ring + (u % STAGES) * S::BYTES;
    stage_mma<QT, PACKED, SBF16, NT>(st, xs, xstride, B, stage * UNIT_K, g, t, acc);
    __syncwarp();   // every lane is done with the stage before it is refilled
    ws.next(st, lane);
    if (++stage < per_item) continue;

    // the tile's last stage: the ranks' sums meet in rank 0
    const int buf = item % NBUF, use = item / NBUF;
    float4* slot = slots + ((warp * NBUF + buf) * (ks - 1)) * NT * 32;
    if (rank != 0) {
      if (item >= NBUF) mbar_wait_cluster(&empty[warp][buf], (use - 1) & 1);
      float4* dst = cluster.map_shared_rank(slot + (rank - 1) * NT * 32, 0);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        dst[n * 32 + lane] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
      }
      mbar_arrive_cluster(&full[warp][buf], 0);
    } else {
      mbar_wait_cluster(&full[warp][buf], use & 1);
      for (int q = 1; q < ks; ++q) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 v = slot[((q - 1) * NT + n) * 32 + lane];
          acc[n][0] += v.x;
          acc[n][1] += v.y;
          acc[n][2] += v.z;
          acc[n][3] += v.w;
        }
      }
      if (item + NBUF < n_items) {
        for (int q = 1; q < ks; ++q) mbar_arrive_cluster(&empty[warp][buf], q);
      }
      tile_epilogue<NT>(acc, (first + stride * item) * TILE_PAIRS + g, P, t, B,
                        epi, N, res, out, ra);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    stage = 0;
    ++item;
  }
  cp_async_wait<0>();
}

// Clusters of ks blocks that can be resident at once with `smem` bytes a
// block, at most `per_sm` blocks an SM, asked of the driver once per
// (kernel, ks, smem, per_sm).
inline int max_clusters(const void* kern, int ks, int smem, int per_sm) {
  static std::mutex mu;
  static std::map<std::pair<const void*, long long>, int> known;
  const auto key = std::make_pair(kern, (long long)(ks * 4 + per_sm) << 32 | smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it != known.end()) return it->second;
  const int sms = sm_count();
  int n = 0;
  cudaLaunchConfig_t cfg = {};
  const int cap = per_sm * sms / ks > 0 ? per_sm * sms / ks : 1;
  cfg.gridDim = dim3(ks * cap);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = ks;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess || n < 1) {
    cudaGetLastError();
    n = 1;
  }
  if (n > cap) n = cap;
  known[key] = n;
  return n;
}

template <int QT, bool PACKED, bool SBF16, int NT>
int launch_one(const float* x, const float* norm_w, const uint8_t* codes,
               const void* scales, int B, int P, int N, int K, int epi,
               const float* res, float* out, RopeArgs ra, cudaStream_t s) {
  auto kern = llama_gemv_kernel<QT, PACKED, SBF16, NT>;
  const int ks = k_split(K);
  if (K % (ks * UNIT_K)) return (int)cudaErrorInvalidValue;
  // 16-byte copies and loads
  if ((size_t)codes % 16 || (size_t)scales % 16 || (size_t)x % 16 ||
      (norm_w && (size_t)norm_w % 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = smem_bytes<PACKED, SBF16, NT>(ks, B, K);
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
  const int tiles = (P + TILE_PAIRS - 1) / TILE_PAIRS;
  const int per_sm = (long long)tiles * ks >= 2LL * WARPS * sm_count()
                         ? MAX_BLOCKS_PER_SM : 1;
  const int mc = max_clusters(reinterpret_cast<const void*>(kern), ks, smem, per_sm);
  const int clusters = tiles < mc ? tiles : mc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * ks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = ks;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, x, norm_w, codes, scales,
                                           B, P, N, K, epi, res, out, ra);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
