// The GEMV phases of the persistent decode steps, each one cooperative
// launch whose phases a grid barrier separates: K10 (dia_flat.cu, the Dia
// CFG pair's two rows), K8 / K6 (llama_flat.cu, one Orpheus row) and K9 /
// K7's layer stack (llama_flat_batched.cu, up to 8 Orpheus slots). A
// phase runs gemv.cuh's per-item device code (the weight stream, the mma
// over a stage, the RMS sums, the epilogues), so that each output has the
// launch sequence's order of sums:
//  * k_split(K) warps of one block take the K ranges of one tile (2 up to
//    K 4096, 4 past it), and the first adds the others' sums in range
//    order through shared memory, the order in which the launch
//    sequence's cluster rank 0 adds its ranks'. Tiles spread over the
//    blocks first.
//  * A block stages all of K of the rows (its warps hold every range of
//    their tiles) by the same operations, so the staged bf16 values are
//    the launch sequence's: with an RMS prologue the rows and the norm
//    weights are copied to shared memory as f32 in one round of loads, the
//    sums taken there per (row, K range) warp in the cluster's lane order,
//    the ranges added in order, then the rows normalized from there.
//  * Weights are never written during a launch, so a warp issues the ring
//    stages of its items in the next GEMV phase as soon as it is done with
//    the current one, before the barrier (gemv_begin; the counterpart of
//    the copies gemv.cuh issues before griddepcontrol.wait). The stream
//    runs on across a warp's items, so the ring stays full from one tile
//    to the next.
#pragma once

#include <map>
#include <mutex>
#include <utility>

#include "gemv.cuh"

namespace {

constexpr int FLAT_NT = 1;          // one n-tile of 8 input rows holds a step's rows
constexpr int STAGE_BATCH = 8;      // float4 loads in flight a thread
constexpr int PREFETCH_CHUNK = 16384;   // bytes of one L2 prefetch

// One GEMV phase: out = epilogue(RMS?(x) @ dequant(W)^T) for the step's
// rows; codes / scales the phase's tiles (ops/llama_megastep.py gemv_tile).
struct Gemv {
  const uint8_t* codes;
  const uint8_t* scales;
  const float* x;
  const float* norm_w;       // null: no RMS prologue
  int P, N, K, epi;
  const float* res;
  float* out;
  RopeArgs ra;
};

// A block's dynamic shared memory: this warp's ring, the double-buffered
// range sums (a float4 a lane a warp), the f32 copies of the rows and the
// norm weights for an RMS prologue, and the rows staged as bf16.
struct Smem {
  uint8_t* ring;
  float4* slots;
  float4* raw;
  uint8_t* xs;
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// This warp's part of a GEMV phase: warps w .. w + ks - 1 (w = j ks) of
// block b take the ks K ranges of tiles j B + b, j B + b + S, ... (B blocks,
// S = B * WARPS / ks slots), so the tiles spread over the blocks first.
// Sets up the warp's weight stream and issues its first STAGES stages
// (weights are never written in the launch: this may run before the
// barrier that ends the phase before).
template <bool PACKED, bool SBF16, int STAGES>
__device__ __forceinline__ void gemv_begin(WeightStream<PACKED, SBF16>& ws,
                                           const Gemv& gv, uint8_t* ring,
                                           int warp, int lane) {
  using S = Stage<PACKED, SBF16>;
  const int ks = k_split(gv.K), tpb = WARPS / ks;
  const int tiles = (gv.P + TILE_PAIRS - 1) / TILE_PAIRS;
  const int slots = gridDim.x * tpb, first = (warp / ks) * gridDim.x + blockIdx.x;
  const int n_items = first < tiles ? (tiles - 1 - first) / slots + 1 : 0;
  const int stages = gv.K / UNIT_K, per_item = stages / ks;
  ws.init(gv.codes, gv.scales, first, slots, n_items, per_item, stages,
          (warp % ks) * per_item);
#pragma unroll
  for (int f = 0; f < STAGES; ++f) ws.next(ring + f * S::BYTES, lane);
}

// The warp's items of a GEMV phase over `rows` staged input rows (the
// staging done, after a block barrier): each tile's ranges added in order
// by its first warp (partial sums double-buffered in shared memory, the ks
// warps of a tile meeting at a named barrier), then the epilogue.
template <int QT, bool PACKED, bool SBF16, int STAGES>
__device__ __forceinline__ void gemv_items(WeightStream<PACKED, SBF16>& ws,
                                           const Gemv& gv, const Smem& sm,
                                           int rows) {
  using S = Stage<PACKED, SBF16>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ks = k_split(gv.K), range = warp % ks;
  const int xstride = xs_stride(gv.K);
  int u = 0;   // the stage being computed, counted over the items
#pragma unroll 1
  for (int item = 0; item < ws.n_items; ++item) {
    float acc[FLAT_NT][4] = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
    for (int s = 0; s < ws.per_item; ++s, ++u) {
      cp_async_wait<STAGES - 1>();
      __syncwarp();
      uint8_t* st = sm.ring + (u % STAGES) * S::BYTES;
      stage_mma<QT, PACKED, SBF16, FLAT_NT>(st, sm.xs, xstride, rows,
                                            (ws.first_stage + s) * UNIT_K, g, t, acc);
      __syncwarp();   // every lane is done with the stage before it is refilled
      ws.next(st, lane);
    }
    if (ks > 1) {   // the tile's range sums meet in its first warp, in order
      float4* buf = sm.slots + (item & 1) * WARPS * 32;
      if (range != 0) {
        buf[warp * 32 + lane] = make_float4(acc[0][0], acc[0][1], acc[0][2], acc[0][3]);
      }
      named_sync(1 + warp / ks, 32 * ks);
      if (range == 0) {
        for (int q = 1; q < ks; ++q) {
          const float4 v = buf[(warp + q) * 32 + lane];
          acc[0][0] += v.x;
          acc[0][1] += v.y;
          acc[0][2] += v.z;
          acc[0][3] += v.w;
        }
      }
    }
    if (range == 0) {
      tile_epilogue<FLAT_NT>(acc, (ws.first + ws.stride * item) * TILE_PAIRS + g,
                             gv.P, t, rows, gv.epi, gv.N, gv.res, gv.out, gv.ra);
    }
  }
  cp_async_wait<0>();
}

// Whether this block has a tile in the phase.
__device__ __forceinline__ bool has_tile(const Gemv& gv) {
  return (int)blockIdx.x < (gv.P + TILE_PAIRS - 1) / TILE_PAIRS;
}

// The rest of a GEMV phase over ROWS input rows, after gemv_begin and the
// barrier: the staging of the rows (every block with a tile), then the
// warp's items (gemv_items).
template <int QT, bool PACKED, bool SBF16, int ROWS, int STAGES>
__device__ __forceinline__ void gemv_run(WeightStream<PACKED, SBF16>& ws,
                                         const Gemv& gv, const Smem& sm,
                                         double (*rms_part)[MAX_ROWS],
                                         float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = gv.K, ks = k_split(K), kr = K / ks;
  if (!has_tile(gv)) {
    cp_async_wait<0>();   // no tile in this block
    return;
  }
  uint8_t* xs = sm.xs;
  float4* raw = sm.raw;
  const int xstride = xs_stride(K);
  const int n4 = ROWS * K / 4, per_row = K / 4;
  const float4* x4 = reinterpret_cast<const float4*>(gv.x);
  if (gv.norm_w != nullptr) {
    const float4* w4 = reinterpret_cast<const float4*>(gv.norm_w);
    for (int base = threadIdx.x; base < n4 + per_row; base += STAGE_BATCH * THREADS) {
      float4 v[STAGE_BATCH];
#pragma unroll
      for (int j = 0; j < STAGE_BATCH; ++j) {
        const int idx = base + j * THREADS;
        if (idx < n4 + per_row) v[j] = idx < n4 ? x4[idx] : w4[idx - n4];
      }
#pragma unroll
      for (int j = 0; j < STAGE_BATCH; ++j) {
        const int idx = base + j * THREADS;
        if (idx < n4 + per_row) raw[idx] = v[j];
      }
    }
    __syncthreads();
    const float* rawf = reinterpret_cast<const float*>(raw);
    for (int c = warp; c < ROWS * ks; c += WARPS) {   // (row, range) a warp
      const int r = c / ks, q = c % ks;
      const double s = rms_sum(rawf + (size_t)r * K + q * kr, kr / 4, lane);
      if (lane == 0) rms_part[q][r] = s;
    }
    __syncthreads();
    if (threadIdx.x < ROWS) {
      rstd[threadIdx.x] = rms_rstd(&rms_part[0][threadIdx.x], MAX_ROWS, ks, K);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < n4; idx += THREADS) {
      const int r = idx / per_row, i = idx - r * per_row;
      reinterpret_cast<uint2*>(xs + (size_t)r * xstride)[i] =
          pack4(norm4(raw[idx], raw[n4 + i], rstd[r]));
    }
  } else {
    for (int base = threadIdx.x; base < n4; base += STAGE_BATCH * THREADS) {
      float4 v[STAGE_BATCH];
#pragma unroll
      for (int j = 0; j < STAGE_BATCH; ++j) {
        if (base + j * THREADS < n4) v[j] = x4[base + j * THREADS];
      }
#pragma unroll
      for (int j = 0; j < STAGE_BATCH; ++j) {
        const int idx = base + j * THREADS;
        if (idx < n4) {
          const int r = idx / per_row, i = idx - r * per_row;
          reinterpret_cast<uint2*>(xs + (size_t)r * xstride)[i] = pack4(v[j]);
        }
      }
    }
  }
  __syncthreads();
  gemv_items<QT, PACKED, SBF16, STAGES>(ws, gv, sm, ROWS);
}

// gemv_run for `rows` input rows without the f32 copy of the rows in shared
// memory (the batched llama step, whose 8 rows at K 8192 leave it no room):
// the RMS sums taken from loads of x in device memory, a warp a (row, K
// range) in rms_sum's lane order, the ranges added in order, then each
// element loaded again, normalized and staged: the same operations on the
// same values as gemv_run's, so the same bf16 rows.
template <int QT, bool PACKED, bool SBF16, int STAGES>
__device__ __forceinline__ void gemv_run_rows(WeightStream<PACKED, SBF16>& ws,
                                              const Gemv& gv, const Smem& sm,
                                              int rows,
                                              double (*rms_part)[MAX_ROWS],
                                              float* rstd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int K = gv.K, ks = k_split(K), kr = K / ks;
  if (!has_tile(gv)) {
    cp_async_wait<0>();   // no tile in this block
    return;
  }
  const int xstride = xs_stride(K);
  const int n4 = rows * K / 4, per_row = K / 4;
  const float4* x4 = reinterpret_cast<const float4*>(gv.x);
  const float4* w4 = reinterpret_cast<const float4*>(gv.norm_w);
  if (gv.norm_w != nullptr) {
    for (int c = warp; c < rows * ks; c += WARPS) {   // (row, range) a warp
      const int r = c / ks, q = c % ks;
      const double s = rms_sum(gv.x + (size_t)r * K + q * kr, kr / 4, lane);
      if (lane == 0) rms_part[q][r] = s;
    }
    __syncthreads();
    if (threadIdx.x < rows) {
      rstd[threadIdx.x] = rms_rstd(&rms_part[0][threadIdx.x], MAX_ROWS, ks, K);
    }
    __syncthreads();
  }
  for (int base = threadIdx.x; base < n4; base += STAGE_BATCH * THREADS) {
    float4 v[STAGE_BATCH];
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      if (base + j * THREADS < n4) v[j] = x4[base + j * THREADS];
    }
#pragma unroll
    for (int j = 0; j < STAGE_BATCH; ++j) {
      const int idx = base + j * THREADS;
      if (idx < n4) {
        const int r = idx / per_row, i = idx - r * per_row;
        const float4 y = w4 != nullptr ? norm4(v[j], w4[i], rstd[r]) : v[j];
        reinterpret_cast<uint2*>(sm.xs + (size_t)r * xstride)[i] = pack4(y);
      }
    }
  }
  __syncthreads();
  gemv_items<QT, PACKED, SBF16, STAGES>(ws, gv, sm, rows);
}

// An L2 prefetch of n_runs runs of `bytes` each (16-byte multiples, 16-byte
// aligned), run i at base + i * stride elements of T, in PREFETCH_CHUNK
// pieces spread over the lanes of every block's last warp.
template <typename T>
__device__ __forceinline__ void prefetch_l2(const T* base, long long stride,
                                            int n_runs, long long bytes) {
  if (threadIdx.x / 32 != WARPS - 1) return;
  const long long per_run = (bytes + PREFETCH_CHUNK - 1) / PREFETCH_CHUNK;
  for (long long c = blockIdx.x * 32LL + threadIdx.x % 32; c < n_runs * per_run;
       c += gridDim.x * 32LL) {
    const long long off = (c % per_run) * PREFETCH_CHUNK;
    const unsigned n = (unsigned)(bytes - off < PREFETCH_CHUNK ? bytes - off : PREFETCH_CHUNK);
    const uint8_t* p = reinterpret_cast<const uint8_t*>(base + (c / per_run) * stride) + off;
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p), "r"(n) : "memory");
  }
}

// Blocks of `kern` an SM holds with `smem` bytes, asked of the CUDA runtime
// once per (kernel, smem): a negative CUDA error where it refuses. The
// kernel's opt-in to dynamic shared memory only ever rises, to the largest
// size asked for: one kernel serves models of several widths (the llama
// step takes heads of 64 and 128 at run time), and a launch whose size
// exceeded the opt-in would be refused as too large to be resident.
inline int blocks_per_sm(const void* kern, int smem) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> known;
  static std::map<const void*, int> opted;
  std::lock_guard<std::mutex> lock(mu);
  int& top = opted[kern];
  cudaError_t e;
  if (smem > top) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return -(int)e;
    top = smem;
  }
  const auto key = std::make_pair(kern, smem);
  auto it = known.find(key);
  if (it != known.end()) return it->second;
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, smem);
  if (e != cudaSuccess) return -(int)e;
  known[key] = n;
  return n;
}

// One cooperative launch of `kern` (a persistent step) with its argument
// struct: a grid of the SMs x the blocks an SM holds. A grid that cannot
// be resident at once is refused (cudaErrorCooperativeLaunchTooLarge): the
// step never runs partly.
template <typename Args>
int launch_cooperative(const void* kern, Args a, int smem, cudaStream_t s,
                       int* grid_out, int* per_sm_out) {
  const int per_sm = blocks_per_sm(kern, smem);
  if (per_sm < 0) return -per_sm;
  if (per_sm == 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = sm_count() * per_sm;
  if (grid_out) *grid_out = grid;
  if (per_sm_out) *per_sm_out = per_sm;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(kern, dim3(grid), dim3(THREADS),
                                                    args, smem, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace
