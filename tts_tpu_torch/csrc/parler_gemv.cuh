// The Parler decode step's GEMV, shared by the launch sequence of K2 / K5
// (parler_megastep.cu, one launch per projection: `gemv`) and the
// persistent K12 (parler_flat.cu, every projection of the step inside one
// launch: `gemv_begin` / `gemv_run`, the same work split where K12 issues
// the next phase's weights early). Both run the same staging, products,
// range sums and epilogues in the same order, so a feature's sum is the
// same on either route and K12 equals K2 bit for bit.
//
// out (B, N) = epilogue(LN?(x) @ dequant(W)^T) for 1 <= B <= 16 input rows:
//  * Tensor cores. A warp's tile is 16 weight rows, the M operand of
//    mma.sync m16n8k16 (bf16 in, f32 out): the rows 2p and 2p + 1 of pairs
//    p = 8T..8T+7 (ops/llama_megastep.py gemv_tile, "pairs"), so that the
//    D fragment hands each thread features 2p and 2p + 1 of input rows 2
//    (lane % 4) and + 1 and every epilogue runs in registers, per feature.
//    The weights are dequantized straight into A fragments with the
//    `_dqdot` rounding (gemv_tiles.cuh). The input rows are the B operand:
//    one n-tile for 1-8 rows, two for 9-16.
//  * Rows staged once per block as bf16 (`stage_rows`), in padded rows
//    whose B-fragment loads fill the 32 banks without conflict: the layer
//    norm first where one precedes the projection (LN1 -> qkv, LNc ->
//    cross-q, LN2 -> fc1), by the plain version's operations in torch's
//    order on the card, else the input rounded once (the attention output
//    for o and co, the GELU output for fc2).
//  * The weight stream. Each warp keeps a ring of RING stages (4 blocks of
//    K of its 16 rows a stage, 1152 bytes for Q4_0) fed by 16-byte
//    cp.async copies, stage u + RING copied while stage u is computed,
//    across the warp's tiles. The first RING stages are issued by
//    gemv_begin, before anything the phase reads is ready: K2 / K5 before
//    griddepcontrol.wait, K12 as soon as a warp is done with the phase
//    before, ahead of the barrier or the attention between them.
//  * K split over the warps of one block. ks = k_split(K) warps share a
//    tile, each summing one contiguous K range of whole stages; the block
//    takes WARPS / ks tiles at a time, and each tile's ks partial sums
//    meet in shared memory, where its first warp adds them in range order
//    and applies the epilogue. No cluster: K12 is a cooperative launch,
//    and the split must run the same order there.
//
// One order for every row count: ks fixed by K alone, each range's stages
// and blocks in K order, each 32-weight block's two mma products summed
// apart and added into the f32 sums in block order, the ranges added in
// order, and each column of an mma summed apart from the others. So slot s
// of K5 equals K2 on slot s's state bit for bit, and a row has the same
// bits in every position of the mma's 16 columns.
#pragma once

#include "gemv_tiles.cuh"

namespace tts {
namespace parler {

constexpr int WARPS = 8;   // warps per block on every route
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ROWS = 16;
constexpr int TILE = 16;   // output features of a warp's tile
constexpr int RING = 4;    // ring stages a warp keeps
constexpr float LN_EPS = 1e-5f;
// Dynamic shared memory a block may have: the H100's 227 KB, less the
// static shared memory (under 1 KB).
constexpr int SMEM_LIMIT = 226 * 1024;

enum Epi { EPI_STORE = 0, EPI_RESIDUAL = 1, EPI_GELU = 2, EPI_QKV = 3 };

// Where the qkv epilogue writes the current token's k and v: slot r's
// cache of this layer, (heads, ctx, d) at kc/vc + r * bstride elements, row
// min(pos[r], ctx - 1).
struct CacheArgs {
  void* kc;
  void* vc;
  const int* pos;
  int hidden, d, ctx, bf16;
  long long bstride;
};

// Warps that share one tile's K, each taking a contiguous range of whole
// stages: the largest power of two up to WARPS that divides K / UNIT_K.
// Fixed by K alone, so a row's sum has one order whatever B and route.
__host__ __device__ constexpr int k_split(int K) {
  int ks = 1;
  while (ks < WARPS && (K / UNIT_K) % (2 * ks) == 0) ks *= 2;
  return ks;
}

// A block's dynamic shared memory: the warps' rings, the K-range partial
// sums (a float4 a lane a warp an n-tile), and the B staged rows.
template <bool PACKED, int NT>
__host__ __device__ inline int smem_bytes(int B, int K) {
  return WARPS * RING * Stage<PACKED, true>::BYTES + WARPS * NT * 32 * 16 +
         B * xs_stride(K);
}

__device__ __forceinline__ float gelu_tanh(float v) {
  return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
}

// The B input rows (B, K) as bf16 in xs, rows xstride bytes apart, each
// group of 4 elements in the order 0, 2, 1, 3 (a thread's B fragment is one
// 8-byte load), staged by all THREADS threads; returns after a block
// barrier. With LN each row is layer-normalized first by the plain
// version's operations as torch runs them on the card (ops/
// parler_megastep.py layer_norm), so that the normalized values are its
// values and no bf16 rounding flips between the two. Each mean is torch's
// one-row reduction of K > 128 floats: bw = min(last_pow2(K / 4), 512)
// threads, thread t adding float4s t, t + bw, ... into 4 lane sums, then
// the lanes in order; a tree v[t] += v[t + off] for off = bw / 2 .. 32;
// an xor butterfly over the last 32 (off = 16 .. 1); times 1 / K. The
// variance is that mean of the squares of x - mean, each rounded; rstd =
// rsqrtf(var + eps), as torch.rsqrt on the card; then ((x - mean) * rstd)
// * w + b, each operation rounded (no fused multiply-add), rounded to
// bf16.
// Without LN, x rounded to bf16 (the `_dqdot` rounding of an activation).
// x is read through plain loads: in K12 other blocks of the launch wrote it.
template <bool LN, int ROWS>
__device__ __forceinline__ void stage_rows(const float* x, const float* ln_w,
                                           const float* ln_b, int B, int K,
                                           uint8_t* xs, int xstride) {
  __shared__ float stat[2][ROWS];   // mean, rstd
  if constexpr (LN) {
    // One warp a row: lane l takes torch's threads t = l + 32 k (k < bw /
    // 32), whose sums it adds in registers in the tree's order.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nv = K / 4;
    int bw = 1;
    while (bw * 2 <= nv && bw < 512) bw *= 2;
    const int per = bw < 32 ? 1 : bw / 32, dw = bw < 32 ? bw : 32;
    const float inv_k = 1.f / (float)K;
    for (int r = warp; r < B; r += WARPS) {
      const float4* xr = reinterpret_cast<const float4*>(x + (size_t)r * K);
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {   // 0: the mean, 1: the variance
        const float mu = pass == 0 ? 0.f : stat[0][r];
        // the sums of the lane's threads, 8 at a time with their loads in
        // flight together; each thread's float4s in order
        float p[16];   // per <= 16
#pragma unroll
        for (int k0 = 0; k0 < 16; k0 += 8) {
          float4 l[8];
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) l[kk] = make_float4(0.f, 0.f, 0.f, 0.f);
          for (int m = 0; k0 < per && m * bw < nv; ++m) {
            float4 v[8];
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              const int jv = lane + 32 * (k0 + kk) + m * bw;
              if (k0 + kk < per && lane + 32 * (k0 + kk) < bw && jv < nv) v[kk] = xr[jv];
            }
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
              const int jv = lane + 32 * (k0 + kk) + m * bw;
              if (k0 + kk >= per || lane + 32 * (k0 + kk) >= bw || jv >= nv) continue;
              if (pass == 1) {
                v[kk].x = __fsub_rn(v[kk].x, mu);
                v[kk].y = __fsub_rn(v[kk].y, mu);
                v[kk].z = __fsub_rn(v[kk].z, mu);
                v[kk].w = __fsub_rn(v[kk].w, mu);
                v[kk].x = __fmul_rn(v[kk].x, v[kk].x);
                v[kk].y = __fmul_rn(v[kk].y, v[kk].y);
                v[kk].z = __fmul_rn(v[kk].z, v[kk].z);
                v[kk].w = __fmul_rn(v[kk].w, v[kk].w);
              }
              l[kk].x = __fadd_rn(l[kk].x, v[kk].x);
              l[kk].y = __fadd_rn(l[kk].y, v[kk].y);
              l[kk].z = __fadd_rn(l[kk].z, v[kk].z);
              l[kk].w = __fadd_rn(l[kk].w, v[kk].w);
            }
          }
#pragma unroll
          for (int kk = 0; kk < 8; ++kk) {
            p[k0 + kk] = __fadd_rn(__fadd_rn(__fadd_rn(l[kk].x, l[kk].y), l[kk].z), l[kk].w);
          }
        }
        // the tree's levels off = bw / 2 .. 32: t + off is lane + 32 (k + off / 32)
#pragma unroll
        for (int half = 8; half >= 1; half /= 2) {
          if (half >= per) continue;
#pragma unroll
          for (int k = 0; k < half; ++k) p[k] = __fadd_rn(p[k], p[k + half]);
        }
        float v = p[0];
        for (int off = dw / 2; off >= 1; off /= 2) {
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
        }
        if (lane == 0) {
          stat[pass][r] = pass == 0
              ? __fmul_rn(v, inv_k)
              : rsqrtf(__fadd_rn(__fmul_rn(v, inv_k), LN_EPS));
        }
        __syncwarp();   // the mean is written before the variance pass reads it
      }
    }
    __syncthreads();
  }
  // a thread's float4 i of every row at once: the rows' loads in flight
  // together, the norm's weight and bias read once
#pragma unroll (16 / ROWS)   // 16 float4 loads in flight a thread
  for (int i = threadIdx.x; i < K / 4; i += THREADS) {
    float4 w, b;
    if constexpr (LN) {
      w = reinterpret_cast<const float4*>(ln_w)[i];
      b = reinterpret_cast<const float4*>(ln_b)[i];
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r >= B) continue;
      float4 v = reinterpret_cast<const float4*>(x + (size_t)r * K)[i];
      if constexpr (LN) {
        const float mu = stat[0][r], rs = stat[1][r];
        v.x = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.x, mu), rs), w.x), b.x);
        v.y = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.y, mu), rs), w.y), b.y);
        v.z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.z, mu), rs), w.z), b.z);
        v.w = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v.w, mu), rs), w.w), b.w);
      }
      *reinterpret_cast<uint2*>(xs + (size_t)r * xstride + (size_t)i * 8) =
          make_uint2(pack_bf16x2(v.x, v.z), pack_bf16x2(v.y, v.w));
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void store_cache(void* cache, size_t idx, float v,
                                            int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(cache)[idx] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(cache)[idx] = v;
  }
}

// Input row `row`'s outputs of features f (va) and f + 1 (vb), f even: the
// store, the residual add (res may be out), the tanh-GELU, or the store and
// (qkv) the k / v cache write.
template <int EPI>
__device__ __forceinline__ void epilogue(int f, int row, float va, float vb,
                                         int N, const float* res, float* out,
                                         const CacheArgs& c) {
  const size_t o = (size_t)row * N + f;
  float ya = va, yb = vb;
  if constexpr (EPI == EPI_RESIDUAL) {
    ya = res[o] + va;
    yb = res[o + 1] + vb;
  } else if constexpr (EPI == EPI_GELU) {
    ya = gelu_tanh(va);
    yb = gelu_tanh(vb);
  }
  out[o] = ya;
  out[o + 1] = yb;
  if constexpr (EPI == EPI_QKV) {
    if (f >= c.hidden) {   // f and f + 1 lie in one head of k or of v
      const int which = (f - c.hidden) / c.hidden;  // 0: k, 1: v
      const int j = (f - c.hidden) % c.hidden;
      const int p = min(c.pos[row], c.ctx - 1);
      const size_t idx = (size_t)row * c.bstride +
                         ((size_t)(j / c.d) * c.ctx + p) * c.d + j % c.d;
      void* dst = which ? c.vc : c.kc;
      store_cache(dst, idx, va, c.bf16);
      store_cache(dst, idx + 1, vb, c.bf16);
    }
  }
}

// The tile groups of a GEMV over N features and K that this block takes:
// tile group q (the WARPS / ks tiles WARPS / ks * q ...) runs on block q mod
// gridDim.x, the block's groups one after another.
__device__ __forceinline__ int block_groups(int N, int K) {
  const int tpb = WARPS / k_split(K);
  const int groups = (N / TILE + tpb - 1) / tpb;
  const int blk = blockIdx.x, nblk = gridDim.x;
  return blk < groups ? (groups - 1 - blk) / nblk + 1 : 0;
}

// The start of a GEMV over the whole grid (out (B, N) = epilogue(LN?(x) @
// dequant(W)^T), W the layer's tiled codes / bf16 scales, N / 16 tiles of
// K / 128 stages): sets up this warp's weight stream, warp w taking range
// w % ks of tile w / ks of each of its block's tile groups, and issues its
// first RING stages into `ring`. It reads nothing a kernel writes (weights
// are never written during a launch), so it may run before the barrier or
// the wait that ends the phase before: K12 issues a phase's first weights
// as soon as a warp is done with the phase before.
template <bool PACKED>
__device__ __forceinline__ void gemv_begin(WeightStream<PACKED, true>& ws,
                                           const uint8_t* __restrict__ codes,
                                           const __nv_bfloat16* __restrict__ scales,
                                           int N, int K, uint8_t* ring) {
  using S = Stage<PACKED, true>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = k_split(K), tpb = WARPS / ks;
  const int j = warp / ks, range = warp % ks;
  const int stages = K / UNIT_K, per_item = stages / ks;
  const int tiles = N / TILE, n_groups = block_groups(N, K);
  const int blk = blockIdx.x, nblk = gridDim.x;
  // only the last group can fall short of tiles
  const int n_items =
      n_groups > 0 && (blk + nblk * (n_groups - 1)) * tpb + j >= tiles
          ? n_groups - 1 : n_groups;
  ws.init(codes, scales, blk * tpb + j, nblk * tpb, n_items, per_item, stages,
          range * per_item);
#pragma unroll
  for (int f = 0; f < RING; ++f) ws.next(ring + f * S::BYTES, lane);
}

// The rest of the GEMV after gemv_begin, for B <= NT * 8 rows: the rows
// staged (stage_rows), then the warp's items, each stage's mma products in
// K order, each tile's ks range sums added in range order by its first
// warp, then the epilogue. With `ready` (K12), each
// tile's first warp then counts its tiles on ready[head], the head of the 64
// features a tile wrote (the q, k or v of head (16 T mod hidden) / d for
// tile T), after its last tile of the phase: lane 0 fences at device scope
// after a warp barrier, then adds, so a block that sees the count with an
// acquire (grid_sync.cuh wait_count) reads the lanes' stores.
// Every thread of the block calls it; smem is the block's dynamic shared
// memory (smem_bytes). Returns with no copy in flight; a caller that runs
// it again on the same shared memory separates the two by a block barrier.
template <int QT, bool PACKED, int NT, bool LN, int EPI>
__device__ __forceinline__ void gemv_run(WeightStream<PACKED, true>& ws,
                                         const float* x, const float* ln_w,
                                         const float* ln_b, int B, int N, int K,
                                         const float* res, float* out,
                                         const CacheArgs& c, uint8_t* smem,
                                         unsigned int* ready = nullptr) {
  using S = Stage<PACKED, true>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ks = k_split(K), range = warp % ks;
  const int n_groups = block_groups(N, K);
  if (n_groups == 0) return;   // the whole block: no tile (a K12 grid past them)
  uint8_t* ring = smem + warp * RING * S::BYTES;
  float4* part = reinterpret_cast<float4*>(smem + WARPS * RING * S::BYTES);
  uint8_t* xs = smem + WARPS * RING * S::BYTES + WARPS * NT * 32 * 16;
  const int xstride = xs_stride(K);
  stage_rows<LN, NT * 8>(x, ln_w, ln_b, B, K, xs, xstride);

  int u = 0;   // the stage being computed, counted over the items
#pragma unroll 1
  for (int i = 0; i < n_groups; ++i) {
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (i < ws.n_items) {
#pragma unroll 1
      for (int st = 0; st < ws.per_item; ++st, ++u) {
        cp_async_wait<RING - 1>();
        __syncwarp();
        uint8_t* sp = ring + (u % RING) * S::BYTES;
        const int kl = (ws.first_stage + st) * UNIT_K;
#pragma unroll
        for (int jb = 0; jb < UNIT_BLOCKS; ++jb) {
          uint32_t a[2][4];
          a_frags<QT, PACKED, true>(sp, jb, g, t, a);
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
            for (int q = 0; q < 4; ++q) acc[n][q] += d[n][q];
          }
        }
        __syncwarp();   // every lane is done with the stage before it is refilled
        ws.next(sp, lane);
      }
    }
    // the tile's ks range sums meet in its first warp, added in range order
    if (ks > 1) {
      if (i < ws.n_items && range != 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          part[(warp * NT + n) * 32 + lane] =
              make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
        }
      }
      __syncthreads();
      if (i < ws.n_items && range == 0) {
        for (int q = 1; q < ks; ++q) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 v = part[((warp + q) * NT + n) * 32 + lane];
            acc[n][0] += v.x;
            acc[n][1] += v.y;
            acc[n][2] += v.z;
            acc[n][3] += v.w;
          }
        }
      }
    }
    if (i < ws.n_items && range == 0) {
      const int tile = ws.first + ws.stride * i;
      const int p = tile * 8 + g;   // features 2p, 2p + 1
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = n * 8 + 2 * t + h;
          if (row < B) {
            epilogue<EPI>(2 * p, row, acc[n][h], acc[n][2 + h], N, res, out, c);
          }
        }
      }

    }
    if (ks > 1) __syncthreads();   // the partial slots are free again
  }
  if (ready != nullptr && range == 0 && ws.n_items > 0) {
    // the lanes' outputs (and cache rows) ordered before lane 0's fence at
    // device scope by the warp barrier; then a count for each tile, on its
    // head. Once a phase, not a tile: a fence waits for the warp's stores,
    // and a warp's second tile ran later behind it (K12 ran slower with a
    // fence a tile, in an A/B of the two on the H100).
    __syncwarp();
    if (lane == 0) {
      asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
      for (int i = 0; i < ws.n_items; ++i) {
        asm volatile("red.relaxed.gpu.global.add.u32 [%0], 1;\n" ::"l"(
                         ready + ((ws.first + ws.stride * i) * TILE) % c.hidden / c.d)
                     : "memory");
      }
    }
  }
  cp_async_wait<0>();
}

// One GEMV launch of its own (K2, K5): out (B, N) = epilogue(LN?(x) @
// dequant(W)^T) over the whole grid, W the layer's tiled codes / bf16 scales
// (N / 16 tiles of K / 128 stages), B <= NT * 8: gemv_begin and gemv_run's
// work in one function, the same sums in the same order. Kept whole: with
// its stream state split across gemv_begin / gemv_run, K2 and K5 ran 4-6%
// slower (gemv_ab.py against this whole version on the H100). Tile group
// q (the WARPS / ks tiles WARPS / ks * q ...) runs on block q mod
// gridDim.x, warp w taking range w % ks of tile w / ks of the group; the
// block's groups follow one another, the ring running ahead across them.
// With PDL (a launch of its own) a block issues its first weight copies,
// lets the next launch start and waits for the kernel before it; only
// then does it read x, res or pos or write. Every thread
// of the block calls it; smem is the block's dynamic shared memory
// (smem_bytes). Returns with no copy in flight; a caller that runs it again
// on the same shared memory separates the two by a block barrier.
template <int QT, bool PACKED, int NT, bool LN, int EPI, bool PDL>
__device__ __forceinline__ void gemv(const float* x, const float* ln_w,
                                     const float* ln_b,
                                     const uint8_t* __restrict__ codes,
                                     const __nv_bfloat16* __restrict__ scales,
                                     int B, int N, int K, const float* res,
                                     float* out, const CacheArgs& c,
                                     uint8_t* smem) {
  using S = Stage<PACKED, true>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int ks = k_split(K), tpb = WARPS / ks;
  const int j = warp / ks, range = warp % ks;
  const int stages = K / UNIT_K, per_item = stages / ks;
  const int tiles = N / TILE;
  const int groups = (tiles + tpb - 1) / tpb;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int n_groups = blk < groups ? (groups - 1 - blk) / nblk + 1 : 0;
  // only the last group can fall short of tiles
  const int n_items =
      n_groups > 0 && (blk + nblk * (n_groups - 1)) * tpb + j >= tiles
          ? n_groups - 1 : n_groups;
  uint8_t* ring = smem + warp * RING * S::BYTES;
  float4* part = reinterpret_cast<float4*>(smem + WARPS * RING * S::BYTES);
  uint8_t* xs = smem + WARPS * RING * S::BYTES + WARPS * NT * 32 * 16;
  const int xstride = xs_stride(K);

  // The copies of the warp's next stage (if any) into st, as one commit
  // group; the first RING are issued before the wait for the kernel before:
  // weights are never written by a kernel.
  Copier<PACKED, true> cp;
  const int first_stage = range * per_item;
  int c_item = 0, c_stage = 0;   // the next stage to copy
  if (n_items > 0) cp.set_tile(blk * tpb + j, codes, scales, stages, first_stage);
  auto copy_next = [&](uint8_t* st) {
    if (c_item < n_items) {
      cp.issue(st, c_stage, lane);
      if (++c_stage == per_item) {
        c_stage = 0;
        if (++c_item < n_items) {
          cp.set_tile((blk + nblk * c_item) * tpb + j, codes, scales, stages,
                      first_stage);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int f = 0; f < RING; ++f) copy_next(ring + f * S::BYTES);
  if (n_groups == 0) return;   // the whole block: no tile (a K12 grid past them)
  if constexpr (PDL) {
    launch_dependents();
    grid_dependency_wait();
  }
  stage_rows<LN, NT * 8>(x, ln_w, ln_b, B, K, xs, xstride);

  int u = 0;   // the stage being computed, counted over the items
#pragma unroll 1
  for (int i = 0; i < n_groups; ++i) {
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if (i < n_items) {
#pragma unroll 1
      for (int st = 0; st < per_item; ++st, ++u) {
        cp_async_wait<RING - 1>();
        __syncwarp();
        uint8_t* sp = ring + (u % RING) * S::BYTES;
        const int kl = (first_stage + st) * UNIT_K;
#pragma unroll
        for (int jb = 0; jb < UNIT_BLOCKS; ++jb) {
          uint32_t a[2][4];
          a_frags<QT, PACKED, true>(sp, jb, g, t, a);
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
            for (int q = 0; q < 4; ++q) acc[n][q] += d[n][q];
          }
        }
        __syncwarp();   // every lane is done with the stage before it is refilled
        copy_next(sp);
      }
    }
    // the tile's ks range sums meet in its first warp, added in range order
    if (ks > 1) {
      if (i < n_items && range != 0) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          part[(warp * NT + n) * 32 + lane] =
              make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
        }
      }
      __syncthreads();
      if (i < n_items && range == 0) {
        for (int q = 1; q < ks; ++q) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 v = part[((warp + q) * NT + n) * 32 + lane];
            acc[n][0] += v.x;
            acc[n][1] += v.y;
            acc[n][2] += v.z;
            acc[n][3] += v.w;
          }
        }
      }
    }
    if (i < n_items && range == 0) {
      const int p = ((blk + nblk * i) * tpb + j) * 8 + g;   // features 2p, 2p + 1
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = n * 8 + 2 * t + h;
          if (row < B) {
            epilogue<EPI>(2 * p, row, acc[n][h], acc[n][2 + h], N, res, out, c);
          }
        }
      }
    }
    if (ks > 1) __syncthreads();   // the partial slots are free again
  }
  cp_async_wait<0>();
}

}  // namespace parler
}  // namespace tts
