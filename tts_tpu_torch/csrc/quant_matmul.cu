// K1: block-dequant matmul, out (M, N) = x (M, K) @ dequant(W)^T for ggml
// Q4_0 / Q5_0 / Q8_0 weights W (N, K) held row-major, 1 <= M <= 256.
//
// Replaces the TPU kernel tts_tpu/ops/quant_matmul.py:_qmm_kernel (wrapper
// quant_matmul_pallas). Same function, same two numeric modes keyed on the
// scale dtype (dequant.cuh):
//   f32 scales : exact f32 weights and activations, f32 sums;
//   bf16 scales: the weight dequantized in f32 and rounded once to bf16,
//                the activation rounded to bf16, f32 sums (the megastep
//                `_dqdot` math) -- exactly a bf16 tensor-core product with
//                f32 accumulation.
//
// What bounds it on the H100. At the LM heads (M = 1-16, N = 11520, K =
// 1024-2048, bf16 scales) it is a matrix-vector product: 0.5625 B a weight
// (packed Q4 codes + bf16 scales) for 2 M flops, bytes-bound (6.6-13.3 MB,
// 2-4 us at 3.35 TB/s). At prefill (M = 16-256, f32 scales) it is
// operations-bound: an f32 activation carries 24 bits, so on the bf16
// tensor cores it takes three passes (below), 3 x 2 M N K flops at 989
// TFLOP/s.
//
// Design (nothing of the TPU block carries over; the parent was one warp
// per output feature on the CUDA cores, re-reading the weights once per 8
// rows of x):
// - A block owns 64 output features (one tile) of every one of the M rows,
//   so each weight is read from device memory once per call at every M.
//   Where the tiles are fewer than the SMs, K is split over the ranks of a
//   thread-block cluster (2, 4 or 8; k1_plan in ops/quant_matmul.py: a
//   function of N, K and the SM count only). The ranks' meeting costs a
//   few microseconds, so the LM heads (180 tiles) take no split.
// - The activations are converted once per call by a small kernel before
//   the main one (stage_x_kernel): rounded to bf16 (bf16 mode), or split
//   into three bf16 parts hi + mid + lo that carry all 24 bits of the f32
//   value (f32 mode), each group of 4 elements stored in the order 0, 2,
//   1, 3 so that a thread's B fragment is one 8-byte load.
// - The main kernel streams the tile's weights and the M rows' activations
//   through a ring of shared-memory stages, fed by 16-byte cp.async copies
//   (one commit group a stage; stage 0's weights go out before the wait
//   for the conversion kernel, by programmatic dependent launch). A stage
//   holds UB 32-weight blocks of the 64 features and the M rows' UB * 32
//   activations of each part, staged once for the block: UB = 8 (a whole
//   128-byte line of a packed row) for up to 16 rows, where the weights'
//   bytes bound the call, 4 up to 32, else 2 (the activations fill the
//   stage); 2-12 stages deep, as many as fit 96 KB (54 KB for up to 8
//   rows, whose blocks of 4 warps run 4 an SM). Staged codes and
//   activations are swizzled (16-byte chunk c of row r at c ^ (r & 7)), so
//   that the copies and the fragment loads of 8 rows hit distinct banks.
// - Products on the tensor cores: mma.sync m16n8k16, bf16 in, f32 out. The
//   weights are the A operand (16 features), dequantized from the staged
//   codes into registers; the activation rows the B operand (8 rows). A
//   warp holds 1-4 A fragments (16-64 features) and 1-4 row tiles, more
//   features a warp as M grows, so that one B load feeds up to 4 products.
//   bf16 mode: A = bf16((code - bias) * scale), one pass. f32 mode: A =
//   code - bias, an integer of at most 8 bits that bf16 holds exactly;
//   three passes (lo, mid, hi) against the exact codes sum a 32-weight
//   block's products in f32, and that block's f32 scale is applied to the
//   block's sum with one fma. The products of a code and a part are exact
//   (8 x 8 significant bits); the split leaves at most 2^-24 of |x|. Error
//   against the plain version (dequant in f32, an f32 matmul): the order of
//   f32 sums, within 1e-5 of the largest output at K up to 8192
//   (chip_smoke check_k1, tests/test_torch_port_cuda.py).
// - Every 32-weight block's two (bf16) or six (f32) products are summed
//   apart, from zero, and added into the f32 sums in block order; the
//   ranks' sums meet in shared memory and are added in rank order. So an
//   output's bits depend on N, K and the SM count (the split), never on M
//   or on the other rows: a row of a call of M rows equals that row's call
//   alone, bit for bit (the engines' greedy parity with the runners rests
//   on it). No atomics.
// The heads do not go through the decode steps' GEMV (gemv.cuh): that code
// takes at most 16 rows, so a batched engine's call of 17+ rows would need
// another kernel and give a row other bits than the runner's 1-2 row call;
// one kernel for every M keeps a row's bits one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <mutex>

#include "gemv_tiles.cuh"

namespace {

using namespace tts;
namespace cg = cooperative_groups;

constexpr int BN = 64;              // output features of a block (a tile)
constexpr int MAX_M = 256;
constexpr int MIN_STAGES = 2;
constexpr int MAX_STAGES = 12;
// Dynamic shared memory a block may have: the H100's 227 KB, less the
// static shared memory (none).
constexpr int SMEM_LIMIT = 227 * 1024;

// One ring stage of UB 32-weight blocks a feature: codes [feature][CPR
// 16-byte chunks] (chunk j of feature f at j ^ (f & SW): the A-fragment
// loads of 8 features and the copies of a feature's chunks each hit
// distinct banks), scales [feature][block], then P activation parts of M
// rows of XROW bytes each (16-byte chunk c of row m at c ^ (m & 7)).
template <bool PACKED, bool BF16, int UB>
struct Ring {
  static constexpr int CB = PACKED ? 16 : 32;
  static constexpr int SB = BF16 ? 2 : 4;
  static constexpr int P = BF16 ? 1 : 3;
  static constexpr int CPR = UB * CB / 16;
  static constexpr int SW = (CPR < 8 ? CPR : 8) - 1;
  static constexpr int CODES = BN * UB * CB;
  static constexpr int SCALES = BN * UB * SB;
  static constexpr int XROW = UB * QK * 2;
  __host__ __device__ static int bytes(int M) {
    return (CODES + SCALES + P * M * XROW + 127) / 128 * 128;
  }
};

// The K split's shared memory: a block's sums, feature-major, rows
// ntiles * 8 + 4 floats apart.
__host__ __device__ inline int red_stride(int M) { return (M + 7) / 8 * 8 + 4; }

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// A copy of BYTES (4 or 8) bytes, through L1 (cp.async.cg takes 16 only).
template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "n"(BYTES)
               : "memory");
}

// cp.async.wait_group with a run-time count (the ring's depth is one).
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    default: cp_async_wait<10>(); break;
  }
}

// ---------------------------------------------------------------------------
// The activations, converted once per call
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// x (M, K) f32 -> P parts (P, M, K) bf16, each group of 4 elements in the
// order 0, 2, 1, 3. Part 0 is bf16(x); in f32 mode part 1 is bf16 of the
// remainder x - part 0 and part 2 of what is left after part 1 (each
// remainder exact in f32). One thread a group of 4.
constexpr int STAGE_X_THREADS = 256;

template <int P>
__global__ void __launch_bounds__(STAGE_X_THREADS)
stage_x_kernel(const float* __restrict__ x, uint2* __restrict__ xp, int n4) {
  launch_dependents();
  const int i = blockIdx.x * STAGE_X_THREADS + threadIdx.x;
  if (i >= n4) return;
  float4 v = reinterpret_cast<const float4*>(x)[i];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint32_t a = pack_bf16x2(v.x, v.z), b = pack_bf16x2(v.y, v.w);
    xp[(size_t)p * n4 + i] = make_uint2(a, b);
    if (p + 1 < P) {
      v = make_float4(__fsub_rn(v.x, bf16_lo(a)), __fsub_rn(v.y, bf16_lo(b)),
                      __fsub_rn(v.z, bf16_hi(a)), __fsub_rn(v.w, bf16_hi(b)));
    }
  }
}

// ---------------------------------------------------------------------------
// A fragments
// ---------------------------------------------------------------------------

// code - bias of the two codes at bits 0-7 and 16-23 of v (an unpacked
// row's bytes) as bf16x2, exactly: 0x4300 | c is the bf16 of 128 + c for c
// < 128 (Q4_0, Q5_0), less 128 + bias; Q8_0's signed codes through f32.
template <int QT>
__device__ __forceinline__ uint32_t code_pair(uint32_t v) {
  if constexpr (QT == Q8_0) {
    return pack_bf16x2(code_value<Q8_0>(v & 0xFFu), code_value<Q8_0>((v >> 16) & 0xFFu));
  } else {
    const uint32_t m = (v & 0x00FF00FFu) | 0x43004300u;
    const unsigned short b = QT == Q5_0 ? 0x4310 : 0x4308;   // 144, 136
    const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(b),
                                                   __ushort_as_bfloat16(b));
    const __nv_bfloat162 w = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m), bias);
    return *reinterpret_cast<const uint32_t*>(&w);
  }
}

// The same for Q4_0 nibbles at bits 0-3 and 16-19 of v.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v) {
  return code_pair<Q4_0>(v & 0x000F000Fu);
}

// The A fragments of block qb of a stage for the 16 features r0 .. r0 + 15
// of the tile, thread (g, t), both k16 steps (the k order of gemv_tiles.cuh
// a_frags: thread t takes weights e, e + 2 and e + 1, e + 3, e = 16 s + 4
// t). BF16: the dequantized weights; else the codes less their bias, and
// sa[h] the f32 scale of feature r0 + g + 8 h.
template <int QT, bool PACKED, bool BF16, int UB>
__device__ __forceinline__ void frags(const uint8_t* st, int qb, int r0, int g,
                                      int t, uint32_t a[2][4], float sa[2]) {
  using R = Ring<PACKED, BF16, UB>;
  constexpr int CH = R::CB / 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    const uint8_t* cr = st + row * R::CPR * 16 + 4 * t;
    const int sw = row & R::SW;
    float s;
    if constexpr (BF16) {
      s = __bfloat162float(
          reinterpret_cast<const __nv_bfloat16*>(st + R::CODES)[row * UB + qb]);
    } else {
      s = reinterpret_cast<const float*>(st + R::CODES)[row * UB + qb];
    }
    sa[h] = s;
    if constexpr (PACKED) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(cr + ((qb ^ sw) << 4));
      if constexpr (BF16) {
        const __nv_bfloat162 s2 = __float2bfloat162_rn(s);
        a[0][h] = dq_q4_bf16(w, s2);
        a[0][2 + h] = dq_q4_bf16(w >> 8, s2);
        a[1][h] = dq_q4_bf16(w >> 4, s2);
        a[1][2 + h] = dq_q4_bf16(w >> 12, s2);
      } else {
        a[0][h] = nibble_pair(w);
        a[0][2 + h] = nibble_pair(w >> 8);
        a[1][h] = nibble_pair(w >> 4);
        a[1][2 + h] = nibble_pair(w >> 12);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(cr + (((qb * CH + k) ^ sw) << 4));
        if constexpr (BF16) {
          a[k][h] = dq_pair<QT>(w & 0xFFu, (w >> 16) & 0xFFu, s);
          a[k][2 + h] = dq_pair<QT>((w >> 8) & 0xFFu, w >> 24, s);
        } else {
          a[k][h] = code_pair<QT>(w);
          a[k][2 + h] = code_pair<QT>(w >> 8);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Grid: tiles x ks blocks, clusters of ks along K; block rank r of tile c
// takes K blocks [r nb / ks, (r + 1) nb / ks) of features [64 c, 64 c +
// 64), UB blocks a stage. Warp w: features rg * 16 NA + [0, 16 NA) (rg = w
// / XG) of row tiles xg, xg + XG, ... (xg = w % XG, XG = 2 NA; a row tile
// is 8 rows), at most NB of them; W warps, XG = W NA / 4. xp: the
// activation parts (stage_x_kernel), read after griddepcontrol.wait.
// Blocks an SM: 4 of 4 warps for up to 8 rows (3 in f32 mode, whose three
// passes want the registers), 2 of 8 up to 128 rows (more loads in flight,
// more warps to hide the products' latency), 1 past it (64 f32 sums a
// thread).
template <int QT, bool PACKED, bool BF16, int NA, int NB, int UB, int W>
__global__ void __launch_bounds__(W * 32, W == 4 ? (BF16 ? 4 : 3) : NB <= 2 ? 2 : 1)
qmm_kernel(const uint8_t* __restrict__ codes, const void* __restrict__ scales,
           const uint8_t* xp, float* __restrict__ out, int M, int N, int K,
           int ks, int stages) {
  using R = Ring<PACKED, BF16, UB>;
  constexpr int THREADS = W * 32;
  constexpr int XG = W * NA / 4;
  constexpr int P = R::P;
  constexpr int XROW = R::XROW;
  constexpr int SCH = (UB * R::SB) / 16;   // 16-byte chunks of a feature's scales
  extern __shared__ __align__(128) uint8_t smem[];

  const int rank = ks > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int n0 = (blockIdx.x / ks) * BN;
  const int nb = K / QK;
  const int nst = nb / UB / ks;            // stages of this rank's K range
  const int b_first = rank * nst * UB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rg = warp / XG, xg = warp % XG;
  const int ntiles = (M + 7) / 8;
  const int sbytes = R::bytes(M);
  const size_t crow = (size_t)nb * R::CB;  // code bytes of a weight row

  // stage c's weights into ring slot c % stages: a feature's UB blocks are
  // contiguous, and neighbouring threads copy its neighbouring 16 bytes.
  // Features past N copy feature N - 1 (their outputs are not stored).
  auto issue_w = [&](int c) {
    uint8_t* st = smem + (c % stages) * sbytes;
    const int b0 = b_first + c * UB;
    for (int i = threadIdx.x; i < BN * R::CPR; i += THREADS) {
      const int row = i / R::CPR, j = i % R::CPR;
      const int n = min(n0 + row, N - 1);
      cp_async16(st + (row * R::CPR + (j ^ (row & R::SW))) * 16,
                 codes + n * crow + (size_t)b0 * R::CB + 16 * j);
    }
    const uint8_t* sc = reinterpret_cast<const uint8_t*>(scales);
    if constexpr (SCH > 0) {
      for (int i = threadIdx.x; i < BN * SCH; i += THREADS) {
        const int row = i / SCH, j = i % SCH;
        const int n = min(n0 + row, N - 1);
        cp_async16(st + R::CODES + (row * SCH + j) * 16,
                   sc + ((size_t)n * nb + b0) * R::SB + 16 * j);
      }
    } else if (threadIdx.x < BN) {
      const int n = min(n0 + (int)threadIdx.x, N - 1);
      cp_async_small<UB * R::SB>(st + R::CODES + threadIdx.x * UB * R::SB,
                                 sc + ((size_t)n * nb + b0) * R::SB);
    }
  };
  // stage c's activations: P parts of M rows, XROW / 16 chunks a row,
  // swizzled.
  auto issue_x = [&](int c) {
    constexpr int CX = XROW / 16;
    uint8_t* xs = smem + (c % stages) * sbytes + R::CODES + R::SCALES;
    const size_t k0 = (size_t)(b_first + c * UB) * QK;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      for (int i = threadIdx.x; i < M * CX; i += THREADS) {
        const int m = i / CX, ch = i % CX;
        cp_async16(xs + (p * M + m) * XROW + ((ch ^ (m & 7)) << 4),
                   xp + (((size_t)p * M + m) * K + k0) * 2 + ch * 16);
      }
    }
  };

  // The weights are never written by a kernel: the first stage's go out
  // before the wait for the conversion kernel (one commit group a stage,
  // so that stage 0 is computed while the later stages land).
  issue_w(0);
  grid_dependency_wait();
  for (int c = 0; c < stages - 1; ++c) {
    if (c < nst) {
      if (c > 0) issue_w(c);
      issue_x(c);
    }
    cp_async_commit();
  }

  float acc[NA][NB][4];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[a][b][0] = acc[a][b][1] = acc[a][b][2] = acc[a][b][3] = 0.f;
  }
  const int r0 = rg * 16 * NA;

#pragma unroll 1
  for (int c = 0; c < nst; ++c) {
    cp_async_wait_n(stages - 2);
    __syncthreads();   // stage c landed for all; slot (c - 1) % stages is free
    {
      const int f = c + stages - 1;
      if (f < nst) {
        issue_w(f);
        issue_x(f);
      }
      cp_async_commit();
    }
    if (xg >= ntiles) continue;
    const uint8_t* st = smem + (c % stages) * sbytes;
    const uint8_t* xs = st + R::CODES + R::SCALES;
#pragma unroll
    for (int qb = 0; qb < UB; ++qb) {
      uint32_t a[NA][2][4];
      float sa[NA][2];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        frags<QT, PACKED, BF16, UB>(st, qb, r0 + 16 * i, g, t, a[i], sa[i]);
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = xg + XG * b;
        if (j >= ntiles) break;
        const int col = 8 * j + g;
        const bool ok = col < M;
        float p[NA][4];
#pragma unroll
        for (int i = 0; i < NA; ++i) p[i][0] = p[i][1] = p[i][2] = p[i][3] = 0.f;
#pragma unroll
        for (int q = P - 1; q >= 0; --q) {   // lo, mid, hi
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int ch = 4 * qb + 2 * s + (t >> 1);
            uint2 bv = make_uint2(0u, 0u);
            if (ok) {
              bv = *reinterpret_cast<const uint2*>(
                  xs + (q * M + col) * XROW + ((ch ^ (col & 7)) << 4) + 8 * (t & 1));
            }
#pragma unroll
            for (int i = 0; i < NA; ++i) mma_bf16(p[i], a[i][s], bv.x, bv.y);
          }
        }
#pragma unroll
        for (int i = 0; i < NA; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][b][e] = BF16 ? __fadd_rn(acc[i][b][e], p[i][e])
                                : __fmaf_rn(sa[i][e / 2], p[i][e], acc[i][b][e]);
          }
        }
      }
    }
  }

  // D fragment of thread (g, t): feature r0 + 16 i + g (+ 8 for e >= 2),
  // row 8 j + 2 t (+ 1 for odd e).
  if (ks == 1) {
    if (xg >= ntiles) return;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = xg + XG * b;
        if (j >= ntiles) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = n0 + r0 + 16 * i + g + 8 * (e / 2);
          const int m = 8 * j + 2 * t + (e & 1);
          if (n < N && m < M) out[(size_t)m * N + n] = acc[i][b][e];
        }
      }
    }
    return;
  }

  // K split: each rank's sums into its shared memory, then rank r adds the
  // ranks' sums of features [r BN / ks, (r + 1) BN / ks) in rank order.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int rs = red_stride(M);
  if (xg < ntiles) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int j = xg + XG * b;
        if (j >= ntiles) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int f = r0 + 16 * i + g + 8 * h;
          *reinterpret_cast<float2*>(red + f * rs + 8 * j + 2 * t) =
              make_float2(acc[i][b][2 * h], acc[i][b][2 * h + 1]);
        }
      }
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // four rows at a time: one 16-byte read of each rank's shared memory
  const int per = BN / ks, m4 = (M + 3) / 4;
  for (int idx = threadIdx.x; idx < per * m4; idx += THREADS) {
    const int f = rank * per + idx % per, m = 4 * (idx / per);
    const float4* src = reinterpret_cast<const float4*>(red + f * rs + m);
    float4 v = *cluster.map_shared_rank(src, 0);
    for (int q = 1; q < ks; ++q) {
      const float4 u = *cluster.map_shared_rank(src, q);
      v = make_float4(__fadd_rn(v.x, u.x), __fadd_rn(v.y, u.y), __fadd_rn(v.z, u.z),
                      __fadd_rn(v.w, u.w));
    }
    if (n0 + f < N) {
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (m + e < M) out[(size_t)(m + e) * N + n0 + f] = vs[e];
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its sums
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int QT, bool PACKED, bool BF16, int NA, int NB, int UB, int W = 8>
int launch(const uint8_t* codes, const void* scales, const uint8_t* xp,
           float* out, int M, int N, int K, int ks, int stages, cudaStream_t s) {
  using R = Ring<PACKED, BF16, UB>;
  auto kern = qmm_kernel<QT, PACKED, BF16, NA, NB, UB, W>;
  if (M > 2 * W * NA * NB || K % (UB * QK * ks)) return (int)cudaErrorInvalidValue;
  int smem = stages * R::bytes(M);
  if (ks > 1 && BN * red_stride(M) * 4 > smem) smem = BN * red_stride(M) * 4;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  static std::once_flag opted;
  static cudaError_t opt_err = cudaSuccess;
  std::call_once(opted, [&] {
    opt_err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   SMEM_LIMIT);
  });
  if (opt_err != cudaSuccess) return (int)opt_err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN * ks);
  cfg.blockDim = dim3(W * 32);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, codes, scales, xp, out, M,
                                           N, K, ks, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The warp layout and the stage's width by M and ub (ops/quant_matmul.py
// k1_unit): more features a warp (one B load feeding more products) as the
// rows grow, wider stages (whole 128-byte lines of a weight row) and
// smaller blocks where they are few. An output's sums depend on none of
// these.
template <int QT, bool PACKED, bool BF16>
int by_rows(const uint8_t* codes, const void* scales, const uint8_t* xp,
            float* out, int M, int N, int K, int ub, int ks, int stages,
            cudaStream_t s) {
  if (ub == 8 && M <= 8) {
    return launch<QT, PACKED, BF16, 1, 1, 8, 4>(codes, scales, xp, out, M, N, K, ks, stages, s);
  }
  if (ub == 8 && M <= 16) {
    return launch<QT, PACKED, BF16, 1, 1, 8>(codes, scales, xp, out, M, N, K, ks, stages, s);
  }
  if (ub == 4 && M <= 32) {
    return launch<QT, PACKED, BF16, 2, 1, 4>(codes, scales, xp, out, M, N, K, ks, stages, s);
  }
  if (ub != 2) return (int)cudaErrorInvalidValue;
  if (M <= 64) return launch<QT, PACKED, BF16, 4, 1, 2>(codes, scales, xp, out, M, N, K, ks, stages, s);
  if (M <= 128) return launch<QT, PACKED, BF16, 4, 2, 2>(codes, scales, xp, out, M, N, K, ks, stages, s);
  return launch<QT, PACKED, BF16, 4, 4, 2>(codes, scales, xp, out, M, N, K, ks, stages, s);
}

template <bool BF16>
int dispatch(const uint8_t* codes, const void* scales, const uint8_t* xp,
             float* out, int M, int N, int K, int qtype, int packed, int ub,
             int ks, int stages, cudaStream_t s) {
  if (qtype == Q4_0 && packed) {
    return by_rows<Q4_0, true, BF16>(codes, scales, xp, out, M, N, K, ub, ks, stages, s);
  } else if (qtype == Q4_0) {
    return by_rows<Q4_0, false, BF16>(codes, scales, xp, out, M, N, K, ub, ks, stages, s);
  } else if (qtype == Q5_0 && !packed) {
    return by_rows<Q5_0, false, BF16>(codes, scales, xp, out, M, N, K, ub, ks, stages, s);
  } else if (qtype == Q8_0 && !packed) {
    return by_rows<Q8_0, false, BF16>(codes, scales, xp, out, M, N, K, ub, ks, stages, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (M, K) f32; codes / scales the weight's (N, K/32) blocks; xp scratch of
// (bf16 ? 1 : 3) * M * K bf16; out (M, N) f32. ub (8, 4 or 2 blocks a
// stage), ks (1, 2, 4 or 8) and stages (2-12) from ops/quant_matmul.py
// k1_unit, k1_plan and k1_stages. Two launches on `stream`: the
// activations' conversion, then the matmul.
extern "C" int tts_quant_matmul(const float* x, const uint8_t* codes,
                                const void* scales, void* xp, float* out,
                                int M, int N, int K, int qtype, int packed,
                                int bf16_scales, int ub, int ks, int stages,
                                void* stream) {
  if (M <= 0 || M > MAX_M || N <= 0 || K <= 0 ||
      (ks != 1 && ks != 2 && ks != 4 && ks != 8) ||
      (ub != 2 && ub != 4 && ub != 8) || K % (ub * QK * ks) ||
      stages < MIN_STAGES || stages > MAX_STAGES) {
    return (int)cudaErrorInvalidValue;
  }
  // 16-byte copies of codes and activations; a feature's scales of a stage
  // are one copy of 4 or 8 bytes, or 16-byte copies
  if ((size_t)x % 16 || (size_t)codes % 16 || (size_t)xp % 16 ||
      (size_t)scales % (ub * (bf16_scales ? 2 : 4) < 16 ? ub * (bf16_scales ? 2 : 4) : 16)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n4 = M * (K / 4);
  if (bf16_scales) {
    stage_x_kernel<1><<<(n4 + STAGE_X_THREADS - 1) / STAGE_X_THREADS, STAGE_X_THREADS, 0, s>>>(
        x, reinterpret_cast<uint2*>(xp), n4);
  } else {
    stage_x_kernel<3><<<(n4 + STAGE_X_THREADS - 1) / STAGE_X_THREADS, STAGE_X_THREADS, 0, s>>>(
        x, reinterpret_cast<uint2*>(xp), n4);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(xp);
  return bf16_scales
             ? dispatch<true>(codes, scales, xb, out, M, N, K, qtype, packed, ub, ks, stages, s)
             : dispatch<false>(codes, scales, xb, out, M, N, K, qtype, packed, ub, ks, stages, s);
}
