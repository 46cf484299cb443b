// K8, K6, K9 and K7: the Orpheus (llama-family) decode step's block-dequant
// GEMV, with the RMS norm fused as a prologue and the epilogues of the step
// fused after it. K8 runs the L layers for one sequence; K6 runs the same
// layers and then the final RMS norm and the padded LM head. K9 and K7 are
// K8 and K6 for B <= 16 batch slots, one input row per slot, each slot at
// its own position with its own cache. All four drive this one kernel
// (ops/llama_megastep.py, ops/llama_flat.py).
//
// Replaces the TPU kernels tts_tpu/ops/llama_megastep.py:_llama_kernel
// (wrapper llama_megastep), tts_tpu/ops/llama_flat.py:_flat_kernel
// (wrapper llama_flat_megastep), tts_tpu/ops/llama_megastep.py:
// _llama_batched_kernel (wrapper llama_megastep_batched) and _flat_kernel
// with batched=True (wrapper llama_flat_megastep_batched): per layer RMS ->
// qkv -> NeoX RoPE with the llama3 frequency factors -> GQA attention over
// the cache -> o -> RMS -> SiLU(gate) * up -> down, weights
// block-quantized, the TPU's `_dqdot`
// numerics (the weight dequantized in f32 with its f32 or bf16 scale and
// rounded once to bf16, activations rounded to bf16, f32 sums). The scale
// dtype here is only a storage choice, not a numerics mode as in K1: K8
// keeps the qkv scales in f32 and the others in bf16, as the TPU kernel's
// prep does; K6 keeps every scale in bf16. Either way the product rounds.
//
// What bounds it on the H100: a decode step reads every weight once for 2
// flops: at Orpheus-3B width 28 x (3072 x 5120 + 3072 x 3072 + 3 x 3072 x
// 8192) = 2.82 G Q4_0 weights x 0.5625 B = 1.585 GB, plus K6's head of
// 157,184 x 3072 (0.272 GB), plus 114,688 B of bf16 K/V rows per cache
// position: about 0.59 ms for K6 at 3.35 TB/s at position 1000. Memory
// bandwidth; at this size launch latency matters less than for Parler. The
// batched steps read the weights once for every slot and each slot's own
// K/V rows: K7 at 8 slots at positions 0..3000 (7334 rows in all) 1.86 GB
// of weights + 0.84 GB of K/V, about 0.81 ms; K9 (no head) about 0.73 ms.
//
// Design: the TPU kernels stream the layers through one sequential grid and
// carry x in VMEM. Blocks on the H100 run in no order and nothing carries
// between them, so the step is a sequence of launches on one stream, per
// layer (the Python wrappers drive it):
//   1. gemv  RMS prologue, qkv;  epilogue RoPE on q and k, and k, v written
//            into cache row pos
//   2. K3    GQA attention over cache rows [0, pos] (kv head j serves q
//            heads [j * g, (j + 1) * g))
//   3. gemv  o;              epilogue x += .
//   4. gemv  RMS prologue, gate and up;  epilogue SiLU(gate) * up
//   5. gemv  down;           epilogue x += .
// and for K6, after the last layer:
//   6. gemv  RMS(out_norm) prologue, head;  epilogue store the logits.
// Each warp computes two output features, so that the epilogues that pair
// features need no exchange between warps: RoPE rotates features i and
// i + d/2 of one head, and SiLU(gate) * up pairs gate row n with up row n.
// The other epilogues take rows 2p and 2p + 1. A warp streams each of its
// weight rows as K1 and K2 do (dequant.cuh): each lane dequantizes a
// 32-weight block once into registers and dots it with each input row. The
// RMS prologue normalizes each input row into shared memory in every block
// (recomputing it per block costs L2 reads, not device-memory traffic).
// The kernel is templated on the input rows (ROWS 1, 8 or
// 16), as K2/K5 are; the batched steps (K9, K7) are K8's and K6's launch
// sequences with B rows, the attention launch being K4, the batched K3.
//
// Where the batched steps can go wrong, and what this design does:
//  * Per-slot bit-identity: each K9 slot equals K8 on that slot's state,
//    and each K7 slot K6, bit for bit. A row sums in the same order
//    whatever ROWS is (the per-row accumulators are independent, the RMS
//    block sum and the warp sums are per row), and K4 on one slot equals
//    K3. The engine's greedy tokens equal the single-stream runner's
//    because of it.
//  * Attention roundings: the TPU batched kernels round q, K/V and the
//    softmax probabilities to bf16 for their page dots; the single-stream
//    ones do not. K4 keeps K3's f32 softmax instead, so that slots equal
//    K8/K6 (the JAX package's reference for both batched kernels is the
//    single-stream reference per slot).
//  * Mixed positions: row r reads its position at pos[r * pos_stride] and
//    writes its cache at r * kv_bstride; the checks put slots at different
//    positions that straddle K4's 256-row pages, one of them at 0.
//  * Activation reads: each lane reads its 32-element block of every row
//    once per weight block, and the lanes of a warp read 32 consecutive
//    blocks: at a 128-byte lane stride, float4 loads of f32 rows conflict
//    in the shared-memory banks and scatter over L1 lines, B times over
//    (K5's bottleneck, PERF.md).
//    So each block stages the input rows as bf16 (the rounding the dot
//    applies anyway), K in chunks of KC elements, with the four 16-byte
//    chunks of each 32-element block rotated by (block / 2): a quarter
//    warp's 8 loads hit 8 bank groups, and a row takes half the bytes. KC
//    is a multiple of a warp's pass over 32 blocks, so every lane visits
//    its blocks in the same order as without chunks: the products and
//    their order are unchanged, and each row sums as before.
//  * Shared memory: B x KC bf16 fit in 46 KB (KC = K at one row, 2048 at 8
//    rows, 1024 at 16), static, under the 48 KB a block gets without
//    opting in: no launch asks for more, and registers, not shared memory,
//    bound the blocks per SM.
//
// The current token's k/v: the TPU kernels fold the unrounded f32 k/v of
// the current token into the softmax, and the caller writes the cache row
// afterwards. Here, as in K2, the qkv epilogue writes the row first and K3
// attends rows [0, pos]: exact in f32; on a bf16 cache the current row is
// rounded to bf16 before it is attended. The plain versions do the same.
// RoPE angles reach pos x inv_freq[0] = 3584 rad at the end of the cache,
// so they use the accurate cosf / sinf (no --use_fast_math anywhere).
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

using namespace tts;

constexpr int WARPS = 8;
constexpr float RMS_EPS = 1e-5f;

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

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w];
  __syncthreads();
  return t;
}

__device__ __forceinline__ void store_cache(void* cache, size_t idx, float v,
                                            int bf16) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(cache)[idx] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(cache)[idx] = v;
  }
}

// Each block stages its input rows in shared memory, K in chunks of KC
// elements: B x KC bf16 within STAGE_BYTES, under the 48 KB a block gets
// without opting in (its other static shared memory takes the rest). KC is
// a multiple of ROUND, the elements one pass of a warp's 32 lanes covers,
// so that every lane visits its blocks in the same order whatever KC is.
constexpr int STAGE_BYTES = 46 * 1024;
constexpr int ROUND = 32 * QK;

__device__ __forceinline__ int chunk_elems(int B, int K) {
  const int kc = STAGE_BYTES / (int)sizeof(__nv_bfloat16) / B / ROUND * ROUND;
  return min(max(kc, ROUND), K);
}

// Element i of a staged activation row: block i / 32 keeps its four 16-byte
// chunks of 8 bf16 rotated by (block / 2), so that the 8 lanes of a quarter
// warp, which read chunk c of 8 consecutive blocks, hit 8 different 16-byte
// bank groups. block_dot_staged undoes the rotation.
__device__ __forceinline__ int staged_index(int i) {
  const int b = i >> 5, c = (i >> 3) & 3;
  return (b << 5) | (((c + (b >> 1)) & 3) << 3) | (i & 7);
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

// dequant.cuh's block_dot<true> over block b of a staged row xr (bf16,
// rotated chunks): the same products of the same bf16 values summed in the
// same order.
__device__ __forceinline__ float block_dot_staged(
    const __nv_bfloat16* __restrict__ xr, int b, const float w[QK]) {
  const uint4* blk = reinterpret_cast<const uint4*>(xr + b * QK);
  uint4 q[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = blk[(c + (b >> 1)) & 3];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < QK / 4; ++j) {
    const uint4& h = q[j / 2];
    const uint32_t u0 = j % 2 ? h.z : h.x, u1 = j % 2 ? h.w : h.y;
    sum += w[4 * j] * bf16_lo(u0) + w[4 * j + 1] * bf16_hi(u0) +
           w[4 * j + 2] * bf16_lo(u1) + w[4 * j + 3] * bf16_hi(u1);
  }
  return sum;
}

// Grid ceil(P / WARPS) blocks; warp p of the grid computes the feature pair
// p (see the header) for B <= ROWS input rows x (B, K); out (B, N). For each
// chunk of K, the block rounds the rows' elements to bf16 (after the RMS
// norm when RMS) into shared memory in the rotated layout, then every warp
// dots its weight blocks of the chunk with them.
template <int QT, bool PACKED, bool SBF16, bool RMS, int EPI, int ROWS>
__global__ void __launch_bounds__(WARPS * 32)
llama_gemv_kernel(const float* __restrict__ x, const float* __restrict__ norm_w,
                  const uint8_t* __restrict__ codes_a, const void* __restrict__ scales_a,
                  const uint8_t* __restrict__ codes_b, const void* __restrict__ scales_b,
                  int B, int P, int N, int K, const float* res, float* out,
                  RopeArgs ra) {
  __shared__ __align__(16) __nv_bfloat16 xs[STAGE_BYTES / sizeof(__nv_bfloat16)];
  __shared__ float red[WARPS];
  __shared__ float rstd[ROWS];
  if constexpr (RMS) {
    for (int r = 0; r < B; ++r) {
      const float* xr = x + (size_t)r * K;
      float s = 0.f;
      for (int i = threadIdx.x; i < K; i += WARPS * 32) s += xr[i] * xr[i];
      const float t = block_sum(s, red);
      if (threadIdx.x == 0) rstd[r] = 1.f / sqrtf(t / K + RMS_EPS);
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = blockIdx.x * WARPS + warp;
  // a warp past the last pair still stages its share of every chunk
  const bool live = p < P;
  const int pw = live ? p : P - 1;
  int row_a, row_b;
  if constexpr (EPI == EPI_ROPE_QKV) {
    const int h2 = ra.d / 2;
    row_a = (pw / h2) * ra.d + pw % h2;
    row_b = row_a + h2;
  } else if constexpr (EPI == EPI_SILU_MUL) {
    row_a = pw;
    row_b = pw;
  } else {
    row_a = 2 * pw;
    row_b = 2 * pw + 1;
  }
  const int nb = K / QK, kc_max = chunk_elems(B, K);
  const size_t row_bytes = PACKED ? K / 2 : K;
  const uint8_t* wa = codes_a + (size_t)row_a * row_bytes;
  const uint8_t* wb = codes_b + (size_t)row_b * row_bytes;
  float acc_a[ROWS], acc_b[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc_a[r] = acc_b[r] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kc_max) {
    const int kc = min(kc_max, K - k0), b0 = k0 / QK;
    __syncthreads();  // the last chunk's reads are done; rstd is written
    for (int r = 0; r < B; ++r) {
      const float* xr = x + (size_t)r * K + k0;
      for (int i = threadIdx.x; i < kc; i += WARPS * 32) {
        const float v = RMS ? xr[i] * rstd[r] * norm_w[k0 + i] : xr[i];
        xs[r * kc_max + staged_index(i)] = __float2bfloat16_rn(v);
      }
    }
    __syncthreads();
    for (int b = b0 + lane; b < b0 + kc / QK; b += 32) {
      float w[QK];
      dequant_block<QT, PACKED, true>(
          wa, b, load_scale<SBF16>(scales_a, (size_t)row_a * nb + b), w);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < B) acc_a[r] += block_dot_staged(xs + r * kc_max, b - b0, w);
      }
      dequant_block<QT, PACKED, true>(
          wb, b, load_scale<SBF16>(scales_b, (size_t)row_b * nb + b), w);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < B) acc_b[r] += block_dot_staged(xs + r * kc_max, b - b0, w);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r >= B) break;
    const float va = warp_sum(acc_a[r]);
    const float vb = warp_sum(acc_b[r]);
    if (lane != 0) continue;
    float* o = out + (size_t)r * N;
    if constexpr (EPI == EPI_SILU_MUL) {
      o[p] = va / (1.f + expf(-va)) * vb;
    } else if constexpr (EPI == EPI_RESIDUAL) {
      const float* rs = res + (size_t)r * N;
      o[row_a] = rs[row_a] + va;
      o[row_b] = rs[row_b] + vb;
    } else if constexpr (EPI == EPI_STORE) {
      o[row_a] = va;
      o[row_b] = vb;
    } else {  // EPI_ROPE_QKV
      const int h2 = ra.d / 2;
      const int pr = ra.pos[r * ra.pos_stride];
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
        const int row = min(pr, ra.ctx - 1);
        const size_t idx = (size_t)r * ra.bstride +
                           ((size_t)(j / ra.d) * ra.ctx + row) * ra.d + j % ra.d;
        void* cache = is_v ? ra.vc : ra.kc;
        store_cache(cache, idx, ya, ra.bf16);
        store_cache(cache, idx + h2, yb, ra.bf16);
      }
    }
  }
}

template <int QT, bool PACKED, bool SBF16, bool RMS, int EPI, int ROWS>
int launch_one(const float* x, const float* norm_w, const uint8_t* ca,
               const void* sa, const uint8_t* cb, const void* sb, int B, int P,
               int N, int K, const float* res, float* out, RopeArgs ra,
               cudaStream_t s) {
  const dim3 grid((P + WARPS - 1) / WARPS);
  llama_gemv_kernel<QT, PACKED, SBF16, RMS, EPI, ROWS><<<grid, WARPS * 32, 0, s>>>(
      x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra);
  return (int)cudaGetLastError();
}

template <int QT, bool PACKED, bool SBF16, int ROWS>
int launch(int rms, int epi, const float* x, const float* norm_w,
           const uint8_t* ca, const void* sa, const uint8_t* cb, const void* sb,
           int B, int P, int N, int K, const float* res, float* out,
           RopeArgs ra, cudaStream_t s) {
#define TTS_GEMV_ARGS x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (rms && epi == EPI_ROPE_QKV) {
    return launch_one<QT, PACKED, SBF16, true, EPI_ROPE_QKV, ROWS>(TTS_GEMV_ARGS);
  } else if (rms && epi == EPI_SILU_MUL) {
    return launch_one<QT, PACKED, SBF16, true, EPI_SILU_MUL, ROWS>(TTS_GEMV_ARGS);
  } else if (rms && epi == EPI_STORE) {
    return launch_one<QT, PACKED, SBF16, true, EPI_STORE, ROWS>(TTS_GEMV_ARGS);
  } else if (!rms && epi == EPI_RESIDUAL) {
    return launch_one<QT, PACKED, SBF16, false, EPI_RESIDUAL, ROWS>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

template <int QT, bool PACKED, int ROWS>
int with_scales(int scale_bf16, int rms, int epi, const float* x,
                const float* norm_w, const uint8_t* ca, const void* sa,
                const uint8_t* cb, const void* sb, int B, int P, int N, int K,
                const float* res, float* out, RopeArgs ra, cudaStream_t s) {
#define TTS_GEMV_ARGS rms, epi, x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (scale_bf16) return launch<QT, PACKED, true, ROWS>(TTS_GEMV_ARGS);
  return launch<QT, PACKED, false, ROWS>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}

template <int ROWS>
int dispatch(int qtype, int packed, int scale_bf16, int rms, int epi,
             const float* x, const float* norm_w, const uint8_t* ca,
             const void* sa, const uint8_t* cb, const void* sb, int B, int P,
             int N, int K, const float* res, float* out, RopeArgs ra,
             cudaStream_t s) {
#define TTS_GEMV_ARGS scale_bf16, rms, epi, x, norm_w, ca, sa, cb, sb, B, P, N, K, res, out, ra, s
  if (qtype == Q4_0 && packed) {
    return with_scales<Q4_0, true, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q4_0) {
    return with_scales<Q4_0, false, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q5_0 && !packed) {
    return with_scales<Q5_0, false, ROWS>(TTS_GEMV_ARGS);
  } else if (qtype == Q8_0 && !packed) {
    return with_scales<Q8_0, false, ROWS>(TTS_GEMV_ARGS);
  }
#undef TTS_GEMV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

constexpr int MAX_ROWS = 16;

// out = epilogue(RMS?(x) @ dequant(W)^T) for x (B, K), weights row-major
// (N, K) as ops/quant_matmul.py lays them out, with f32 (scale_bf16 = 0) or
// bf16 scales and the `_dqdot` rounding either way; 1 <= B <= 16 (K6/K8
// are the calls with B = 1, K7/K9 with one row per slot). (rms, epi) is one of
//   (1, ROPE_QKV): W = qkv (hidden + 2 kvh rows); out (B, hidden + 2 kvh)
//                  with q and k of row r rotated at pos[r * pos_stride];
//                  row r's k and v also written into its cache (kc / vc +
//                  r * kv_bstride elements) at row min(pos, ctx - 1);
//   (1, SILU_MUL): A = gate, B = up, both (N, K); out (B, N);
//   (1, STORE)   : out (B, N), N even;
//   (0, RESIDUAL): out = res + ., N even (res may be out).
// codes_b / scales_b are read only by SILU_MUL; pass A's for the others.
extern "C" int tts_llama_gemv(
    const float* x, const float* norm_w, int rms, const uint8_t* codes_a,
    const void* scales_a, const uint8_t* codes_b, const void* scales_b,
    int qtype, int packed, int scale_bf16, int B, int N, int K,
    const float* res, float* out, int epi, const float* inv, const int* pos,
    int pos_stride, void* kc, void* vc, int hidden, int kvh, int d, int ctx,
    int cache_bf16, long long kv_bstride, void* stream) {
  if (B <= 0 || B > MAX_ROWS || N <= 0 || N % 2 || K <= 0 || K % tts::QK) {
    return (int)cudaErrorInvalidValue;
  }
  if (epi == EPI_ROPE_QKV &&
      (d <= 0 || d % 2 || hidden % d || kvh % d || N != hidden + 2 * kvh)) {
    return (int)cudaErrorInvalidValue;
  }
  const int P = epi == EPI_SILU_MUL ? N : N / 2;
  const RopeArgs ra{inv, pos, pos_stride, kc, vc, hidden, kvh, d, ctx,
                    cache_bf16, kv_bstride};
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define TTS_GEMV_ARGS qtype, packed, scale_bf16, rms, epi, x, norm_w, codes_a, scales_a, codes_b, scales_b, B, P, N, K, res, out, ra, s
  if (B == 1) return dispatch<1>(TTS_GEMV_ARGS);
  if (B <= 8) return dispatch<8>(TTS_GEMV_ARGS);
  return dispatch<MAX_ROWS>(TTS_GEMV_ARGS);
#undef TTS_GEMV_ARGS
}
