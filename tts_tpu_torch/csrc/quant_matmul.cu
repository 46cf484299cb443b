// K1: block-dequant matmul, out (M, N) = x (M, K) @ dequant(W)^T for ggml
// Q4_0 / Q5_0 / Q8_0 weights W (N, K).
//
// Replaces the TPU kernel tts_tpu/ops/quant_matmul.py:_qmm_kernel (wrapper
// quant_matmul_pallas). Same function, same two numeric modes keyed on the
// scale dtype (f32 scales: exact f32; bf16 scales: the megastep `_dqdot`
// rounding), see dequant.cuh.
//
// What bounds it on the H100: at the decode shapes (M = 1, the 9 stacked LM
// heads, N = 11520, K = 1024) it is a matrix-vector product and moves
// 0.5625 B per weight (packed Q4 codes + bf16 scales) for 2 flops: memory
// bandwidth. At prefill shapes (M up to 256, f32 scales) it does up to 512
// f32 flops per weight and is bound by the f32 CUDA-core rate.
//
// Design: the TPU layout (transposed (K, N) codes, 2048-row half-split
// nibbles) was shaped for Mosaic's sublane broadcast. Here the weights stay
// row-major as ggml stores them, so one warp owns one output feature n and
// reads its row contiguously: each lane takes whole 32-element blocks (one
// 16-byte load of packed Q4 codes, or two of 8-bit codes, plus one scale),
// dequantizes them in registers and dots them with up to MT rows of x; a
// warp shuffle reduces the lane sums. No shared memory, no tensor cores:
// simple first; wgmma and TMA are later work.
#include <cuda_runtime.h>

#include "dequant.cuh"

namespace {

using namespace tts;

constexpr int WARPS = 8;  // output features per block
constexpr int MT = 8;     // rows of x per block (grid.y tiles M)

template <int QT, bool PACKED, bool BF16>
__global__ void __launch_bounds__(WARPS * 32)
qmm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
           const void* __restrict__ scales, float* __restrict__ out, int M,
           int N, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * WARPS + warp;
  if (n >= N) return;  // whole warp leaves together
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, M - m0);
  const int nb = K / QK;
  const uint8_t* row = codes + (size_t)n * (PACKED ? K / 2 : K);
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.f;
  for (int b = lane; b < nb; b += 32) {
    float w[QK];
    dequant_block<QT, PACKED, BF16>(row, b,
                                    load_scale<BF16>(scales, (size_t)n * nb + b),
                                    w);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m < mrows) {
        acc[m] += block_dot<BF16>(x + (size_t)(m0 + m) * K + b * QK, w);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m < mrows) {
      const float s = warp_sum(acc[m]);
      if (lane == 0) out[(size_t)(m0 + m) * N + n] = s;
    }
  }
}

template <int QT, bool PACKED, bool BF16>
void launch(const float* x, const uint8_t* codes, const void* scales,
            float* out, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + WARPS - 1) / WARPS, (M + MT - 1) / MT);
  qmm_kernel<QT, PACKED, BF16><<<grid, WARPS * 32, 0, stream>>>(
      x, codes, scales, out, M, N, K);
}

template <bool BF16>
int dispatch(const float* x, const uint8_t* codes, const void* scales,
             float* out, int M, int N, int K, int qtype, int packed,
             cudaStream_t s) {
  if (qtype == Q4_0 && packed) {
    launch<Q4_0, true, BF16>(x, codes, scales, out, M, N, K, s);
  } else if (qtype == Q4_0) {
    launch<Q4_0, false, BF16>(x, codes, scales, out, M, N, K, s);
  } else if (qtype == Q5_0 && !packed) {
    launch<Q5_0, false, BF16>(x, codes, scales, out, M, N, K, s);
  } else if (qtype == Q8_0 && !packed) {
    launch<Q8_0, false, BF16>(x, codes, scales, out, M, N, K, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tts_quant_matmul(const float* x, const uint8_t* codes,
                                const void* scales, float* out, int M, int N,
                                int K, int qtype, int packed, int bf16_scales,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % tts::QK) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return bf16_scales
             ? dispatch<true>(x, codes, scales, out, M, N, K, qtype, packed, s)
             : dispatch<false>(x, codes, scales, out, M, N, K, qtype, packed, s);
}
