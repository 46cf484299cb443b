// Shared device helpers for the block-dequant kernels (quant_matmul.cu,
// parler_gemv.cuh, gemv.cuh): ggml Q4_0 / Q5_0 / Q8_0 weights held
// row-major, one weight row (output feature n) = K/32 blocks of 32 codes
// plus one scale per block.
//
// Code layout per row (ops/quant_matmul.py builds it):
//   Q4_0 packed   : K/2 bytes; block b = bytes [16b, 16b+16): byte i holds
//                   element i in its low nibble and element i+16 in its high
//                   nibble (ggml's own block_q4_0.qs layout);
//   Q4_0 unpacked : K bytes, codes 0..15;   Q5_0: K bytes, codes 0..31;
//   Q8_0          : K bytes, int8 codes.
// value = (code - bias) * scale, bias 8 / 16 / 0.
//
// Two numeric modes, as the TPU kernel keys them on the scale dtype:
//   f32 scales : exact f32 weights, f32 activations, f32 sums;
//   bf16 scales: the weight is dequantized in f32 and rounded once to bf16,
//                the activation is rounded to bf16, products and sums in f32
//                (the TPU megastep's `_dqdot` math).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tts {

constexpr int QK = 32;
enum QType { Q4_0 = 2, Q5_0 = 6, Q8_0 = 8 };

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool BF16>
__device__ __forceinline__ float load_scale(const void* scales, size_t i) {
  if constexpr (BF16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(scales)[i]);
  } else {
    return reinterpret_cast<const float*>(scales)[i];
  }
}

// The codes of block b of one weight row: 16 bytes (Q4_0 packed) in q[0],
// or 32 in q[0], q[1]. The row pointer must be 16-byte aligned.
template <bool PACKED>
__device__ __forceinline__ void load_codes(const uint8_t* __restrict__ row,
                                           int b, uint4 q[2]) {
  if constexpr (PACKED) {
    q[0] = __ldg(reinterpret_cast<const uint4*>(row + b * 16));
  } else {
    q[0] = __ldg(reinterpret_cast<const uint4*>(row + b * 32));
    q[1] = __ldg(reinterpret_cast<const uint4*>(row + b * 32 + 16));
  }
}

// code - bias as a float, exactly (a code byte, a Q4_0 nibble, or a Q8_0
// byte whose bits are an int8): 2^23 + code has the code in its low
// mantissa bits, and (2^23 + code) - (2^23 + bias) is exact. Q8_0's signed
// code is biased by 128 first (its sign bit flipped). Integer and add
// instructions in place of an int -> float conversion, which the SMs run
// at a quarter of their add rate.
template <int QT>
__device__ __forceinline__ float code_value(uint32_t code) {
  if constexpr (QT == Q8_0) {
    return __uint_as_float(0x4B000000u | (code ^ 0x80u)) - 8388736.f;
  } else if constexpr (QT == Q5_0) {
    return __uint_as_float(0x4B000000u | code) - 8388624.f;
  } else {
    return __uint_as_float(0x4B000000u | code) - 8388616.f;
  }
}

// One block's codes (load_codes) -> w[32] = (code - bias) * s, rounded to
// bf16 in BF16 mode (two at a time, one conversion instruction per pair).
template <int QT, bool PACKED, bool BF16>
__device__ __forceinline__ void dequant_codes(const uint4 q[2], float s,
                                              float w[QK]) {
  if constexpr (PACKED) {
    const uint32_t u[4] = {q[0].x, q[0].y, q[0].z, q[0].w};
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t byte = (u[i / 4] >> (8 * (i % 4))) & 0xFFu;
      w[i] = code_value<Q4_0>(byte & 15u);
      w[i + 16] = code_value<Q4_0>(byte >> 4);
    }
  } else {
    const uint32_t u[8] = {q[0].x, q[0].y, q[0].z, q[0].w,
                           q[1].x, q[1].y, q[1].z, q[1].w};
#pragma unroll
    for (int i = 0; i < QK; ++i) {
      w[i] = code_value<QT>((u[i / 4] >> (8 * (i % 4))) & 0xFFu);
    }
  }
#pragma unroll
  for (int i = 0; i < QK; ++i) w[i] = w[i] * s;
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < QK; i += 2) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(w[i], w[i + 1]);
      w[i] = __low2float(h);
      w[i + 1] = __high2float(h);
    }
  }
}

// Block b of one weight row -> w[32] = (code - bias) * s (bf16-rounded in
// BF16 mode). The row pointer must be 16-byte aligned.
template <int QT, bool PACKED, bool BF16>
__device__ __forceinline__ void dequant_block(const uint8_t* __restrict__ row,
                                              int b, float s, float w[QK]) {
  uint4 q[2];
  load_codes<PACKED>(row, b, q);
  dequant_codes<QT, PACKED, BF16>(q, s, w);
}

// sum_i w[i] * x[i] over one 32-element block; x is 16-byte aligned (global
// or shared memory). In BF16 mode each x is rounded to bf16 first. x is not
// __restrict__: the persistent K12 reads activations that other blocks of
// the same launch wrote, which must not go through the read-only cache.
template <bool BF16>
__device__ __forceinline__ float block_dot(const float* x,
                                           const float w[QK]) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < QK / 4; ++j) {
    float4 v = x4[j];
    if constexpr (BF16) {
      v.x = bf16_round(v.x); v.y = bf16_round(v.y);
      v.z = bf16_round(v.z); v.w = bf16_round(v.w);
    }
    sum += w[4 * j] * v.x + w[4 * j + 1] * v.y + w[4 * j + 2] * v.z +
           w[4 * j + 3] * v.w;
  }
  return sum;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace tts
