// GGUF block quantization on the card: float32 values -> ggml Q4_0 / Q5_0 /
// Q8_0 blocks, the bytes the GGUF quantizer writes.
//
// Replaces the JAX package's host data path for the quantizer,
// tts_tpu/native.py quantize (threaded host C++, native/ttsnative.cpp). The
// specification is the numpy reference, tts_tpu_torch/gguf/quants.py
// quantize_q{4,5,8}_0, which this kernel follows bit for bit (the host C++
// rounds Q8_0 with roundf and may contract Q4/Q5's x * inv + c into an FMA,
// so it parts from numpy in a few blocks in 65536):
//
//   Q4_0 / Q5_0: m = the block's value of largest |x|, the first on a tie;
//     d = m / -8 (Q5_0: -16); inv = d != 0 ? 1 / d : 0;
//     q = trunc(clip(x * inv + 8.5, 0, 15)) (Q5_0: + 16.5, 0, 31).
//   Q8_0: amax = max |x|; d = amax / 127; inv = d > 0 ? 1 / d : 0;
//     q = clip(sign(s) * floor(|s| + 0.5), -128, 127), s = x * inv.
//   Each product, sum and quotient is one IEEE f32 operation rounded to
//   nearest (__fmul_rn, __fadd_rn, __fdiv_rn: nvcc may not contract them into
//   an FMA, and the build passes no fast-math or flush-to-zero flag); the
//   scale is stored as fp16 rounded to nearest even (__float2half_rn:
//   overflow to inf, subnormals kept), as numpy's astype(float16).
//
// Block layouts (little-endian, no padding):
//   Q4_0 18 bytes: fp16 d, then byte j = q[j] | q[j + 16] << 4 (j < 16).
//   Q5_0 22 bytes: fp16 d, u32 qh (bit j = bit 4 of q[j]), then 16 bytes of
//     low nibbles packed as Q4_0's.
//   Q8_0 34 bytes: fp16 d, then the 32 codes as int8.
//
// What bounds it: each value is read once (4 bytes) and its block written
// once (0.56-1.06 bytes a value): memory bandwidth.
//
// Design: one warp per 32-value block, grid-stride over the blocks. Lane j
// loads value j of its block, so a warp reads the block's 128 bytes in one
// coalesced load. The absmax and its lane come from a butterfly of
// shuffles (the lower lane wins a tie of |x|, as numpy's argmax returns the
// first maximum: it decides the scale's sign in a block holding v and -v);
// the high nibble of a Q4_0 / Q5_0 byte comes from lane j + 16 by a shuffle
// and Q5_0's fifth bits are one ballot, whose bit j is lane j's. The block
// is written as 16-bit words, one lane each (9, 11 or 17 lanes; a block is
// 2-byte aligned), the pairs of bytes gathered by shuffles; lane 0 writes
// the scale.
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ4_0 = 2;   // ggml type ids (gguf/quants.py)
constexpr int kQ5_0 = 6;
constexpr int kQ8_0 = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block

__device__ __forceinline__ unsigned short scale_bits(float d) {
  return __half_as_ushort(__float2half_rn(d));
}

// Lanes [first, first + n) each store one 16-bit word of the block: bytes
// src and src + 1 of the block's body, src = 2 * (lane - first), `byte`
// holding lane j's body byte j. Lane 0 stores the scale (word 0). A block
// is 2-byte aligned (18, 22 and 34 bytes from an aligned base).
__device__ __forceinline__ void store_words(uint8_t* blk, int lane, int first,
                                            int n, unsigned byte, float d) {
  const int src = (2 * (lane - first)) & 31;
  const unsigned lo = __shfl_sync(kFull, byte, src);
  const unsigned hi = __shfl_sync(kFull, byte, src + 1);
  unsigned short* w = reinterpret_cast<unsigned short*>(blk);
  if (lane == 0) {
    w[0] = scale_bits(d);
  } else if (lane >= first && lane < first + n) {
    w[lane] = static_cast<unsigned short>((lo & 0xffu) | ((hi & 0xffu) << 8));
  }
}

// The block's value of largest |x|, the lowest lane on a tie.
__device__ __forceinline__ float signed_absmax(float v, int lane) {
  float a = fabsf(v);
  int at = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oa = __shfl_xor_sync(kFull, a, off);
    const int ol = __shfl_xor_sync(kFull, at, off);
    if (oa > a || (oa == a && ol < at)) {
      a = oa;
      at = ol;
    }
  }
  return __shfl_sync(kFull, v, at);
}

__device__ __forceinline__ float absmax(float v) {
  float a = fabsf(v);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
  }
  return a;
}

template <int QT>
__global__ void __launch_bounds__(kWarps * 32)
    quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ out,
                    long long n_blocks) {
  constexpr int kBytes = QT == kQ4_0 ? 18 : QT == kQ5_0 ? 22 : 34;
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  for (long long b = static_cast<long long>(blockIdx.x) * kWarps +
                     (threadIdx.x >> 5);
       b < n_blocks; b += warps) {
    const float v = x[b * 32 + lane];
    uint8_t* blk = out + b * kBytes;
    if constexpr (QT == kQ8_0) {
      const float d = __fdiv_rn(absmax(v), 127.0f);
      const float inv = d > 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
      const float s = __fmul_rn(v, inv);
      float q = copysignf(floorf(__fadd_rn(fabsf(s), 0.5f)), s);
      q = fminf(fmaxf(q, -128.0f), 127.0f);
      const unsigned code = static_cast<uint8_t>(static_cast<int8_t>(q));
      store_words(blk, lane, 1, 16, code, d);   // words 1-16: the 32 codes
    } else {
      constexpr float kDiv = QT == kQ4_0 ? -8.0f : -16.0f;
      constexpr float kBias = QT == kQ4_0 ? 8.5f : 16.5f;
      constexpr float kTop = QT == kQ4_0 ? 15.0f : 31.0f;
      const float d = __fdiv_rn(signed_absmax(v, lane), kDiv);
      const float inv = d != 0.0f ? __fdiv_rn(1.0f, d) : 0.0f;
      const float s = fminf(fmaxf(__fadd_rn(__fmul_rn(v, inv), kBias), 0.0f),
                            kTop);
      const unsigned q = static_cast<unsigned>(s);   // truncation, s >= 0
      // lane j < 16: the byte of codes j (low nibble) and j + 16 (high)
      const unsigned nib = (q & 0xfu) | ((__shfl_down_sync(kFull, q, 16) & 0xfu) << 4);
      if constexpr (QT == kQ5_0) {
        // words 1-2: qh, bit j the fifth bit of code j; words 3-10: nibbles
        const unsigned qh = __ballot_sync(kFull, (q >> 4) & 1u);
        unsigned short* w = reinterpret_cast<unsigned short*>(blk);
        if (lane == 1) w[1] = static_cast<unsigned short>(qh & 0xffffu);
        if (lane == 2) w[2] = static_cast<unsigned short>(qh >> 16);
        store_words(blk, lane, 3, 8, nib, d);
      } else {
        store_words(blk, lane, 1, 8, nib, d);   // words 1-8: nibbles
      }
    }
  }
}

template <int QT>
int launch(const float* x, uint8_t* out, long long n_blocks,
           cudaStream_t stream) {
  // a warp per 32-value block, up to 132 x 64 thread blocks; past that the
  // warps stride over the rest
  long long grid = (n_blocks + kWarps - 1) / kWarps;
  if (grid > 132 * 64) grid = 132 * 64;
  quantize_kernel<QT><<<static_cast<unsigned>(grid), kWarps * 32, 0, stream>>>(
      x, out, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n_blocks * 32 float32 values; out: n_blocks * (18 | 22 | 34) bytes for
// qtype 2 (Q4_0), 6 (Q5_0) or 8 (Q8_0). Returns a cudaError_t.
extern "C" int tts_quantize_blocks(const float* x, uint8_t* out,
                                   long long n_blocks, int qtype,
                                   void* stream) {
  if (n_blocks <= 0) return 0;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (qtype) {
    case kQ4_0: return launch<kQ4_0>(x, out, n_blocks, s);
    case kQ5_0: return launch<kQ5_0>(x, out, n_blocks, s);
    case kQ8_0: return launch<kQ8_0>(x, out, n_blocks, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
