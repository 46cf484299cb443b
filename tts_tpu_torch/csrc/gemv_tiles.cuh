// The tensor-core pieces shared by the two block-dequant GEMVs: the llama /
// Dia GEMV (gemv.cuh, K6-K11) and the Parler GEMV (parler_gemv.cuh, K2, K5
// and K12). Both stream weights tiled at prep (a warp's tile is 16 weight
// rows; ops/llama_megastep.py gemv_tile lays them out) through a ring of
// shared-memory stages fed by 16-byte cp.async copies, dequantize each
// stage straight into the A fragments of mma.sync m16n8k16 (bf16 in, f32
// out), and read the input rows, staged once per block as bf16, as the B
// operand. Here: the stage layout and its copier, the dequantization into
// A fragments with the `_dqdot` rounding, the staged rows' stride, the
// PTX wrappers and the SM count.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dequant.cuh"

namespace tts {

constexpr int UNIT_BLOCKS = 4;       // 32-weight blocks of a row in one ring stage
constexpr int UNIT_K = UNIT_BLOCKS * QK;

// One ring stage of a warp: UNIT_BLOCKS consecutive 32-weight blocks of its
// tile's 16 rows. Codes block-major, [block][row][CB bytes]; scales
// row-major, [row][block].
template <bool PACKED, bool SBF16>
struct Stage {
  static constexpr int CB = PACKED ? 16 : 32;
  static constexpr int CODES = UNIT_BLOCKS * 16 * CB;
  static constexpr int SB = SBF16 ? 2 : 4;
  static constexpr int BYTES = CODES + 16 * UNIT_BLOCKS * SB;
};

// Bytes between two staged input rows of kr elements: kr bf16, padded so
// that rows g and g + 1 start 32 bytes apart in the banks (a quarter warp's
// B-fragment loads of 4 rows then fill the 32 banks once).
__host__ __device__ inline int xs_stride(int kr) {
  return (kr * 2 + 127) / 128 * 128 + 32;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// D += A B on the tensor cores: m16n8k16, bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// Dequantization into A fragments
// ---------------------------------------------------------------------------
//
// The k order inside a block. Thread t of a quad supplies, for k16 step s
// of a 32-weight block, the weights e, e + 2 (its k 2t, 2t + 1) and e + 1,
// e + 3 (its k 2t + 8, 2t + 9), e = 16 s + 4 t: for Q4_0 the low (s = 0) or
// high (s = 1) nibbles of bytes 4t..4t+3 of the block (ggml's byte j holds
// weights j and j + 16), one 32-bit word. The staged input rows hold each
// group of 4 elements in the order 0, 2, 1, 3, so that the thread's B
// fragment for the same k is one 8-byte load. A sum over k does not depend
// on which k a weight takes, only on the pairing, which this keeps.

// Two bf16 (a in the low half) as one register.
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Q4_0 nibbles at bits 0-3 and 16-19 of v, scale s2 (bf16 in both halves):
// bf16x2 of (q - 8) * s, each rounded once. 0x4300 | q is the bf16 of 128 +
// q; less 136 it is q - 8 exactly, and the product of that with a bf16
// scale, rounded to bf16, is the f32 product rounded to bf16 (the f32
// product is exact).
__device__ __forceinline__ uint32_t dq_q4_bf16(uint32_t v, __nv_bfloat162 s2) {
  const uint32_t m = (v & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 bias = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                 __ushort_as_bfloat16(0x4308));
  const __nv_bfloat162 w =
      __hmul2(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m), bias), s2);
  return *reinterpret_cast<const uint32_t*>(&w);
}

// The generic path: codes c0 (low half) and c1 as float, times s in f32,
// rounded to bf16 (for f32 scales the rounding of the reference, which
// rounds the f32 product).
template <int QT>
__device__ __forceinline__ uint32_t dq_pair(uint32_t c0, uint32_t c1, float s) {
  return pack_bf16x2(code_value<QT>(c0) * s, code_value<QT>(c1) * s);
}

// The A fragments of block jb of a stage for thread (g, t), both k16 steps:
// a[s] = {row g (e, e + 2), row g + 8 (e, e + 2), row g (e + 1, e + 3), row
// g + 8 (e + 1, e + 3)}.
template <int QT, bool PACKED, bool SBF16>
__device__ __forceinline__ void a_frags(const uint8_t* st, int jb, int g, int t,
                                        uint32_t a[2][4]) {
  using S = Stage<PACKED, SBF16>;
  const uint8_t* sc = st + S::CODES;
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // h 0: row g ("a"), 1: row g + 8 ("b")
    const int row = g + 8 * h;
    const uint8_t* cb = st + (jb * 16 + row) * S::CB + 4 * t;
    if constexpr (PACKED) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(cb);
      if constexpr (SBF16) {
        const __nv_bfloat16 s = reinterpret_cast<const __nv_bfloat16*>(sc)[row * UNIT_BLOCKS + jb];
        const __nv_bfloat162 s2 = __bfloat162bfloat162(s);
        a[0][h] = dq_q4_bf16(w, s2);
        a[0][2 + h] = dq_q4_bf16(w >> 8, s2);
        a[1][h] = dq_q4_bf16(w >> 4, s2);
        a[1][2 + h] = dq_q4_bf16(w >> 12, s2);
      } else {
        const float s = reinterpret_cast<const float*>(sc)[row * UNIT_BLOCKS + jb];
        a[0][h] = dq_pair<QT>(w & 15u, (w >> 16) & 15u, s);
        a[0][2 + h] = dq_pair<QT>((w >> 8) & 15u, (w >> 24) & 15u, s);
        a[1][h] = dq_pair<QT>((w >> 4) & 15u, (w >> 20) & 15u, s);
        a[1][2 + h] = dq_pair<QT>((w >> 12) & 15u, w >> 28, s);
      }
    } else {
      const float s = SBF16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                                  sc)[row * UNIT_BLOCKS + jb])
                            : reinterpret_cast<const float*>(sc)[row * UNIT_BLOCKS + jb];
#pragma unroll
      for (int st2 = 0; st2 < 2; ++st2) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(cb + 16 * st2);
        a[st2][h] = dq_pair<QT>(w & 0xFFu, (w >> 16) & 0xFFu, s);
        a[st2][2 + h] = dq_pair<QT>((w >> 8) & 0xFFu, w >> 24, s);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The weight stream
// ---------------------------------------------------------------------------

// A warp's copies of its tile's stages. The weights are tiled at prep
// (ops/llama_megastep.py gemv_tile): tile t of a projection is `stages` =
// K / 128 stages in a row, each the codes of one stage in the ring's own
// layout (S::CODES bytes) in one tensor and its scales (S::BYTES -
// S::CODES bytes) in another. So a stage is two contiguous runs, and a
// warp streams its tile's K range as one run of codes and one of scales.
template <bool PACKED, bool SBF16>
struct Copier {
  using S = Stage<PACKED, SBF16>;
  static constexpr int SCALES = S::BYTES - S::CODES;
  const uint8_t* codes;    // the tile's first stage of this warp's K range
  const uint8_t* scales;

  __device__ __forceinline__ void set_tile(int tile, const uint8_t* codes_t,
                                           const void* scales_t, int stages,
                                           int first_stage) {
    const size_t at = (size_t)tile * stages + first_stage;
    codes = codes_t + at * S::CODES;
    scales = reinterpret_cast<const uint8_t*>(scales_t) + at * SCALES;
  }

  // Issue the copies of stage c of the range into st: 16 bytes a lane at a
  // time, neighbouring lanes on neighbouring bytes.
  __device__ __forceinline__ void issue(uint8_t* st, int c, int lane) const {
    const uint8_t* cs = codes + (size_t)c * S::CODES;
#pragma unroll
    for (int i = 0; i < S::CODES / 512; ++i) {
      cp_async16(st + 16 * (lane + 32 * i), cs + 16 * (lane + 32 * i));
    }
    if (lane < SCALES / 16) {
      cp_async16(st + S::CODES + 16 * lane, scales + (size_t)c * SCALES + 16 * lane);
    }
  }
};

// The card's SMs, asked once (the current device's at the first call).
inline int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

}  // namespace tts
