// The decode attention's device code, shared by K3 / K4
// (decode_attention.cu, a grid of (slot, head) x page blocks and a combine
// launch) and the persistent K12 (parler_flat.cu, the same pages and the
// same combine as work items of one launch). Both call the same functions,
// so the split and the merge order are the same on either route.
//
// A page is 256 cache rows of one (slot, q head). Inside a block, NWARPS
// warps walk the page's rows; lanes that share a cache row each read 16
// bytes of it (8 lanes per 64-wide bf16 row), so a warp reads several whole
// rows per coalesced pass; each lane keeps an online-softmax state for its
// slice of D, merged across the warp with shuffles and across warps through
// shared memory. The combine merges each (slot, head)'s pages' partial
// (max, sum, weighted V) in page order; with one page the page writes the
// output itself.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace tts {
namespace attn {

constexpr int PAGE = 256;
constexpr int NWARPS = 4;  // warps that walk a page's rows

// Eight (bf16) or four (f32) elements from 16 bytes at p. NC: through the
// read-only cache, for data no thread of the launch writes; K12 reads the
// cache rows it wrote itself with plain loads.
template <typename T, bool NC>
__device__ __forceinline__ void load_vec(const T* p, float* out);

template <>
__device__ __forceinline__ void load_vec<float, true>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_vec<float, false>(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void bf16x8(uint4 v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, true>(
    const __nv_bfloat16* p, float* out) {
  bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), out);
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16, false>(
    const __nv_bfloat16* p, float* out) {
  bf16x8(*reinterpret_cast<const uint4*>(p), out);
}

// Merge online-softmax state (m2, l2, a2) into (m, l, a).
template <int VEC>
__device__ __forceinline__ void merge(float& m, float& l, float* a, float m2,
                                      float l2, const float* a2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both empty
  const float c1 = (m == -INFINITY) ? 0.f : expf(m - mn);
  const float c2 = (m2 == -INFINITY) ? 0.f : expf(m2 - mn);
  l = l * c1 + l2 * c2;
#pragma unroll
  for (int i = 0; i < VEC; ++i) a[i] = a[i] * c1 + a2[i] * c2;
  m = mn;
}

// Page `page` of item bh = s * hq + h, called by every thread of a block of
// at least NWARPS warps (warps past NWARPS only join the barriers). pos is
// the slot's last row (ctx - 1 to attend every row). Writes out (bh, D)
// directly when n_pages == 1, else the page's partial state to part_ml
// (.., n_pages, 2) / part_acc (.., n_pages, D) at bh * n_pages + page. The
// slot reads q at q + s * q_bstride and its cache at kc/vc + s * kv_bstride.
// With a tail, the state (0, n_tail, tail[bh * D ..]) is merged last.
// Returns at once (for the whole block) for a page past pos.
template <typename T, int D, bool NC>
__device__ __forceinline__ void attn_page(
    const float* q, const T* kc, const T* vc, int pos, float* out,
    float* part_ml, float* part_acc, int bh, int page, int n_pages, int hq,
    int n_rep, int ctx, long long q_bstride, long long kv_bstride,
    float scale, const float* tail, float n_tail) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = D / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;        // rows per warp pass
  static_assert(LPR <= 32 && 32 % LPR == 0, "unsupported head size");
  const int s = bh / hq, h = bh % hq;
  const int kvh = h / n_rep;
  const int row0 = page * PAGE;
  if (row0 > pos) return;  // past this slot's position: the combine skips it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % LPR, r = lane / LPR;
  const int row_end = min(row0 + PAGE - 1, pos);  // inclusive

  __shared__ float sm_ml[NWARPS][2];
  __shared__ float sm_acc[NWARPS][D];
  if (warp < NWARPS) {
    const float* qs = q + (size_t)s * q_bstride + (size_t)h * D;
    float qv[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) qv[i] = qs[sub * VEC + i] * scale;

    float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

    const size_t head_off = (size_t)s * kv_bstride + (size_t)kvh * ctx * D + sub * VEC;
    // warp-uniform bound so every lane joins the shuffles
    for (int base = row0 + warp * RPW; base <= row_end; base += NWARPS * RPW) {
      const int t = base + r;
      const bool valid = t <= row_end;
      float kv[VEC];
      float sc = 0.f;
      if (valid) {
        load_vec<T, NC>(kc + head_off + (size_t)t * D, kv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) sc += qv[i] * kv[i];
      }
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      if (valid) {
        load_vec<T, NC>(vc + head_off + (size_t)t * D, kv);
        const float mn = fmaxf(m, sc);
        const float c = expf(m - mn);  // m = -inf -> 0
        const float p = expf(sc - mn);
        l = l * c + p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = acc[i] * c + p * kv[i];
        m = mn;
      }
    }
    // merge the RPW row groups of the warp (lanes with the same `sub`)
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      float a2[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) a2[i] = __shfl_xor_sync(0xffffffffu, acc[i], o);
      merge<VEC>(m, l, acc, m2, l2, a2);
    }
    // merge across warps through shared memory
    if (r == 0) {
      if (sub == 0) { sm_ml[warp][0] = m; sm_ml[warp][1] = l; }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[warp][sub * VEC + i] = acc[i];
    }
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NWARPS * 32) {
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
    for (int w = 0; w < NWARPS; ++w) merge<1>(mm, ll, &aa, sm_ml[w][0], sm_ml[w][1], &sm_acc[w][d]);
    if (n_pages == 1) {
      if (tail) merge<1>(mm, ll, &aa, 0.f, n_tail, &tail[(size_t)bh * D + d]);
      out[(size_t)bh * D + d] = aa / ll;
    } else {
      const size_t pi = (size_t)bh * n_pages + page;
      part_acc[pi * D + d] = aa;
      if (d == 0) { part_ml[pi * 2] = mm; part_ml[pi * 2 + 1] = ll; }
    }
  }
}

// Element d of item bh's output: merge its pages [0, last] in page order,
// then the tail when there is one.
__device__ __forceinline__ void attn_combine(
    const float* part_ml, const float* part_acc, int last, float* out, int bh,
    int n_pages, int D, const float* tail, float n_tail, int d) {
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int p = 0; p <= last; ++p) {
    const size_t pi = (size_t)bh * n_pages + p;
    merge<1>(m, l, &a, part_ml[pi * 2], part_ml[pi * 2 + 1], &part_acc[pi * D + d]);
  }
  if (tail) merge<1>(m, l, &a, 0.f, n_tail, &tail[(size_t)bh * D + d]);
  out[(size_t)bh * D + d] = a / l;
}

}  // namespace attn
}  // namespace tts
