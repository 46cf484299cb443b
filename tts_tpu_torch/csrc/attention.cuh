// The decode attention's device code, shared by K3 / K4
// (decode_attention.cu: a grid of (slot, kv-head group) x page blocks whose
// last block to finish merges the pages) and the persistent K12
// (parler_flat.cu: the same pages and the same merge as work items of one
// launch, a grid barrier between them). Both call the same functions, so
// the split and the merge order are the same on either route.
//
// A page is 256 cache rows of one (slot, kv head), served by one block for
// the G q heads of the group that share that kv head (G divides n_rep; G =
// n_rep for the models here, so each K/V row comes from device memory once
// per kv head). Inside a block, NWARPS row-warps walk the page's rows for
// each q head; lanes that share a cache row each read 16 bytes of it (8
// lanes per 64-wide bf16 row), so a warp reads several whole rows per
// coalesced pass; each lane keeps an online-softmax state for its slice of
// D, merged across the warp with shuffles and across row-warps through
// shared memory. A warp issues the K and V loads of PF passes
// before their arithmetic, so a page is ceil(passes / PF) memory round
// trips, not two per pass. Each (slot, q head)'s pages' partial (max, sum,
// weighted V) are merged in page order; when only the first page is live
// the page writes the output itself.
//
// Every lane's arithmetic is the same as with one q head per block and one
// pass in flight: the rows a lane visits, their order and each sum are
// unchanged, so the outputs do not depend on G or PF.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace tts {
namespace attn {

constexpr int PAGE = 256;
constexpr int NWARPS = 4;  // warps that walk a page's rows

// 16 bytes at p. NC: through the read-only cache, for data no thread of the
// launch writes; K12 reads the cache rows it wrote itself with plain loads.
template <bool NC>
__device__ __forceinline__ uint4 load16(const void* p) {
  if constexpr (NC) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return *reinterpret_cast<const uint4*>(p);
  }
}

// The eight (bf16) or four (f32) elements of 16 loaded bytes.
template <typename T>
__device__ __forceinline__ void unpack16(uint4 v, float* out);

template <>
__device__ __forceinline__ void unpack16<float>(uint4 v, float* out) {
  out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
}

template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(uint4 v, float* out) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
  }
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

// The last page (0-based) a slot at position pos reads.
__device__ __forceinline__ int last_page(int pos) { return pos / PAGE; }

// Page `page` of item bg = s * (hq / G) + g, the q heads [g * G, g * G + G)
// of slot s, which share kv head g * G / n_rep (G divides n_rep). The
// block's first NWARPS * G warps work: warp w + NWARPS * j walks the rows
// of row-warp w for q head g * G + j. The G warps of a row-warp read the
// same rows at the same time, so a row comes from L2 or device memory once
// for the group (the others hit in L1). Later warps only join the barrier.
// pos is the slot's last row (ctx - 1 to attend every row). When pos lies
// in page 0 it writes out (s * hq + h, D) directly; else the page's partial
// state of each head h to part_ml (.., n_pages, 2) / part_acc (.., n_pages,
// D) at (s * hq + h) * n_pages + page. The slot reads q at q + s *
// q_bstride and its cache at kc/vc + s * kv_bstride. With a tail, the state
// (0, n_tail, tail[(s * hq + h) * D ..]) is merged last. Returns at once
// (for the whole block) for a page past pos.
template <typename T, int D, int G, bool NC, int PF>
__device__ __forceinline__ void attn_page(
    const float* q, const T* kc, const T* vc, int pos, float* out,
    float* part_ml, float* part_acc, int bg, int page, int n_pages, int hq,
    int n_rep, int ctx, long long q_bstride, long long kv_bstride,
    float scale, const float* tail, float n_tail) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = D / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;        // rows per warp pass
  constexpr int STEP = NWARPS * RPW;   // rows between a warp's passes
  static_assert(LPR <= 32 && 32 % LPR == 0, "unsupported head size");
  const int groups = hq / G;
  const int s = bg / groups, h0 = (bg % groups) * G;
  const int kvh = h0 / n_rep;
  const int row0 = page * PAGE;
  if (row0 > pos) return;  // past this slot's position: the merge skips it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % NWARPS, hj = warp / NWARPS;  // row-warp, head of the group
  const int sub = lane % LPR, r = lane / LPR;
  const int row_end = min(row0 + PAGE - 1, pos);  // inclusive

  __shared__ float sm_ml[NWARPS][G][2];
  __shared__ float sm_acc[NWARPS][G][D];
  if (warp < NWARPS * G) {
    const float* qs = q + (size_t)s * q_bstride + (size_t)(h0 + hj) * D;
    float qv[VEC], acc[VEC], m = -INFINITY, l = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qv[i] = qs[sub * VEC + i] * scale;
      acc[i] = 0.f;
    }
    const size_t head_off = (size_t)s * kv_bstride + (size_t)kvh * ctx * D + sub * VEC;
    const T* kp = kc + head_off;
    const T* vp = vc + head_off;
    // warp-uniform bounds, so that every lane joins the shuffles
    for (int base = row0 + rw * RPW; base <= row_end; base += PF * STEP) {
      uint4 kr[PF], vr[PF];
#pragma unroll
      for (int f = 0; f < PF; ++f) {
        const int t = base + f * STEP + r;
        if (t <= row_end) {
          kr[f] = load16<NC>(kp + (size_t)t * D);
          vr[f] = load16<NC>(vp + (size_t)t * D);
        } else {
          kr[f] = vr[f] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      // the scores of the PF passes first (independent of the running
      // state), then the state updates in row order
      float sc[PF];
#pragma unroll
      for (int f = 0; f < PF; ++f) {
        if (base + f * STEP > row_end) continue;
        float kv[VEC];
        unpack16<T>(kr[f], kv);
        sc[f] = 0.f;
        if (base + f * STEP + r <= row_end) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) sc[f] += qv[i] * kv[i];
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
          sc[f] += __shfl_xor_sync(0xffffffffu, sc[f], o);
        }
      }
#pragma unroll
      for (int f = 0; f < PF; ++f) {
        if (base + f * STEP + r > row_end) continue;
        float vv[VEC];
        unpack16<T>(vr[f], vv);
        const float mn = fmaxf(m, sc[f]);
        const float c = expf(m - mn);  // m = -inf -> 0
        const float p = expf(sc[f] - mn);
        l = l * c + p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = acc[i] * c + p * vv[i];
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
    if (r == 0) {
      if (sub == 0) { sm_ml[rw][hj][0] = m; sm_ml[rw][hj][1] = l; }
#pragma unroll
      for (int i = 0; i < VEC; ++i) sm_acc[rw][hj][sub * VEC + i] = acc[i];
    }
  }
  __syncthreads();
  // merge across the row-warps, in warp order
  if (threadIdx.x < NWARPS * G * 32) {
    for (int e = threadIdx.x; e < G * D; e += NWARPS * G * 32) {
      const int j = e / D, d = e % D;
      const size_t bh = (size_t)s * hq + h0 + j;
      float mm = -INFINITY, ll = 0.f, aa = 0.f;
      for (int w = 0; w < NWARPS; ++w) {
        merge<1>(mm, ll, &aa, sm_ml[w][j][0], sm_ml[w][j][1], &sm_acc[w][j][d]);
      }
      if (last_page(pos) == 0) {
        if (tail) merge<1>(mm, ll, &aa, 0.f, n_tail, &tail[bh * D + d]);
        out[bh * D + d] = aa / ll;
      } else {
        const size_t pi = bh * n_pages + page;
        part_acc[pi * D + d] = aa;
        if (d == 0) { part_ml[pi * 2] = mm; part_ml[pi * 2 + 1] = ll; }
      }
    }
  }
}

// Element d of item bh's output (bh = s * hq + h): merge its pages
// [0, last] in page order, then the tail when there is one. The partials
// are read through L2 (another block of the launch wrote them), eight
// pages' loads issued before their merges.
__device__ __forceinline__ void attn_combine(
    const float* part_ml, const float* part_acc, int last, float* out, int bh,
    int n_pages, int D, const float* tail, float n_tail, int d) {
  constexpr int BATCH = 8;
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int p0 = 0; p0 <= last; p0 += BATCH) {
    float m2[BATCH], l2[BATCH], a2[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const size_t pi = (size_t)bh * n_pages + min(p0 + k, last);
      m2[k] = __ldcg(&part_ml[pi * 2]);
      l2[k] = __ldcg(&part_ml[pi * 2 + 1]);
      a2[k] = __ldcg(&part_acc[pi * D + d]);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      if (p0 + k <= last) merge<1>(m, l, &a, m2[k], l2[k], &a2[k]);
    }
  }
  if (tail) merge<1>(m, l, &a, 0.f, n_tail, &tail[(size_t)bh * D + d]);
  out[(size_t)bh * D + d] = a / l;
}

// After attn_page of a multi-page item (every thread of the block): the
// block that finishes the item's live pages last merges them for its G
// heads. arrivals[bg] counts the pages done; the last block resets it to
// 0, so the counters are zero again after every launch and need no
// clearing between launches (the caller zeroes them once).
template <int D, int G>
__device__ __forceinline__ void attn_finish(
    const float* part_ml, const float* part_acc, unsigned int* arrivals,
    int pos, float* out, int bg, int n_pages, int hq, const float* tail,
    float n_tail) {
  __shared__ bool is_last;
  __threadfence();  // this block's partials, visible before it arrives
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int done = atomicAdd(&arrivals[bg], 1u) + 1u;
    is_last = done == (unsigned int)(last_page(pos) + 1);
    if (is_last) arrivals[bg] = 0u;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int groups = hq / G;
  const int s = bg / groups, h0 = (bg % groups) * G;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) {
    attn_combine(part_ml, part_acc, last_page(pos), out, s * hq + h0 + e / D,
                 n_pages, D, tail, n_tail, e % D);
  }
}

}  // namespace attn
}  // namespace tts
