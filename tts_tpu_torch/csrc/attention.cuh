// The decode attention's device code, shared by K3 / K4
// (decode_attention.cu: a grid of (slot, kv-head group) x page blocks whose
// last block to finish merges the pages) and the persistent steps K12
// (parler_flat.cu), K10 (dia_flat.cu) and K8 / K6 (llama_flat.cu): the same
// pages and the same merge as work items of one launch, a grid barrier
// between them. All call the same functions, so the split and the merge
// order are the same on every route. Head sizes: head_size_ok below.
//
// A page is 256 cache rows of one (slot, kv head), served by one block for
// the G q heads of a group (K3 / K4 take G = n_rep for the models here, so
// each K/V row comes from device memory once per kv head; where G does not
// divide n_rep, a group's heads may read two kv heads). Inside a block,
// NWARPS row-warps walk the page's rows for each q head; lanes that share
// a cache row each read 16 bytes of it (8 lanes per 64-wide bf16 row), so
// a warp reads several whole rows per coalesced pass; each lane keeps an
// online-softmax state for its slice of D, merged across the warp with
// shuffles and across row-warps through shared memory. A warp issues the
// K and V loads of PF passes before their arithmetic, so a page is
// ceil(passes / PF) memory round trips, not two per pass. Each (slot, q
// head)'s pages' partial (max, sum, weighted V) are merged in page order;
// when only the first page is live the page writes the output itself.
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

// The first n (1 .. 16 / sizeof(T)) elements at p, which may sit on any
// element boundary, as 16 bytes laid out as load16 gives them (the rest
// zero): the generic path's loads where a row is not whole 16-byte chunks
// on 16-byte boundaries (D not a multiple of 8 for bf16, of 4 for f32).
template <typename T, bool NC>
__device__ __forceinline__ uint4 load_part(const T* p, int n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
    const unsigned int* u = reinterpret_cast<const unsigned int*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < n) w[i] = NC ? __ldg(u + i) : u[i];
    }
  } else {
    const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < n) w[i / 2] |= (uint32_t)(NC ? __ldg(u + i) : u[i]) << (16 * (i % 2));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
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

// The head sizes the pages take: every D from 1 to MAX_D, for bf16 and
// f32 caches (ops/decode_attention.py head_size_ok is the same rule). A
// row of D elements is C = ceil(D / VEC) chunks of 16 bytes, the last one
// short where VEC does not divide D (it is then read element by element,
// load_part, as is every chunk of such a row: its rows do not start on
// 16-byte boundaries). LPR lanes share a row, the smallest power of two
// >= C but at most 32, so that a warp reads RPW = 32 / LPR rows a pass;
// lane sub of a row takes chunks sub, sub + LPR, ... (CPL of them). Where
// C is a power of two up to 32 (bf16 D 64 / 128 / 256, f32 D 64 / 128)
// each lane takes one chunk and no lane idles; where it is not (D 80, 96,
// 192, 100) the lanes past C idle; past 32 chunks a lane takes several.
//
// The limit: a lane holds E = CPL * VEC elements of q, E of the
// accumulator and, while the warp merges, E of its partner's, plus the
// PF * CPL * 8 words of its loads in flight. The generic path compiles
// three widths DCAP (256, 512, 1024: E = 8, 16, 32 for bf16 and f32
// alike) with PF * CPL <= 8, so at 1024 a lane holds 3 * 32 + 64 = 160 of
// the 255 registers a thread can address; 2048 would hold 3 * 64 + 64 =
// 256, past them. Shared memory: the row-warps' merge keeps NWARPS * G *
// DCAP floats, 16 * G * DCAP bytes, within the 48 KB a block has without
// an opt-in for G <= 2 at 1024 (32 KB) and G <= 4 at 512 (32 KB).
constexpr int MAX_D = 1024;

__host__ __device__ constexpr bool head_size_ok(int d) {
  return d >= 1 && d <= MAX_D;
}

// The generic path's compiled width for heads of d (head_size_ok).
__host__ __device__ constexpr int generic_cap(int d) {
  return d <= 256 ? 256 : d <= 512 ? 512 : 1024;
}

__host__ __device__ constexpr int lanes_per_row(int chunks) {
  int l = 1;
  while (l < chunks && l < 32) l <<= 1;
  return l;
}

// Page `page` of item bg = s * (hq / G) + g, the q heads [g * G, g * G + G)
// of slot s (G divides hq); head h reads kv head h / n_rep. The block's
// first NWARPS * G warps work: warp w + NWARPS * j walks the rows of
// row-warp w for q head g * G + j. Where G divides n_rep the group's heads
// share one kv head, and its G warps of a row-warp read the same rows at
// the same time, so a row comes from L2 or device memory once for the
// group (the others hit in L1). Later warps only join the barrier.
// pos is the slot's last row (ctx - 1 to attend every row). When pos lies
// in page 0 it writes out (s * hq + h, D) directly; else the page's partial
// state of each head h to part_ml (.., n_pages, 2) / part_acc (.., n_pages,
// D) at (s * hq + h) * n_pages + page. The slot reads q at q + s *
// q_bstride and its cache at kc/vc + s * kv_bstride. With a tail, the state
// (0, n_tail, tail[(s * hq + h) * D ..]) is merged last. Returns at once
// (for the whole block) for a page past pos. D > 0 fixes the head size at
// compile time (the models' 64 and 128); D = 0 takes any head size d up to
// DCAP (generic_cap) at run time, with registers and shared memory for
// DCAP. WHOLE: d's rows are whole 16-byte chunks (d a multiple of VEC),
// read 16 bytes at a time; else element by element (load_part). A
// compile-time choice: on an H100 a run-time branch in the load loop
// slowed K4 at heads of 80 / 192 / 256 by ~40%.
template <typename T, int D, int G, bool NC, int PF, int DCAP = D,
          bool WHOLE = true>
__device__ __forceinline__ void attn_page(
    const float* q, const T* kc, const T* vc, int pos, float* out,
    float* part_ml, float* part_acc, int bg, int page, int n_pages, int hq,
    int n_rep, int ctx, long long q_bstride, long long kv_bstride,
    float scale, const float* tail, float n_tail, int d = D) {
  constexpr int VEC = 16 / sizeof(T);                   // elements per 16-byte load
  constexpr int DMAX = D > 0 ? D : DCAP;
  constexpr int LPR_MAX = lanes_per_row(DMAX / VEC);
  constexpr int CPL = (DMAX / VEC + LPR_MAX - 1) / LPR_MAX;   // chunks a lane holds at most
  constexpr int E = CPL * VEC;                          // elements a lane holds
  static_assert(head_size_ok(DMAX) && DMAX % VEC == 0, "unsupported head size");
  const int dd = D > 0 ? D : d;
  const int chunks = WHOLE ? dd / VEC : (dd + VEC - 1) / VEC;
  static_assert(D == 0 || WHOLE, "a compiled head size has whole chunks");
  const int LPR = D > 0 ? LPR_MAX : lanes_per_row(chunks);   // lanes per cache row
  const int RPW = 32 / LPR;                             // rows per warp pass
  const int STEP = NWARPS * RPW;                        // rows between a warp's passes
  const int groups = hq / G;
  const int s = bg / groups, h0 = (bg % groups) * G;
  const int row0 = page * PAGE;
  if (row0 > pos) return;  // past this slot's position: the merge skips it
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = warp % NWARPS, hj = warp / NWARPS;  // row-warp, head of the group
  const int sub = lane % LPR, r = lane / LPR;
  const int row_end = min(row0 + PAGE - 1, pos);  // inclusive

  __shared__ float sm_ml[NWARPS][G][2];
  __shared__ float sm_acc[NWARPS][G][DMAX];
  if (warp < NWARPS * G) {
    const float* qs = q + (size_t)s * q_bstride + (size_t)(h0 + hj) * dd;
    float qv[E], acc[E], m = -INFINITY, l = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = sub + LPR * j;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const bool in = WHOLE ? c < chunks : c * VEC + i < dd;
        qv[j * VEC + i] = in ? qs[c * VEC + i] * scale : 0.f;
        acc[j * VEC + i] = 0.f;
      }
    }
    const int kvh = (h0 + hj) / n_rep;
    const size_t head_off = (size_t)s * kv_bstride + (size_t)kvh * ctx * dd + sub * VEC;
    const T* kp = kc + head_off;
    const T* vp = vc + head_off;
    // warp-uniform bounds, so that every lane joins the shuffles
    for (int base = row0 + rw * RPW; base <= row_end; base += PF * STEP) {
      uint4 kr[PF][CPL], vr[PF][CPL];
#pragma unroll
      for (int f = 0; f < PF; ++f) {
        const int t = base + f * STEP + r;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = sub + LPR * j;
          if (t <= row_end && c < chunks) {
            if constexpr (WHOLE) {
              kr[f][j] = load16<NC>(kp + (size_t)t * dd + LPR * j * VEC);
              vr[f][j] = load16<NC>(vp + (size_t)t * dd + LPR * j * VEC);
            } else {
              const int n = min(VEC, dd - c * VEC);
              kr[f][j] = load_part<T, NC>(kp + (size_t)t * dd + LPR * j * VEC, n);
              vr[f][j] = load_part<T, NC>(vp + (size_t)t * dd + LPR * j * VEC, n);
            }
          } else {
            kr[f][j] = vr[f][j] = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
      // the scores of the PF passes first (independent of the running
      // state), then the state updates in row order
      float sc[PF];
#pragma unroll
      for (int f = 0; f < PF; ++f) {
        if (base + f * STEP > row_end) continue;
        sc[f] = 0.f;
        if (base + f * STEP + r <= row_end) {
#pragma unroll
          for (int j = 0; j < CPL; ++j) {
            float kv[VEC];
            unpack16<T>(kr[f][j], kv);
#pragma unroll
            for (int i = 0; i < VEC; ++i) sc[f] += qv[j * VEC + i] * kv[i];
          }
        }
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) {
          sc[f] += __shfl_xor_sync(0xffffffffu, sc[f], o);
        }
      }
#pragma unroll
      for (int f = 0; f < PF; ++f) {
        if (base + f * STEP + r > row_end) continue;
        const float mn = fmaxf(m, sc[f]);
        const float c = expf(m - mn);  // m = -inf -> 0
        const float p = expf(sc[f] - mn);
        l = l * c + p;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          float vv[VEC];
          unpack16<T>(vr[f][j], vv);
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            acc[j * VEC + i] = acc[j * VEC + i] * c + p * vv[i];
          }
        }
        m = mn;
      }
    }
    // merge the RPW row groups of the warp (lanes with the same `sub`)
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
      const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
      float a2[E];
#pragma unroll
      for (int i = 0; i < E; ++i) a2[i] = __shfl_xor_sync(0xffffffffu, acc[i], o);
      merge<E>(m, l, acc, m2, l2, a2);
    }
    if (r == 0) {
      if (sub == 0) { sm_ml[rw][hj][0] = m; sm_ml[rw][hj][1] = l; }
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = sub + LPR * j;
        if (c < chunks) {
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            if (WHOLE || c * VEC + i < dd) {
              sm_acc[rw][hj][c * VEC + i] = acc[j * VEC + i];
            }
          }
        }
      }
    }
  }
  __syncthreads();
  // merge across the row-warps, in warp order
  if (threadIdx.x < NWARPS * G * 32) {
    for (int e = threadIdx.x; e < G * dd; e += NWARPS * G * 32) {
      const int j = e / dd, dx = e % dd;
      const size_t bh = (size_t)s * hq + h0 + j;
      float mm = -INFINITY, ll = 0.f, aa = 0.f;
      for (int w = 0; w < NWARPS; ++w) {
        merge<1>(mm, ll, &aa, sm_ml[w][j][0], sm_ml[w][j][1], &sm_acc[w][j][dx]);
      }
      if (last_page(pos) == 0) {
        if (tail) merge<1>(mm, ll, &aa, 0.f, n_tail, &tail[bh * dd + dx]);
        out[bh * dd + dx] = aa / ll;
      } else {
        const size_t pi = bh * n_pages + page;
        part_acc[pi * dd + dx] = aa;
        if (dx == 0) { part_ml[pi * 2] = mm; part_ml[pi * 2 + 1] = ll; }
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
    float n_tail, int d = D) {
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
  const int dd = D > 0 ? D : d;
  for (int e = threadIdx.x; e < G * dd; e += blockDim.x) {
    attn_combine(part_ml, part_acc, last_page(pos), out, s * hq + h0 + e / dd,
                 n_pages, dd, tail, n_tail, e % dd);
  }
}

// attn_finish for the persistent steps K12 and K9 / K7's layer stack: one
// add a block, with acquire-release semantics at device scope by thread 0
// after a block barrier, which orders the block's partials before it (as
// grid_sync.cuh orders a phase's writes), where attn_finish fences every
// thread before its add and again after it. The same merge, so the same
// bits; it ran faster inside K12's launch than attn_finish (an A/B of the
// two on the H100).
template <int D, int G>
__device__ __forceinline__ void attn_finish_acq_rel(
    const float* part_ml, const float* part_acc, unsigned int* arrivals,
    int pos, float* out, int bg, int n_pages, int hq, int d = D) {
  __shared__ bool is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(arrivals + bg)
                 : "memory");
    is_last = old + 1u == (unsigned int)(last_page(pos) + 1);
    if (is_last) arrivals[bg] = 0u;
  }
  __syncthreads();
  if (!is_last) return;
  const int groups = hq / G;
  const int s = bg / groups, h0 = (bg % groups) * G;
  const int dd = D > 0 ? D : d;
  for (int e = threadIdx.x; e < G * dd; e += blockDim.x) {
    attn_combine(part_ml, part_acc, last_page(pos), out, s * hq + h0 + e / dd,
                 n_pages, dd, nullptr, 0.f, e % dd);
  }
}

}  // namespace attn
}  // namespace tts
