// K3: single-query decode attention over a KV cache, reading rows [0, pos].
//
// Replaces the TPU kernel tts_tpu/ops/decode_attention.py:_kernel (wrapper
// paged_decode_attention): q (Hq, D), k/v (Hkv, CTX, D) in bf16 or f32,
// GQA (q head h reads kv head h / n_rep), softmax in f32 with a running max
// and sum. `pos` is read from device memory, so a decode loop never has to
// bring it to the host.
//
// What bounds it on the H100: every K and V row up to pos is read once and
// used for 2 flops per element: memory bandwidth (plus launch latency at
// short contexts).
//
// Design: the TPU kernel walks 256-row pages in a sequential grid, carrying
// the running max/sum in VMEM scratch. Blocks on the H100 run in no order,
// so here each 256-row page of each q head is its own block (grid
// (Hq, CTX / 256)); pages past pos exit at once. Inside a block, lanes that
// share a cache row each read 16 bytes of it (8 lanes per 64-wide bf16 row),
// so a warp reads several whole rows per coalesced pass; each lane keeps an
// online-softmax state for its slice of D, merged across the warp with
// shuffles and across warps through shared memory. A second kernel merges
// the pages' partial (max, sum, weighted V) into the output; with one page
// (a context of at most 256 rows, e.g. cross-attention) the first kernel
// writes the output itself.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PAGE = 256;
constexpr int NWARPS = 4;

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out);

template <>
__device__ __forceinline__ void load_vec<float>(const float* p, float* out) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

template <>
__device__ __forceinline__ void load_vec<__nv_bfloat16>(const __nv_bfloat16* p,
                                                        float* out) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
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

// Grid (Hq, n_pages). Writes out (Hq, D) directly when n_pages == 1, else
// the page's partial state to part_ml (Hq, n_pages, 2) / part_acc
// (Hq, n_pages, D).
template <typename T, int D>
__global__ void __launch_bounds__(NWARPS * 32)
attn_page_kernel(const float* __restrict__ q, const T* __restrict__ kc,
                 const T* __restrict__ vc, const int* __restrict__ pos_ptr,
                 float* __restrict__ out, float* __restrict__ part_ml,
                 float* __restrict__ part_acc, int n_rep, int ctx,
                 float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int LPR = D / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;        // rows per warp pass
  static_assert(LPR <= 32 && 32 % LPR == 0, "unsupported head size");
  const int h = blockIdx.x, page = blockIdx.y, n_pages = gridDim.y;
  const int kvh = h / n_rep;
  const int pos = min(*pos_ptr, ctx - 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % LPR, r = lane / LPR;
  const int row0 = page * PAGE;
  const int row_end = min(row0 + PAGE - 1, pos);  // inclusive

  float qv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) qv[i] = q[h * D + sub * VEC + i] * scale;

  float m = -INFINITY, l = 0.f, acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  const size_t head_off = (size_t)kvh * ctx * D + sub * VEC;
  // warp-uniform bound so every lane joins the shuffles
  for (int base = row0 + warp * RPW; base <= row_end; base += NWARPS * RPW) {
    const int t = base + r;
    const bool valid = t <= row_end;
    float kv[VEC];
    float s = 0.f;
    if (valid) {
      load_vec<T>(kc + head_off + (size_t)t * D, kv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s += qv[i] * kv[i];
    }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (valid) {
      load_vec<T>(vc + head_off + (size_t)t * D, kv);
      const float mn = fmaxf(m, s);
      const float c = expf(m - mn);  // m = -inf -> 0
      const float p = expf(s - mn);
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
  __shared__ float sm_ml[NWARPS][2];
  __shared__ float sm_acc[NWARPS][D];
  if (r == 0) {
    if (sub == 0) { sm_ml[warp][0] = m; sm_ml[warp][1] = l; }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[warp][sub * VEC + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += NWARPS * 32) {
    float mm = -INFINITY, ll = 0.f, aa = 0.f;
    for (int w = 0; w < NWARPS; ++w) merge<1>(mm, ll, &aa, sm_ml[w][0], sm_ml[w][1], &sm_acc[w][d]);
    if (n_pages == 1) {
      out[h * D + d] = aa / ll;
    } else {
      const size_t pi = (size_t)h * n_pages + page;
      part_acc[pi * D + d] = aa;
      if (d == 0) { part_ml[pi * 2] = mm; part_ml[pi * 2 + 1] = ll; }
    }
  }
}

// Grid (Hq), D threads: merge the pages' partial states.
__global__ void attn_combine_kernel(const float* __restrict__ part_ml,
                                    const float* __restrict__ part_acc,
                                    float* __restrict__ out, int n_pages,
                                    int D) {
  const int h = blockIdx.x, d = threadIdx.x;
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int p = 0; p < n_pages; ++p) {
    const size_t pi = (size_t)h * n_pages + p;
    merge<1>(m, l, &a, part_ml[pi * 2], part_ml[pi * 2 + 1], &part_acc[pi * D + d]);
  }
  out[h * D + d] = a / l;
}

template <typename T, int D>
void launch(const float* q, const void* kc, const void* vc, const int* pos,
            float* out, float* part_ml, float* part_acc, int hq, int n_rep,
            int ctx, float scale, cudaStream_t s) {
  const int n_pages = (ctx + PAGE - 1) / PAGE;
  attn_page_kernel<T, D><<<dim3(hq, n_pages), NWARPS * 32, 0, s>>>(
      q, reinterpret_cast<const T*>(kc), reinterpret_cast<const T*>(vc), pos,
      out, part_ml, part_acc, n_rep, ctx, scale);
  if (n_pages > 1) {
    attn_combine_kernel<<<hq, D, 0, s>>>(part_ml, part_acc, out, n_pages, D);
  }
}

}  // namespace

// q (hq, d) f32; kc/vc (hq / n_rep, ctx, d), bf16 (cache_bf16) or f32; pos a
// device int32; out (hq, d) f32; part_ml (hq, ceil(ctx/256), 2) and part_acc
// (hq, ceil(ctx/256), d) f32 scratch. d must be 64 or 128.
extern "C" int tts_decode_attention(const float* q, const void* kc,
                                    const void* vc, const int* pos, float* out,
                                    float* part_ml, float* part_acc, int hq,
                                    int n_rep, int ctx, int d, int cache_bf16,
                                    float scale, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (hq <= 0 || n_rep <= 0 || hq % n_rep || ctx <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (cache_bf16 && d == 64) {
    launch<__nv_bfloat16, 64>(q, kc, vc, pos, out, part_ml, part_acc, hq, n_rep, ctx, scale, s);
  } else if (cache_bf16 && d == 128) {
    launch<__nv_bfloat16, 128>(q, kc, vc, pos, out, part_ml, part_acc, hq, n_rep, ctx, scale, s);
  } else if (!cache_bf16 && d == 64) {
    launch<float, 64>(q, kc, vc, pos, out, part_ml, part_acc, hq, n_rep, ctx, scale, s);
  } else if (!cache_bf16 && d == 128) {
    launch<float, 128>(q, kc, vc, pos, out, part_ml, part_acc, hq, n_rep, ctx, scale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
