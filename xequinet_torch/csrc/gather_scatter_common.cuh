// Shared walk of the gather-scale-scatter kernels (gather_scatter_v2.cu,
// gather_scatter.cu).  Plain C entry points, built by nvcc for sm_90a
// into shared libraries that xequinet_torch/ops/cuda_build.py loads with
// ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float xeq_gss_ld(const float* p, int64_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float xeq_gss_ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// Rounding point of the TPU kernel's bf16 mode (a value cast to bf16
// before the next one-hot product); identity in f32 mode.
template <bool BF16>
__device__ __forceinline__ float xeq_gss_rnd(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// One output element: the sum, in list order, over positions p in
// [p0, p1) of x[src[k], col] * w[k * w_stride + w_col], with k = order[p]
// (ORDERED) or k = p.  Four slots' loads go out before their sums so
// that they overlap; the sum itself stays in list order, so the result
// repeats bit for bit.  In bf16 mode (w in bf16) x is rounded to bf16 and
// each product to bf16, and the sum is f32, as the TPU kernel's one-hot
// products round.
template <typename W, bool BF16, bool ORDERED>
__device__ __forceinline__ float xeq_gss_sum(const float* __restrict__ x,
                                             const W* __restrict__ w,
                                             const int* __restrict__ order,
                                             const int* __restrict__ src,
                                             int p0, int p1, int d, int col,
                                             int64_t w_stride, int w_col) {
  constexpr int kIlp = 4;
  float acc = 0.f;
  for (int p = p0; p < p1; p += kIlp) {
    float v[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      v[u] = 0.f;
      if (p + u < p1) {
        const int k = ORDERED ? __ldg(order + p + u) : p + u;
        const float xv = xeq_gss_ld(x, (int64_t)__ldg(src + k) * d + col);
        const float wv = xeq_gss_ld(w, (int64_t)k * w_stride + w_col);
        v[u] = xeq_gss_rnd<BF16>(xeq_gss_rnd<BF16>(xv) * wv);
      }
    }
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      if (p + u < p1) acc += v[u];
    }
  }
  return acc;
}

// Threads per block: one per column, in whole warps, at most 512; the
// grid's second axis covers wider rows.
static inline int xeq_gss_threads(int d) {
  const int t = ((d + 31) / 32) * 32;
  return t < 512 ? t : 512;
}
