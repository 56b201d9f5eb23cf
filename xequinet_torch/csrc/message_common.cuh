// Shared helpers of the fused XPaiNN message kernels (message_fwd.cu,
// message_bwd.cu, message_bwd2.cu).  Plain C entry points, built by nvcc for sm_90a into
// shared libraries that xequinet_torch/ops/fused_message.py loads with
// ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Live rows of the filter operand wf_aug (num_basis + 1) a thread keeps in
// registers; the wrapper refuses larger num_basis.
#define XEQ_MAXK 32
// Edge-feature row width (the packed [rbf*fcut | fcut | Y | 0] stream).
#define XEQ_FPACK 128

__device__ __forceinline__ float xeq_ld(const float* p, int64_t i) {
  return __ldg(p + i);
}

__device__ __forceinline__ float xeq_ld(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}

// Rounding point of the TPU kernel's bf16 mode: a value cast to the matmul
// dtype before the next contraction.  Identity in f32 mode.
template <bool BF16>
__device__ __forceinline__ float xeq_rnd(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// Radial filter of one slot at one hidden column: e[:Kw] . wf[:Kw, h], with
// the slot's edge-feature row e staged in shared memory (f32) and the
// column kept in registers (w).
__device__ __forceinline__ float xeq_filter(const float* e,
                                            const float (&w)[XEQ_MAXK],
                                            int kw) {
  float acc = 0.f;
#pragma unroll
  for (int f = 0; f < XEQ_MAXK; ++f) {
    if (f < kw) acc += e[f] * w[f];
  }
  return acc;
}

// Slots a block stages in shared memory per step of a CSR walk, and slots
// whose loads a thread issues together.
#define XEQ_STAGE 32
#define XEQ_ILP 4
// Lanes of one irrep the kernels take (2l + 1 for l <= 2).
#define XEQ_MAXM 5

// Stage the slots at positions base .. base+n-1 (n <= XEQ_STAGE) of a CSR
// list: each slot's own row (row_of, the row the walk is sorted by), its
// partner row (other_of) and the first kf columns of its edge-feature row
// as f32 (ef_s[q * kf + f]).  Called by every thread of the block; ends
// with a barrier, and starts with one so the previous stage has been read.
template <typename T>
__device__ __forceinline__ void xeq_stage_slots(
    const int* __restrict__ slots, int base, int n,
    const int* __restrict__ row_of, const int* __restrict__ other_of,
    const T* __restrict__ ef, int kf, int* k_s, int* row_s, int* other_s,
    float* ef_s) {
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int k = slots[base + i];
    k_s[i] = k;
    row_s[i] = row_of[k];
    other_s[i] = other_of[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n * kf; i += blockDim.x) {
    const int q = i / kf, f = i - q * kf;
    ef_s[i] = xeq_ld(ef, (int64_t)k_s[q] * XEQ_FPACK + f);
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void xeq_load_column(const T* __restrict__ wf,
                                                int hp, int h, int kw,
                                                float (&w)[XEQ_MAXK]) {
#pragma unroll
  for (int f = 0; f < XEQ_MAXK; ++f) {
    w[f] = (h >= 0 && f < kw) ? xeq_ld(wf, (int64_t)f * hp + h) : 0.f;
  }
}

// Sum over the lanes j of irrep u of rnd(a_j * gr[sdp + j]), with a_j the
// row ar's vector lane (ar[hp + j], state gate) or the staged edge-feature
// row's harmonic column (e[lane_ycol[j]], harmonic gate).  An irrep has at
// most XEQ_MAXM lanes (the wrapper checks), so the lane loop is unrolled
// with predicates and its loads issue together.
template <typename T, bool BF16>
__device__ __forceinline__ float xeq_gate_sum(bool state, int u, const float* e,
                                              const T* __restrict__ ar,
                                              const T* __restrict__ gr,
                                              const int* __restrict__ gate_lane0,
                                              const int* __restrict__ gate_dim,
                                              const int* __restrict__ lane_ycol,
                                              int hp, int sdp) {
  const int l0 = gate_lane0[u], m1 = gate_dim[u];
  float acc = 0.f;
#pragma unroll
  for (int m = 0; m < XEQ_MAXM; ++m) {
    if (m < m1) {
      const int j = l0 + m;
      const float a = state ? xeq_ld(ar, hp + j) : e[lane_ycol[j]];
      acc += xeq_rnd<BF16>(a * xeq_ld(gr, sdp + j));
    }
  }
  return acc;
}

// dfo at hidden column h for one slot (the cotangent of filter_out): e =
// its staged edge-feature row (shared memory, f32), gr = its g row, xr =
// its x row.
template <typename T, bool BF16>
__device__ __forceinline__ float dfo_at(int h, const float* e,
                                        const T* __restrict__ gr,
                                        const T* __restrict__ xr,
                                        const int* __restrict__ gate_lane0,
                                        const int* __restrict__ gate_dim,
                                        const int* __restrict__ lane_ycol,
                                        int ni, int hp, int sdp) {
  if (h < 2 * ni) {
    const bool state = h < ni;
    return xeq_gate_sum<T, BF16>(state, state ? h : h - ni, e, xr, gr, gate_lane0,
                                 gate_dim, lane_ycol, hp, sdp);
  }
  return xeq_ld(gr, h - 2 * ni);
}

// Second pass of a filter-weight gradient: the sum of the per-block
// partials part [n_part, kf, h_dim] in block order into dwf [128, hp]
// (zero outside the live rows and columns).  No float atomics, so the
// result repeats from run to run.
static __global__ void xeq_dwf_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ dwf, int n_part,
                                             int kf, int h_dim, int hp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= XEQ_FPACK * hp) return;
  const int f = i / hp, h = i - f * hp;
  float acc = 0.f;
  if (f < kf && h < h_dim) {
    for (int p = 0; p < n_part; ++p) acc += part[((int64_t)p * kf + f) * h_dim + h];
  }
  dwf[i] = acc;
}
