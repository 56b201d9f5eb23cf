// Shared helpers of the fused XPaiNN message kernels (message_fwd.cu,
// message_bwd.cu).  Plain C entry points, built by nvcc for sm_90a into
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
