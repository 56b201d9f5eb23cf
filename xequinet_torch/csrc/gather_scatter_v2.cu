// The v2 gather-scale-scatter of XPaiNN's message block on Hopper: the
// equivariant-state aggregate of the v2 route (use_pallas_scatter=True),
//   out[b*BN + dst2[k]] += x[ws[b] + src2[k]] * w2[k]
// over each destination block b's chunk range of slots.
//
// Replaces: xequinet_tpu/ops/pallas_scatter_v2.py::_kernel (:105),
// launched by gather_scale_scatter_v2 (:157-221).
//
// The TPU kernel gathers with a one-hot [C, W] @ [W, D] product and
// scatters with a one-hot [BN, C] @ [C, D] product on the MXU (:142-154),
// a TPU workaround for indexed loads and stores.  Here the gather is an
// indexed load and the scatter a destination-ordered sum: the wrapper
// turns the slot layout into a CSR list by destination (dst_ptr /
// dst_slots) and a global source row per slot (slot_src), the slot plan
// that the fused message kernels walk too (ops/fused_message.py
// build_slot_plan).  Padding slots (dst2 == BN) and slots past the covered
// chunk range are not in the list and add nothing.
//
// Design: one thread per (destination row, column), a block per row with
// one thread per column (480 at the flagship's D, in whole warps); the
// thread walks the row's slots in list order and writes its element once.
// No atomics, so results repeat bit for bit.
//
// Bound on the H100: per real slot one x row and one w2 row are read, each
// output row written once, 2 FLOPs per slot and column: memory bound
// (about 410 MB at the flagship batch, 0.12 ms at 3.35 TB/s).  x (39 MB
// at the flagship batch) fits the 50 MB L2, so each row's ~8 re-reads by
// its neighbours mostly hit L2; w2 streams once.  This first version
// puts 4 slots' loads in flight per thread and does nothing else about
// latency.
//
// Rounding: w2 in f32 (the model path, no TF32 anywhere) sums exact f32
// products; w2 in bf16 (bench_kernels.py make_v2(bfloat16)) rounds x to
// bf16 and each product to bf16 and sums in f32, as the TPU kernel's
// one-hot products do (:141-154).
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
// [p0, p1) of x[src[k], col] * w[k, col], with k = order[p].  Four slots'
// loads go out before their sums so that they overlap; the sum itself
// stays in list order, so the result repeats bit for bit.  In bf16 mode (w in bf16) x is rounded to bf16 and
// each product to bf16, and the sum is f32, as the TPU kernel's one-hot
// products round.
template <typename W, bool BF16>
__device__ __forceinline__ float xeq_gss_sum(const float* __restrict__ x,
                                             const W* __restrict__ w,
                                             const int* __restrict__ order,
                                             const int* __restrict__ src,
                                             int p0, int p1, int d, int col) {
  constexpr int kIlp = 4;
  float acc = 0.f;
  for (int p = p0; p < p1; p += kIlp) {
    float v[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      v[u] = 0.f;
      if (p + u < p1) {
        const int k = __ldg(order + p + u);
        const float xv = xeq_gss_ld(x, (int64_t)__ldg(src + k) * d + col);
        const float wv = xeq_gss_ld(w, (int64_t)k * d + col);
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


template <typename W, bool BF16>
__global__ void __launch_bounds__(512)
gather_scatter_v2_kernel(const float* __restrict__ x, const W* __restrict__ w2,
                         const int* __restrict__ dst_ptr,
                         const int* __restrict__ dst_slots,
                         const int* __restrict__ slot_src,
                         float* __restrict__ out, int d) {
  const int row = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= d) return;
  out[(int64_t)row * d + col] = xeq_gss_sum<W, BF16>(
      x, w2, dst_slots, slot_src, dst_ptr[row], dst_ptr[row + 1], d, col);
}

extern "C" int xeq_gather_scatter_v2(const void* x, const void* w2,
                                     const void* dst_ptr, const void* dst_slots,
                                     const void* slot_src, void* out, int n_out,
                                     int d, int bf16, void* stream) {
  if (n_out == 0 || d == 0) return 0;
  const int threads = xeq_gss_threads(d);
  dim3 grid(n_out, (d + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    gather_scatter_v2_kernel<__nv_bfloat16, true><<<grid, threads, 0, s>>>(
        (const float*)x, (const __nv_bfloat16*)w2, (const int*)dst_ptr,
        (const int*)dst_slots, (const int*)slot_src, (float*)out, d);
  } else {
    gather_scatter_v2_kernel<float, false><<<grid, threads, 0, s>>>(
        (const float*)x, (const float*)w2, (const int*)dst_ptr,
        (const int*)dst_slots, (const int*)slot_src, (float*)out, d);
  }
  return (int)cudaGetLastError();
}
