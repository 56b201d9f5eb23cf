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
// Bound on the H100: per real slot one x row and one w2 row are read, each
// output row written once, 2 FLOPs per slot and column: memory bound
// (about 410 MB at the flagship batch, 0.12 ms at 3.35 TB/s; 245 MB and
// 0.073 ms with w2 in bf16).  x (39 MB at the flagship batch) fits the 50
// MB L2, so each row's ~8 re-reads by its neighbours mostly hit L2; w2
// streams once.
//
// The first version gave each (destination row, column) one thread (a
// block of 480 per row), which walked its ~8 slots through three dependent
// scalar loads each (dst_slots, slot_src, then the x and w2 elements) and
// exited: two round trips of that chain per row and a few 4-byte loads in
// flight per warp (0.254 ms, 48% of the bound).  This one follows the v1
// kernel (gather_scatter.cu): a warp owns one destination row (8 rows per
// block); it reads up to 32 of the row's dst_slots in one coalesced load,
// then their slot_src, and passes both to its lanes with __shfl_sync; each
// lane sums its float4 columns (8-byte loads of four bf16 for a bf16 w2;
// scalar columns when D % 4 != 0 or a row is not 16-byte aligned) over the
// slots in list order.  A lane holds four vectors of one slot in flight (a
// 480-column row is one group of 128 vectors a warp; wider rows are split
// over the grid's second axis).  On the card this ran faster than two to
// eight slots in flight with one or two vectors each, and than two slots
// of four vectors, which take more registers and so leave fewer warps
// resident.  w2 is read with streaming hints and out stored with
// evict-first hints, so that x stays in L2.  Each output element is written once, no atomics, and
// the sums keep list order, so results repeat bit for bit.
//
// Rounding: w2 in f32 (the model path, no TF32 anywhere) sums exact f32
// products; w2 in bf16 (bench_kernels.py make_v2(bfloat16)) rounds x to
// bf16 and each product to bf16 and sums in f32, as the TPU kernel's
// one-hot products do (:141-154).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define XEQ_V2_ROWS 8  // rows (warps) per block
#define XEQ_V2_U 1     // slots whose loads go out together
#define XEQ_V2_Q 4     // vectors per lane in one column group (128 per warp)

// Rounding point of the TPU kernel's bf16 mode (a value cast to bf16
// before the next one-hot product); identity in f32 mode.
template <bool BF16>
__device__ __forceinline__ float xeq_v2_rnd(float v) {
  if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// w2 vector c of slot k's row (nv vectors a row), as f32, streamed.
__device__ __forceinline__ float4 xeq_v2_ldw(const float* w, int64_t k, int nv, int c) {
  return __ldcs(reinterpret_cast<const float4*>(w) + k * nv + c);
}
__device__ __forceinline__ float4 xeq_v2_ldw(const __nv_bfloat16* w, int64_t k, int nv, int c) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(w) + k * nv + c);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float xeq_v2_ldw1(const float* w, int64_t k, int nv, int c) {
  return __ldcs(w + k * nv + c);
}
__device__ __forceinline__ float xeq_v2_ldw1(const __nv_bfloat16* w, int64_t k, int nv, int c) {
  return __bfloat162float(w[k * nv + c]);
}

template <bool BF16>
__device__ __forceinline__ void xeq_v2_add(float4& acc, float4 x, float4 w) {
  acc.x += xeq_v2_rnd<BF16>(xeq_v2_rnd<BF16>(x.x) * w.x);
  acc.y += xeq_v2_rnd<BF16>(xeq_v2_rnd<BF16>(x.y) * w.y);
  acc.z += xeq_v2_rnd<BF16>(xeq_v2_rnd<BF16>(x.z) * w.z);
  acc.w += xeq_v2_rnd<BF16>(xeq_v2_rnd<BF16>(x.w) * w.w);
}
template <bool BF16>
__device__ __forceinline__ void xeq_v2_add(float& acc, float x, float w) {
  acc += xeq_v2_rnd<BF16>(xeq_v2_rnd<BF16>(x) * w);
}

template <typename V>
__device__ __forceinline__ V xeq_v2_zero();
template <>
__device__ __forceinline__ float4 xeq_v2_zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float xeq_v2_zero<float>() { return 0.f; }

// V: float4 (vector columns) or float; W: float or __nv_bfloat16.
template <typename V, typename W, bool BF16>
__global__ void __launch_bounds__(32 * XEQ_V2_ROWS)
gather_scatter_v2_kernel(const float* __restrict__ x, const W* __restrict__ w2,
                         const int* __restrict__ dst_ptr, const int* __restrict__ dst_slots,
                         const int* __restrict__ slot_src, float* __restrict__ out, int n_out,
                         int d) {
  constexpr int kW = sizeof(V) / sizeof(float), kU = XEQ_V2_U, kQ = XEQ_V2_Q;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * XEQ_V2_ROWS + (threadIdx.x >> 5);
  if (r >= n_out) return;
  const int p0 = __ldg(dst_ptr + r), p1 = __ldg(dst_ptr + r + 1);
  const int nv = d / kW;
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(out) + (int64_t)r * nv;
  for (int c0 = blockIdx.y * 32 * kQ; c0 < nv; c0 += gridDim.y * 32 * kQ) {
    V acc[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) acc[i] = xeq_v2_zero<V>();
    for (int pb = p0; pb < p1; pb += 32) {
      const int n = min(32, p1 - pb);
      // the row's next 32 slots and their source rows: two coalesced loads
      const int my_k = lane < n ? __ldg(dst_slots + pb + lane) : 0;
      const int my_src = lane < n ? __ldg(slot_src + my_k) : 0;
      for (int q = 0; q < n; q += kU) {
        V xs[kU][kQ], ws[kU][kQ];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int k = __shfl_sync(0xffffffffu, my_k, (q + u) & 31);
          const int sr = __shfl_sync(0xffffffffu, my_src, (q + u) & 31);
#pragma unroll
          for (int i = 0; i < kQ; ++i) {
            const int c = c0 + lane + 32 * i;
            const bool ok = q + u < n && c < nv;
            xs[u][i] = ok ? __ldg(xv + (int64_t)sr * nv + c) : xeq_v2_zero<V>();
            if constexpr (kW == 4)
              ws[u][i] = ok ? xeq_v2_ldw(w2, k, nv, c) : xeq_v2_zero<V>();
            else
              ws[u][i] = ok ? xeq_v2_ldw1(w2, k, nv, c) : xeq_v2_zero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (q + u >= n) break;
#pragma unroll
          for (int i = 0; i < kQ; ++i) xeq_v2_add<BF16>(acc[i], xs[u][i], ws[u][i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQ; ++i) {
      const int c = c0 + lane + 32 * i;
      if (c < nv) __stcs(ov + c, acc[i]);
    }
  }
}

template <typename V, typename W, bool BF16>
static void launch_v2(const float* x, const W* w2, const int* dst_ptr, const int* dst_slots,
                      const int* slot_src, float* out, int n_out, int d, cudaStream_t s) {
  const int nv = d / (int)(sizeof(V) / sizeof(float)), per = 32 * XEQ_V2_Q;
  dim3 grid((n_out + XEQ_V2_ROWS - 1) / XEQ_V2_ROWS, (nv + per - 1) / per);
  gather_scatter_v2_kernel<V, W, BF16><<<grid, 32 * XEQ_V2_ROWS, 0, s>>>(
      x, w2, dst_ptr, dst_slots, slot_src, out, n_out, d);
}

extern "C" int xeq_gather_scatter_v2(const void* x, const void* w2,
                                     const void* dst_ptr, const void* dst_slots,
                                     const void* slot_src, void* out, int n_out,
                                     int d, int bf16, void* stream) {
  if (n_out == 0 || d == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (uintptr_t)w2 % (bf16 ? 8 : 16) == 0;
  const float* xf = (const float*)x;
  const int *ptr = (const int*)dst_ptr, *slots = (const int*)dst_slots,
            *src = (const int*)slot_src;
  float* o = (float*)out;
  if (bf16) {
    const __nv_bfloat16* w = (const __nv_bfloat16*)w2;
    if (vec)
      launch_v2<float4, __nv_bfloat16, true>(xf, w, ptr, slots, src, o, n_out, d, s);
    else
      launch_v2<float, __nv_bfloat16, true>(xf, w, ptr, slots, src, o, n_out, d, s);
  } else {
    const float* w = (const float*)w2;
    if (vec)
      launch_v2<float4, float, false>(xf, w, ptr, slots, src, o, n_out, d, s);
    else
      launch_v2<float, float, false>(xf, w, ptr, slots, src, o, n_out, d, s);
  }
  return (int)cudaGetLastError();
}
