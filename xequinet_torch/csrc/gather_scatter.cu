// The v1 gather-scale-scatter on Hopper:
//   out[c] = sum over edges e with dst[e] == c of x[src[e]] * w[e]
// over each destination block's edge run [start, start + count), with
// dst sorted, src anywhere in x, and w [E, D] or [E, 1] (a per-edge
// scale broadcast over the columns).
//
// Replaces: xequinet_tpu/ops/pallas_scatter.py::_kernel (:74), launched by
// _gather_scale_scatter_impl (:140-189).
//
// The TPU kernel walks one destination block per grid step, DMAs each
// edge's x row and w row into VMEM and adds it into the block's output
// tile, one edge after another, with rows padded to 1024 floats for the
// DMA tiling (:153-163).
//
// Bound on the H100: per edge one x row and one w row (or one scale) are
// read, each output row written once, 2 FLOPs per edge and column: memory
// bound (378.8 MB at bench_kernels.py run's shape with w [E, D], 0.113 ms
// at 3.35 TB/s; 64.9 MB, 0.019 ms, at [E, 1]).  src is uniform over all
// rows, so x rows are gathered from anywhere; x (31.5 MB there) fits the
// 50 MB L2, so at [E, 1] the time is L2's: 315 MB of gathered rows.
//
// One launch per op call and nothing before it: a warp owns one
// destination row (8 rows per block) and finds the row's edges itself,
// by two searches of the sorted dst inside its block's run, run side by
// side (32 probes per round, one per lane, so a run of a few thousand
// edges takes three rounds): [lower_bound(r), lower_bound(r + 1)) cut to
// the run, the
// ranges ops/gather_scatter.py::row_edge_ranges states.  The warp then
// loads up to 32 of its edges' src (and [E, 1] scales) at once, passes
// them to its lanes with __shfl_sync, and each lane sums its float4
// columns (scalar columns when D % 4 != 0) over the edges in edge order,
// the x (and w) loads of two edges in flight.  Few registers (80 at [E, 1],
// 64 at [E, D]) keep 24-32 warps on each SM, so that other rows' gathers
// cover each row's searches: with four edges in flight (122 registers, 16
// warps per SM) the [E, 1] walk ran at half the rate (PERF.md).  At [E, D]
// the row's columns are split over the grid's second axis, and out is
// stored with evict-first hints so that x stays in L2.
// Each output element is written once, no atomics, and the sums keep edge
// order, so results repeat bit for bit.  f32 throughout, as the TPU
// kernel's f32 buffers.  The v2 kernel (gather_scatter_v2.cu) keeps its
// own walk.
#include <cuda_runtime.h>
#include <stdint.h>

#define XEQ_GS_ROWS 8  // rows (warps) per block
#define XEQ_GS_U 2     // edges whose loads go out together

// One round of a warp's search for the first index in [lo, hi) whose dst
// is >= r: 32 probes, one per lane, narrow the range to one step.
__device__ __forceinline__ void xeq_search_round(bool below, int step, int& lo, int& hi) {
  const int k = __popc(__ballot_sync(0xffffffffu, below));
  lo = min(lo + k * step, hi);
  hi = min(lo + step, hi);
}

// The edges of row r inside its block's run [s, e): [lower_bound(r),
// lower_bound(r + 1)), both searches by the whole warp, their probe loads
// issued together in each round.
__device__ __forceinline__ void xeq_row_range(const int* __restrict__ dst, int s, int e, int r,
                                              int lane, int& row_lo, int& row_hi) {
  int lo_a = s, hi_a = e, lo_b = s, hi_b = e;
  while (hi_a - lo_a > 32 || hi_b - lo_b > 32) {
    const bool wa = hi_a - lo_a > 32, wb = hi_b - lo_b > 32;
    const int sa = (hi_a - lo_a + 31) / 32, sb = (hi_b - lo_b + 31) / 32;
    const int pa = lo_a + (lane + 1) * sa - 1, pb = lo_b + (lane + 1) * sb - 1;
    const int va = wa && pa < hi_a ? __ldg(dst + pa) : r;
    const int vb = wb && pb < hi_b ? __ldg(dst + pb) : r + 1;
    if (wa) xeq_search_round(va < r, sa, lo_a, hi_a);
    if (wb) xeq_search_round(vb < r + 1, sb, lo_b, hi_b);
  }
  const int va = lo_a + lane < hi_a ? __ldg(dst + lo_a + lane) : r;
  const int vb = lo_b + lane < hi_b ? __ldg(dst + lo_b + lane) : r + 1;
  row_lo = lo_a + __popc(__ballot_sync(0xffffffffu, va < r));
  row_hi = lo_b + __popc(__ballot_sync(0xffffffffu, vb < r + 1));
}

__device__ __forceinline__ float4 xeq_fma4(float4 a, float4 x, float4 w) {
  return make_float4(a.x + x.x * w.x, a.y + x.y * w.y, a.z + x.z * w.z, a.w + x.w * w.w);
}
__device__ __forceinline__ float4 xeq_fma4(float4 a, float4 x, float w) {
  return make_float4(a.x + x.x * w, a.y + x.y * w, a.z + x.z * w, a.w + x.w * w);
}
__device__ __forceinline__ float xeq_fma4(float a, float x, float w) { return a + x * w; }

template <typename V>
__device__ __forceinline__ V xeq_zero();
template <>
__device__ __forceinline__ float4 xeq_zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <>
__device__ __forceinline__ float xeq_zero<float>() { return 0.f; }

// Vectors per lane in one column group: [E, 1] takes a whole row of 480
// floats in one group; [E, D], which also streams w, splits the row over
// the grid's second axis into groups of 64 vectors.
template <bool WFULL>
__host__ __device__ constexpr int xeq_gs_q() { return WFULL ? 2 : 4; }

// V: float4 (D % 4 == 0, 16-byte aligned rows) or float; WFULL: w [E, D].
template <typename V, bool WFULL>
__global__ void __launch_bounds__(32 * XEQ_GS_ROWS)
gather_scatter_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ src, const int* __restrict__ dst,
                      const int* __restrict__ starts, const int* __restrict__ counts,
                      float* __restrict__ out, int n_out, int d, int block_nodes,
                      int n_blocks) {
  constexpr int kW = sizeof(V) / sizeof(float);
  constexpr int kU = XEQ_GS_U, kQ = xeq_gs_q<WFULL>();
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * XEQ_GS_ROWS + (threadIdx.x >> 5);
  if (r >= n_out) return;
  const int b = min(r / block_nodes, n_blocks - 1);
  const int s = __ldg(starts + b), e = s + __ldg(counts + b);
  int lo, hi;
  xeq_row_range(dst, s, e, r, lane, lo, hi);
  const int nv = d / kW;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* wv = reinterpret_cast<const V*>(w);
  V* ov = reinterpret_cast<V*>(out) + (int64_t)r * nv;
  for (int c0 = blockIdx.y * 32 * kQ; c0 < nv; c0 += gridDim.y * 32 * kQ) {
    V acc[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) acc[i] = xeq_zero<V>();
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const int n = min(32, hi - p0);
      const int my_src = lane < n ? __ldg(src + p0 + lane) : 0;
      const float my_w = (!WFULL && lane < n) ? __ldg(w + p0 + lane) : 0.f;
      for (int q = 0; q < n; q += kU) {
        V xs[kU][kQ], ws[WFULL ? kU : 1][kQ];
        float sc[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int sr = __shfl_sync(0xffffffffu, my_src, (q + u) & 31);
          sc[u] = __shfl_sync(0xffffffffu, my_w, (q + u) & 31);
#pragma unroll
          for (int i = 0; i < kQ; ++i) {
            const int c = c0 + lane + 32 * i;
            const bool ok = q + u < n && c < nv;
            xs[u][i] = ok ? __ldg(xv + (int64_t)sr * nv + c) : xeq_zero<V>();
            if (WFULL)
              ws[WFULL ? u : 0][i] =
                  ok ? __ldcs(wv + (int64_t)(p0 + q + u) * nv + c) : xeq_zero<V>();
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (q + u >= n) break;
#pragma unroll
          for (int i = 0; i < kQ; ++i) {
            if (WFULL)
              acc[i] = xeq_fma4(acc[i], xs[u][i], ws[WFULL ? u : 0][i]);
            else
              acc[i] = xeq_fma4(acc[i], xs[u][i], sc[u]);
          }
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

template <typename V>
static void launch_gs(bool w_full, cudaStream_t s, const float* x, const float* w,
                      const int* src, const int* dst, const int* starts, const int* counts,
                      float* out, int n_out, int d, int block_nodes, int n_blocks) {
  const int rows = (n_out + XEQ_GS_ROWS - 1) / XEQ_GS_ROWS;
  const int nv = d / (int)(sizeof(V) / sizeof(float));
  if (w_full) {
    const int per = 32 * xeq_gs_q<true>();
    gather_scatter_kernel<V, true><<<dim3(rows, (nv + per - 1) / per), 32 * XEQ_GS_ROWS, 0, s>>>(
        x, w, src, dst, starts, counts, out, n_out, d, block_nodes, n_blocks);
  } else {
    gather_scatter_kernel<V, false><<<rows, 32 * XEQ_GS_ROWS, 0, s>>>(
        x, w, src, dst, starts, counts, out, n_out, d, block_nodes, n_blocks);
  }
}

extern "C" int xeq_gather_scatter(const void* x, const void* w, const void* src,
                                  const void* dst, const void* starts, const void* counts,
                                  void* out, int n_out, int d, int w_full, int block_nodes,
                                  int n_blocks, void* stream) {
  if (n_out == 0 || d == 0) return 0;
  if (block_nodes < 1 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = d % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (!w_full || (uintptr_t)w % 16 == 0);
  if (vec)
    launch_gs<float4>(w_full, s, (const float*)x, (const float*)w, (const int*)src,
                      (const int*)dst, (const int*)starts, (const int*)counts, (float*)out,
                      n_out, d, block_nodes, n_blocks);
  else
    launch_gs<float>(w_full, s, (const float*)x, (const float*)w, (const int*)src,
                     (const int*)dst, (const int*)starts, (const int*)counts, (float*)out,
                     n_out, d, block_nodes, n_blocks);
  return (int)cudaGetLastError();
}
