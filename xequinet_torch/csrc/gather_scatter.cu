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
// DMA tiling (:153-163).  Here the wrapper turns the sorted dst and the
// block runs into a per-row edge range (row_lo / row_hi, searchsorted on
// the device), and one thread per (row, column) sums that row's edges in
// edge order and writes its element once: no padding of D, no atomics,
// results repeat bit for bit.
//
// Bound on the H100: per edge one x row and one w row (or one scale) are
// read, each output row written once, 2 FLOPs per edge and column: memory
// bound (about 379 MB at bench_kernels.py run's default shape, 0.11 ms at
// 3.35 TB/s).  src is uniform over all rows, so x rows are gathered from
// anywhere; x (31.5 MB there) fits the 50 MB L2.  This first version
// puts 4 edges' loads in flight per thread and does nothing else about
// latency.  f32 throughout, as the TPU kernel's f32 buffers.
#include "gather_scatter_common.cuh"

__global__ void __launch_bounds__(512)
gather_scatter_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const int* __restrict__ src, const int* __restrict__ row_lo,
                      const int* __restrict__ row_hi, float* __restrict__ out,
                      int d, int w_full) {
  const int row = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  if (col >= d) return;
  out[(int64_t)row * d + col] = xeq_gss_sum<float, false, false>(
      x, w, nullptr, src, row_lo[row], row_hi[row], d, col, w_full ? d : 1,
      w_full ? col : 0);
}

extern "C" int xeq_gather_scatter(const void* x, const void* w, const void* src,
                                  const void* row_lo, const void* row_hi,
                                  void* out, int n_out, int d, int w_full,
                                  void* stream) {
  if (n_out == 0 || d == 0) return 0;
  const int threads = xeq_gss_threads(d);
  dim3 grid(n_out, (d + threads - 1) / threads);
  gather_scatter_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (const int*)src, (const int*)row_lo,
      (const int*)row_hi, (float*)out, d, w_full);
  return (int)cudaGetLastError();
}
