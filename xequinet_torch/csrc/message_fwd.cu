// Forward of one XPaiNN message block on Hopper: the whole per-edge
// pipeline (radial filter, neighbour gather, gates, harmonic gating) and
// its sum into the destination nodes, in one kernel.
//
// Replaces: xequinet_tpu/ops/pallas_message.py::_kernel (:177), launched by
// _mega_call (:264-325).
//
// Per slot k with destination row i and source row s:
//   fw   = ef[k, :Kw] @ wf[:Kw, :H]          (the live rows of [W ; b])
//   fo   = rnd(x[s, :H] * fw)                 (filter_out)
//   msg_s[c]  = fo[2ni + c]                   (MS)
//   msg_v[j]  = x[s, Hp + j] * fo[gate(j)] + ef[k, ycol(j)] * fo[ni + gate(j)]
//   out[i]   += rnd([msg_s | msg_v])
// The TPU kernel runs E1/E2/MS/BY and the gather/scatter as one-hot MXU
// matmuls (95.5% of its FLOPs); here they are index maps: lane j reads
// its gate column (lane_gate) and its harmonic column (lane_ycol).
//
// Design: one thread per (destination row, output column); a block owns
// 8 consecutive destination rows and a 128-column tile.  Slots arrive as
// a CSR list by destination (dst_ptr / dst_slots, built by the wrapper),
// so the block's slots are one contiguous run of that list, in row
// order.  The block stages them XEQ_STAGE at a time in shared memory
// (slot, source row, destination row, the live edge-feature columns as
// f32), so a thread's only global load per slot is its x elements.  Every
// output element is summed by one thread in slot order and written once:
// no atomics, and the result repeats from run to run.  A thread keeps its
// one or two wf columns (<= 2 x 32 floats) in registers.
//
// Bound on the H100: the useful work is ~27 kFLOP and ~4 kB of gathered
// rows per slot, so the function is memory bound (bytes / 3.35 TB/s).
// This version recomputes each slot's filter once per output column that
// needs it (about 2 x 21 FMAs per column) on the FP32 pipes and gathers x
// elements through L1/L2; it is bound by latency and issue rate, not by
// bytes.  Tensor cores (wgmma for ef @ wf) and TMA staging of x rows are
// later work.
//
// Rounding: in bf16 mode x, ef and wf arrive in bf16 (the wrapper casts
// them, as _mega_call does at :320-323), filter_out is rounded to bf16
// before the gates (:239) and the message before the sum (:248); every
// sum is f32.
#include "message_common.cuh"

template <typename T, bool BF16>
__global__ void __launch_bounds__(128)
message_fwd_kernel(const T* __restrict__ x, const T* __restrict__ ef,
                   const T* __restrict__ wf, const int* __restrict__ dst_ptr,
                   const int* __restrict__ dst_slots,
                   const int* __restrict__ slot_src,
                   const int* __restrict__ slot_dst,
                   const int* __restrict__ lane_gate,
                   const int* __restrict__ lane_ycol, float* __restrict__ out,
                   int n_out, int rows_per_block, int ni, int nd, int hp,
                   int d, int dp, int sdp, int kw, int kf) {
  __shared__ int k_s[XEQ_STAGE], dst_s[XEQ_STAGE], src_s[XEQ_STAGE];
  __shared__ float ef_s[XEQ_STAGE * XEQ_FPACK];
  const int ocols = sdp + dp;
  const int xs = hp + dp;
  // the wrapper launches ocols / 128 column tiles of 128 threads
  const int col = blockIdx.y * blockDim.x + threadIdx.x;

  // column role: scalar message (h1 only), vector lane (h1, h2, vx, yc)
  // or padding (zero)
  int h1 = -1, h2 = -1, vx = 0, yc = 0;
  if (col < sdp) {
    if (col < nd) h1 = 2 * ni + col;
  } else {
    const int jv = col - sdp;
    if (jv < d) {
      const int u = lane_gate[jv];
      h1 = u;
      h2 = ni + u;
      vx = hp + jv;
      yc = lane_ycol[jv];
    }
  }
  float w1[XEQ_MAXK], w2[XEQ_MAXK];
  xeq_load_column(wf, hp, h1, kw, w1);
  xeq_load_column(wf, hp, h2, kw, w2);

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, n_out);
  if (r0 >= r1) return;  // the whole block
  const int p1 = dst_ptr[r1];
  int cur = r0;
  float acc = 0.f;
  for (int base = dst_ptr[r0]; base < p1; base += XEQ_STAGE) {
    const int n = min(XEQ_STAGE, p1 - base);
    xeq_stage_slots(dst_slots, base, n, slot_dst, slot_src, ef, kf, k_s, dst_s,
                    src_s, ef_s);
    for (int q0 = 0; q0 < n; q0 += XEQ_ILP) {
      // the messages of XEQ_ILP slots first, so their loads overlap
      float c[XEQ_ILP];
#pragma unroll
      for (int u = 0; u < XEQ_ILP; ++u) {
        const int q = q0 + u;
        c[u] = 0.f;
        if (q < n && h1 >= 0) {
          const float* e = ef_s + q * kf;
          const T* xr = x + (int64_t)src_s[q] * xs;
          const float fo1 = xeq_rnd<BF16>(xeq_ld(xr, h1) * xeq_filter(e, w1, kw));
          float msg;
          if (h2 < 0) {
            msg = fo1;
          } else {
            const float fo2 = xeq_rnd<BF16>(xeq_ld(xr, h2) * xeq_filter(e, w2, kw));
            msg = xeq_ld(xr, vx) * fo1 + e[yc] * fo2;
          }
          c[u] = xeq_rnd<BF16>(msg);
        }
      }
      // then the sums, in slot order
#pragma unroll
      for (int u = 0; u < XEQ_ILP; ++u) {
        const int q = q0 + u;
        if (q >= n) break;
        const int i = dst_s[q];
        if (i != cur) {  // the same for every thread of the block
          out[(int64_t)cur * ocols + col] = acc;
          for (int r = cur + 1; r < i; ++r) out[(int64_t)r * ocols + col] = 0.f;
          cur = i;
          acc = 0.f;
        }
        acc += c[u];
      }
    }
  }
  out[(int64_t)cur * ocols + col] = acc;
  for (int r = cur + 1; r < r1; ++r) out[(int64_t)r * ocols + col] = 0.f;
}

extern "C" int xeq_message_fwd(const void* x, const void* ef, const void* wf,
                               const void* dst_ptr, const void* dst_slots,
                               const void* slot_src, const void* slot_dst,
                               const void* lane_gate, const void* lane_ycol,
                               void* out, int n_out, int ni, int nd, int hp,
                               int d, int dp, int sdp, int kw, int kf,
                               int bf16, void* stream) {
  if (kw > XEQ_MAXK || kf > XEQ_FPACK || (sdp + dp) % 128 != 0)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  const int rows_per_block = 8;
  dim3 block(128);
  dim3 grid((n_out + rows_per_block - 1) / rows_per_block, (sdp + dp) / 128);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    message_fwd_kernel<__nv_bfloat16, true><<<grid, block, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)ef,
        (const __nv_bfloat16*)wf, (const int*)dst_ptr, (const int*)dst_slots,
        (const int*)slot_src, (const int*)slot_dst, (const int*)lane_gate,
        (const int*)lane_ycol, (float*)out, n_out, rows_per_block, ni, nd, hp,
        d, dp, sdp, kw, kf);
  } else {
    message_fwd_kernel<float, false><<<grid, block, 0, s>>>(
        (const float*)x, (const float*)ef, (const float*)wf,
        (const int*)dst_ptr, (const int*)dst_slots, (const int*)slot_src,
        (const int*)slot_dst, (const int*)lane_gate, (const int*)lane_ycol,
        (float*)out, n_out, rows_per_block, ni, nd, hp, d, dp, sdp, kw, kf);
  }
  return (int)cudaGetLastError();
}
