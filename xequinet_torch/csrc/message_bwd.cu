// First-order backward of one XPaiNN message block on Hopper: the VJP of
// message_fwd.cu w.r.t. (x_cat, edge_feat, wf_aug) for a cotangent g on
// the aggregate.  This is what forces (-dE/dpos) run through.
//
// Replaces: xequinet_tpu/ops/pallas_message.py::_bwd_kernel (:331),
// launched by _mega_bwd_call (:458-557).
//
// Per slot k (destination i, source s), with gm = g[i], gms_s = gm[:SDp],
// gms_v = gm[SDp:] and the forward recomputed (fw, fo):
//   dfo[u]        = sum_{lanes j of irrep u} rnd(x[s,Hp+j] * gms_v[j])
//   dfo[ni+u]     = sum_{lanes j of irrep u} rnd(ef[k,ycol(j)] * gms_v[j])
//   dfo[2ni+c]    = gms_s[c]
//   dx[s, h]     += rnd(dfo[h] * fw[h])                        (dgs)
//   dx[s, Hp+j]  += rnd(fo[gate(j)] * gms_v[j])                (dgv)
//   dfw[h]        = rnd(dfo[h] * x[s, h])
//   drsh[j]       = rnd(fo[ni+gate(j)] * gms_v[j])
//   d_ef[k, f<Kw] = sum_h dfw[h] * wf[f, h]
//   d_ef[k, ycol] = sum_{lanes j with that harmonic column} drsh[j]
//   d_wf[f, h]   += ef[k, f] * dfw[h]                          (all slots)
//
// Three kernels, none with float atomics, so fixed-seed values repeat
// from run to run:
//  * message_bwd_dx_kernel: one thread per (source row, x column) walks
//    the slots that gather from that row (a CSR list by source, built by
//    the wrapper) and writes dx once.  This replaces the TPU kernel's
//    per-block window tiles and their overlap-add (:541-546): the scatter
//    by src becomes a gather by src.  As in message_fwd.cu, a block owns 8
//    rows and a 128-column tile and stages its slots (indices, the live
//    edge-feature columns) in shared memory.
//  * message_bwd_slot_kernel: one block per contiguous slot range, 16
//    slots per step, 512 threads.  It keeps the live rows of wf in shared
//    memory, stages dfw and the edge-gate fo of the step there, writes
//    each slot's d_ef row (one warp per slot, warp-shuffle sums in fixed
//    order) and keeps its own partial d_wf [Kf, H] in shared memory, each
//    element owned by one thread.  Shared memory is
//    4 * (16 * (ni + H + Kf) + (Kf + Kw) * H) bytes, 168 KB at the flagship
//    widths, so one block runs per SM; the wrapper launches one per SM.
//  * xeq_dwf_reduce_kernel (message_common.cuh): the second pass, summing
//    the per-block d_wf partials in block order.
//
// Padding slots (dst2 == BN) and slots past the covered chunk range
// (slot_dst < 0 in the wrapper's plan) add nothing and get zero d_ef rows
// (:547-552).  Contracts from the packing (pallas_message.py:151-171 and
// xpainn.py:282-295): wf_aug rows >= Kw = num_basis+1 are zero and
// edge_feat columns >= Kf = Kw + nY are zero, so d_ef and d_wf are zero
// outside the live columns / rows.
//
// Bound on the H100: the function reads x, ef, g and writes dx, d_ef and
// d_wf once, a few hundred MB at the flagship batch: memory bound.  This
// first version does the small contractions on the FP32 pipes, reads x and
// g elements through L1/L2 in both kernels, and is bound by their latency
// and by issue rate, not by bytes.
//
// Rounding in bf16 mode mirrors _bwd_kernel (:411-433): fo, dgv, drsh,
// dgs and dfw are rounded to bf16; sums are f32.
#include "message_common.cuh"

template <typename T, bool BF16>
__global__ void __launch_bounds__(128)
message_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ ef,
                      const T* __restrict__ wf, const T* __restrict__ g,
                      const int* __restrict__ src_ptr,
                      const int* __restrict__ src_slots,
                      const int* __restrict__ slot_src,
                      const int* __restrict__ slot_dst,
                      const int* __restrict__ lane_gate,
                      const int* __restrict__ lane_ycol,
                      const int* __restrict__ gate_lane0,
                      const int* __restrict__ gate_dim,
                      float* __restrict__ dx, int n_rows, int rows_per_block,
                      int ni, int h_dim, int hp, int d, int dp, int sdp,
                      int kw, int kf) {
  __shared__ int k_s[XEQ_STAGE], src_s[XEQ_STAGE], dst_s[XEQ_STAGE];
  __shared__ float ef_s[XEQ_STAGE * XEQ_FPACK];
  const int xs = hp + dp;
  const int gs = sdp + dp;
  // the wrapper launches xs / 128 column tiles of 128 threads
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  // role: hidden column (h_col >= 0), vector lane (jv >= 0) or padding
  int h_col = -1, jv = -1, wcol = -1;
  if (col < h_dim) {
    h_col = col;
    wcol = col;
  } else if (col >= hp && col < hp + d) {
    jv = col - hp;
    wcol = lane_gate[jv];
  }
  float w[XEQ_MAXK];
  xeq_load_column(wf, hp, wcol, kw, w);

  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, n_rows);
  if (r0 >= r1) return;  // the whole block
  const int p1 = src_ptr[r1];
  int cur = r0;
  float acc = 0.f;
  for (int base = src_ptr[r0]; base < p1; base += XEQ_STAGE) {
    const int n = min(XEQ_STAGE, p1 - base);
    xeq_stage_slots(src_slots, base, n, slot_src, slot_dst, ef, kf, k_s, src_s,
                    dst_s, ef_s);
    for (int q0 = 0; q0 < n; q0 += XEQ_ILP) {
      // the contributions of XEQ_ILP slots first, so their loads overlap
      float c[XEQ_ILP];
#pragma unroll
      for (int u = 0; u < XEQ_ILP; ++u) {
        const int q = q0 + u;
        c[u] = 0.f;
        if (q < n && wcol >= 0) {
          const float* e = ef_s + q * kf;
          const T* xr = x + (int64_t)src_s[q] * xs;
          const T* gr = g + (int64_t)dst_s[q] * gs;
          const float fw = xeq_filter(e, w, kw);
          if (h_col >= 0) {
            const float dfo = dfo_at<T, BF16>(h_col, e, gr, xr, gate_lane0,
                                              gate_dim, lane_ycol, ni, hp, sdp);
            c[u] = xeq_rnd<BF16>(dfo * fw);
          } else {
            const float g1 = xeq_rnd<BF16>(xeq_ld(xr, wcol) * fw);
            c[u] = xeq_rnd<BF16>(g1 * xeq_ld(gr, sdp + jv));
          }
        }
      }
      // then the sums, in slot order
#pragma unroll
      for (int u = 0; u < XEQ_ILP; ++u) {
        const int q = q0 + u;
        if (q >= n) break;
        const int s = src_s[q];
        if (s != cur) {  // the same for every thread of the block
          dx[(int64_t)cur * xs + col] = acc;
          for (int r = cur + 1; r < s; ++r) dx[(int64_t)r * xs + col] = 0.f;
          cur = s;
          acc = 0.f;
        }
        acc += c[u];
      }
    }
  }
  dx[(int64_t)cur * xs + col] = acc;
  for (int r = cur + 1; r < r1; ++r) dx[(int64_t)r * xs + col] = 0.f;
}

#define XEQ_TS 16
#define XEQ_SLOT_THREADS 512

template <typename T, bool BF16>
__global__ void __launch_bounds__(XEQ_SLOT_THREADS)
message_bwd_slot_kernel(const T* __restrict__ x, const T* __restrict__ ef,
                        const T* __restrict__ wf, const T* __restrict__ g,
                        const int* __restrict__ slot_src,
                        const int* __restrict__ slot_dst,
                        const int* __restrict__ lane_gate,
                        const int* __restrict__ lane_ycol,
                        const int* __restrict__ gate_lane0,
                        const int* __restrict__ gate_dim,
                        const int* __restrict__ ylane_ptr,
                        const int* __restrict__ ylane_idx,
                        float* __restrict__ d_ef, float* __restrict__ dwf_part,
                        int n_slots, int slots_per_block, int ni, int h_dim,
                        int hp, int dp, int sdp, int kw, int kf) {
  extern __shared__ float smem[];
  float* fo_s = smem;                      // [TS][ni]   edge-gate filter_out
  float* dfw_s = fo_s + XEQ_TS * ni;       // [TS][H]
  float* ef_s = dfw_s + XEQ_TS * h_dim;    // [TS][Kf]
  float* dwf_s = ef_s + XEQ_TS * kf;       // [Kf][H]   this block's partial
  float* wf_s = dwf_s + kf * h_dim;        // [Kw][H]   live rows of wf
  __shared__ int src_s[XEQ_TS], dst_s[XEQ_TS];

  const int xs = hp + dp;
  const int gs = sdp + dp;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_y = kf - kw;

  for (int i = tid; i < kf * h_dim; i += nthr) dwf_s[i] = 0.f;
  for (int i = tid; i < kw * h_dim; i += nthr) {
    const int f = i / h_dim, h = i - f * h_dim;
    wf_s[i] = xeq_ld(wf, (int64_t)f * hp + h);
  }

  const int k0 = blockIdx.x * slots_per_block;
  const int k1 = min(k0 + slots_per_block, n_slots);
  for (int base = k0; base < k1; base += XEQ_TS) {
    if (tid < XEQ_TS) {
      const int k = base + tid;
      const bool ok = k < k1 && slot_dst[k] >= 0;
      src_s[tid] = ok ? slot_src[k] : -1;
      dst_s[tid] = ok ? slot_dst[k] : -1;
    }
    __syncthreads();
    for (int i = tid; i < XEQ_TS * kf; i += nthr) {
      const int t = i / kf, f = i - t * kf;
      ef_s[i] = dst_s[t] >= 0 ? xeq_ld(ef, (int64_t)(base + t) * XEQ_FPACK + f)
                              : 0.f;
    }
    __syncthreads();
    // A1: edge-gate filter_out fo[ni + u] of each slot of the step,
    // XEQ_ILP items per thread at a time so their loads overlap
    for (int i0 = tid; i0 < XEQ_TS * ni; i0 += XEQ_ILP * nthr) {
      float v[XEQ_ILP];
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        v[c] = 0.f;
        if (i >= XEQ_TS * ni) continue;
        const int t = i / ni, u = i - t * ni;
        if (dst_s[t] >= 0) {
          const int h = ni + u;
          float fw = 0.f;
          for (int f = 0; f < kw; ++f) fw += ef_s[t * kf + f] * wf_s[f * h_dim + h];
          v[c] = xeq_rnd<BF16>(xeq_ld(x, (int64_t)src_s[t] * xs + h) * fw);
        }
      }
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        if (i < XEQ_TS * ni) fo_s[i] = v[c];
      }
    }
    // A2: dfw = rnd(dfo * x) for every hidden column, XEQ_ILP items per
    // thread at a time
    for (int i0 = tid; i0 < XEQ_TS * h_dim; i0 += XEQ_ILP * nthr) {
      float v[XEQ_ILP];
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        v[c] = 0.f;
        if (i >= XEQ_TS * h_dim) continue;
        const int t = i / h_dim, h = i - t * h_dim;
        if (dst_s[t] >= 0) {
          const T* gr = g + (int64_t)dst_s[t] * gs;
          const T* xr = x + (int64_t)src_s[t] * xs;
          const float dfo = dfo_at<T, BF16>(h, ef_s + t * kf, gr, xr, gate_lane0,
                                            gate_dim, lane_ycol, ni, hp, sdp);
          v[c] = xeq_rnd<BF16>(dfo * xeq_ld(xr, h));
        }
      }
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        if (i < XEQ_TS * h_dim) dfw_s[i] = v[c];
      }
    }
    __syncthreads();
    // A3: d_wf partial, element (f, h) owned by one thread, slots in order
    for (int i = tid; i < kf * h_dim; i += nthr) {
      const int f = i / h_dim, h = i - f * h_dim;
      float acc = dwf_s[i];
#pragma unroll
      for (int t = 0; t < XEQ_TS; ++t) acc += ef_s[t * kf + f] * dfw_s[t * h_dim + h];
      dwf_s[i] = acc;
    }
    // B: d_ef rows, one warp per slot
    for (int t = warp; t < XEQ_TS; t += nthr / 32) {
      const int k = base + t;
      if (k >= k1) continue;
      float* row = d_ef + (int64_t)k * XEQ_FPACK;
      if (dst_s[t] < 0) {
        for (int f = lane; f < XEQ_FPACK; f += 32) row[f] = 0.f;
        continue;
      }
      for (int f = 0; f < kw; ++f) {
        float acc = 0.f;
        for (int h = lane; h < h_dim; h += 32)
          acc += dfw_s[t * h_dim + h] * wf_s[f * h_dim + h];
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) row[f] = acc;
      }
      const T* gr = g + (int64_t)dst_s[t] * gs;
      for (int y = 0; y < n_y; ++y) {
        float acc = 0.f;
        for (int q = ylane_ptr[y] + lane; q < ylane_ptr[y + 1]; q += 32) {
          const int j = ylane_idx[q];
          acc += xeq_rnd<BF16>(fo_s[t * ni + lane_gate[j]] * xeq_ld(gr, sdp + j));
        }
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) row[kw + y] = acc;
      }
      for (int f = kf + lane; f < XEQ_FPACK; f += 32) row[f] = 0.f;
    }
    __syncthreads();
  }
  float* part = dwf_part + (int64_t)blockIdx.x * kf * h_dim;
  for (int i = tid; i < kf * h_dim; i += nthr) part[i] = dwf_s[i];
}

template <typename T, bool BF16>
static int launch_bwd(const void* x, const void* ef, const void* wf,
                      const void* g, const void* src_ptr,
                      const void* src_slots, const void* slot_src,
                      const void* slot_dst, const void* lane_gate,
                      const void* lane_ycol, const void* gate_lane0,
                      const void* gate_dim, const void* ylane_ptr,
                      const void* ylane_idx, void* dx, void* d_ef,
                      void* dwf_part, void* dwf, int n_rows, int n_slots,
                      int n_part, int ni, int h_dim, int hp, int d, int dp,
                      int sdp, int kw, int kf, cudaStream_t s) {
  const int rows_per_block = 8;
  if (n_rows > 0) {
    dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, (hp + dp) / 128);
    message_bwd_dx_kernel<T, BF16><<<grid, 128, 0, s>>>(
        (const T*)x, (const T*)ef, (const T*)wf, (const T*)g,
        (const int*)src_ptr, (const int*)src_slots, (const int*)slot_src,
        (const int*)slot_dst, (const int*)lane_gate, (const int*)lane_ycol,
        (const int*)gate_lane0, (const int*)gate_dim, (float*)dx, n_rows,
        rows_per_block, ni, h_dim, hp, d, dp, sdp, kw, kf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem =
      sizeof(float) * ((size_t)XEQ_TS * ni + (size_t)XEQ_TS * h_dim +
                       (size_t)XEQ_TS * kf + (size_t)kf * h_dim +
                       (size_t)kw * h_dim);
  cudaError_t err = cudaFuncSetAttribute(
      message_bwd_slot_kernel<T, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = ((n_slots + n_part - 1) / n_part + XEQ_TS - 1) / XEQ_TS * XEQ_TS;
  message_bwd_slot_kernel<T, BF16><<<n_part, XEQ_SLOT_THREADS, smem, s>>>(
      (const T*)x, (const T*)ef, (const T*)wf, (const T*)g,
      (const int*)slot_src, (const int*)slot_dst, (const int*)lane_gate,
      (const int*)lane_ycol, (const int*)gate_lane0, (const int*)gate_dim,
      (const int*)ylane_ptr, (const int*)ylane_idx, (float*)d_ef,
      (float*)dwf_part, n_slots, per, ni, h_dim, hp, dp, sdp, kw, kf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)dwf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

extern "C" int xeq_message_bwd(const void* x, const void* ef, const void* wf,
                               const void* g, const void* src_ptr,
                               const void* src_slots, const void* slot_src,
                               const void* slot_dst, const void* lane_gate,
                               const void* lane_ycol, const void* gate_lane0,
                               const void* gate_dim, const void* ylane_ptr,
                               const void* ylane_idx, void* dx, void* d_ef,
                               void* dwf_part, void* dwf, int n_rows,
                               int n_slots, int n_part, int ni, int h_dim,
                               int hp, int d, int dp, int sdp, int kw, int kf,
                               int bf16, void* stream) {
  if (kw > XEQ_MAXK || kf > XEQ_FPACK || (hp + dp) % 128 != 0 || n_part < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_bwd<__nv_bfloat16, true>(
        x, ef, wf, g, src_ptr, src_slots, slot_src, slot_dst, lane_gate,
        lane_ycol, gate_lane0, gate_dim, ylane_ptr, ylane_idx, dx, d_ef,
        dwf_part, dwf, n_rows, n_slots, n_part, ni, h_dim, hp, d, dp, sdp, kw,
        kf, s);
  return launch_bwd<float, false>(
      x, ef, wf, g, src_ptr, src_slots, slot_src, slot_dst, lane_gate,
      lane_ycol, gate_lane0, gate_dim, ylane_ptr, ylane_idx, dx, d_ef,
      dwf_part, dwf, n_rows, n_slots, n_part, ni, h_dim, hp, d, dp, sdp, kw,
      kf, s);
}
