// Second-order backward of one XPaiNN message block on Hopper: the VJP of
// message_bwd.cu's (dx, d_ef, d_wf) w.r.t. (x_cat, edge_feat, wf_aug, g) for
// cotangents (cx, cef, cwf) on those outputs.  Force training runs it: a
// loss on the forces -dE/dpos takes the gradient of a gradient.
//
// Replaces: xequinet_tpu/ops/pallas_message.py::_bwd2_kernel (:563),
// launched by _mega_bwd2_call (:770-879).
//
// Per slot k (destination i, source s), with the forward and first-order
// terms recomputed (fw = ef[k] . wf, gs | gv = x[s], fo = rnd(gs * fw),
// dfo as in message_bwd.cu, gms_v = g[i, SDp:]) and c = cef[k],
// cxh | cxv = cx[s]:
//   r[h]  = c[:Kw] . wf[:Kw, h] + ef[k, :Kf] . cwf[:Kf, h]
//   a[h]  = rnd(cxh[h] * fw[h] + r[h] * gs[h])
//   u[h]  = sum_{lanes j of irrep h} rnd(cxv[j] * gms_v[j])             h < ni
//         = sum_{lanes j of irrep h - ni} rnd(c[ycol(j)] * gms_v[j])     h < 2 ni
//   d2g[i, c]      += a[2ni + c]                                    c < node_dim
//   d2g[i, SDp+j]  += rnd(gv[j] a[gate(j)] + ef[k, ycol(j)] a[ni + gate(j)]
//                         + cxv[j] fo[gate(j)] + fo[ni + gate(j)] c[ycol(j)])
//   d2x[s, h]      += rnd(dfo[h] r[h] + u[h] fw[h])                       h < H
//   d2x[s, Hp+j]   += rnd(gms_v[j] a[gate(j)])
//   dfw2[h] = rnd(dfo[h] cxh[h] + u[h] gs[h]),  dfwr[h] = rnd(dfo[h] gs[h])
//   d2ef[k, f]     = dfw2 . wf[f] + dfwr . cwf[f]                        f < Kw
//   d2ef[k, ycol]  = sum_{lanes j of that column} rnd(gms_v[j] a[ni + gate(j)])
//                    + dfwr . cwf[ycol]
//   d2wf[f, h]    += ef[k, f] dfw2[h] + c[f] dfwr[h]          f < Kf, all slots
// This is the closed form of the TPU kernel's docstring (:591-610); its
// PyTorch twin is ops/fused_message.py::message_bwd2_closed.  The TPU
// kernel's one-hot E1/E2/MS/BY matmuls are the index maps of
// message_fwd.cu (lane_gate, lane_ycol, the lanes of each gate and of each
// harmonic column).
//
// Four launches, none with float atomics, so results repeat bit for bit:
//  * message_bwd2_dg_kernel: d2g, one thread per (destination row, output
//    column), walking the CSR list by destination as message_fwd.cu does.
//  * message_bwd2_dx_kernel: d2x, one thread per (source row, x column),
//    walking the CSR list by source as message_bwd_dx_kernel does.  These
//    two replace the TPU kernel's per-block d2g and window tiles and the
//    overlap-add of the windows (:864-869).  Each block stages its slots
//    (indices and the live columns of ef and cef, as f32) in shared memory.
//  * message_bwd2_slot_kernel: one block per contiguous slot range, 16
//    slots per step, 512 threads: d2ef rows (one warp per slot, shuffle
//    sums in fixed order) and the block's d2wf partial in shared memory,
//    each element owned by one thread.
//  * xeq_dwf_reduce_kernel (message_common.cuh): the partials summed in
//    block order.
// Nothing per slot is kept between launches: each recomputes fw, fo, dfo,
// r, a and u for the slots it walks (one [T, H] f32 intermediate would be
// 427 MB at the flagship batch).
//
// Contracts, as in message_bwd.cu: wf rows >= Kw, ef columns >= Kf and x's
// padding columns (H..Hp and Hp+D..) are zero.  For the cotangents, cef
// columns >= Kf and cwf rows >= Kf are zero (the model pads those entries
// with constants, so autograd hands in zero there).  cwf may be absent
// (CWF false): force training has no cotangent on d_wf, and the kernels
// then skip its terms.  Padding slots (dst2 == BN) and slots past the
// covered chunk range are in neither CSR list and get zero d2ef rows
// (:870-873).
//
// Bound on the H100: the function reads x, cx, ef, cef, g and wf once and
// writes d2x, d2ef, d2g and d2wf once, a few hundred MB at the flagship
// batch: memory bound.  Like the first-order kernels, this first version
// recomputes each slot's filter terms once per column that needs them on
// the FP32 pipes and gathers single elements of x, cx and g through L1/L2;
// it is bound by latency and issue rate, not by bytes.
//
// Rounding in bf16 mode mirrors _bwd2_kernel (:678, :703, :719-720, :724,
// :744-754): fo, a, the products summed into dfo and u, dfw2, dfwr, the
// harmonic terms of d2ef and the d2x and d2g rows are rounded to bf16;
// sums are f32.
#include "message_common.cuh"

// r = c . w + (CWF) e . cw: the cotangent of the radial filter at one
// hidden column.
template <bool CWF>
__device__ __forceinline__ float xeq_filter_cot(const float* e, const float* c,
                                                const float (&w)[XEQ_MAXK],
                                                const float (&cw)[XEQ_MAXK],
                                                int kw, int kf) {
  float r = xeq_filter(c, w, kw);
  if (CWF) r += xeq_filter(e, cw, kf);
  return r;
}

// Stage the cotangent rows c of the slots staged by xeq_stage_slots
// (k_s), its first kf columns as f32.  Ends with a barrier; the next
// xeq_stage_slots starts with one, so the stage is read before it is
// overwritten.
template <typename T>
__device__ __forceinline__ void xeq_stage_cef(const T* __restrict__ cef, int kf,
                                              int n, const int* k_s, float* cef_s) {
  for (int i = threadIdx.x; i < n * kf; i += blockDim.x) {
    const int q = i / kf, f = i - q * kf;
    cef_s[i] = xeq_ld(cef, (int64_t)k_s[q] * XEQ_FPACK + f);
  }
  __syncthreads();
}

template <typename T, bool BF16, bool CWF>
__global__ void __launch_bounds__(128)
message_bwd2_dg_kernel(const T* __restrict__ x, const T* __restrict__ ef,
                       const T* __restrict__ wf, const T* __restrict__ cx,
                       const T* __restrict__ cef, const T* __restrict__ cwf,
                       const int* __restrict__ dst_ptr,
                       const int* __restrict__ dst_slots,
                       const int* __restrict__ slot_src,
                       const int* __restrict__ slot_dst,
                       const int* __restrict__ lane_gate,
                       const int* __restrict__ lane_ycol, float* __restrict__ d2g,
                       int n_out, int rows_per_block, int ni, int nd, int hp, int d,
                       int dp, int sdp, int kw, int kf) {
  __shared__ int k_s[XEQ_STAGE], dst_s[XEQ_STAGE], src_s[XEQ_STAGE];
  __shared__ float ef_s[XEQ_STAGE * XEQ_FPACK];
  __shared__ float cef_s[XEQ_STAGE * XEQ_FPACK];
  const int ocols = sdp + dp;
  const int xs = hp + dp;
  // the wrapper launches ocols / 128 column tiles of 128 threads
  const int col = blockIdx.y * blockDim.x + threadIdx.x;

  // column role: scalar (h1 only), vector lane (h1, h2, vx, yc) or padding
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
  float w1[XEQ_MAXK], w2[XEQ_MAXK], c1[XEQ_MAXK], c2[XEQ_MAXK];
  xeq_load_column(wf, hp, h1, kw, w1);
  xeq_load_column(wf, hp, h2, kw, w2);
  xeq_load_column(cwf, hp, CWF ? h1 : -1, kf, c1);
  xeq_load_column(cwf, hp, CWF ? h2 : -1, kf, c2);

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
    xeq_stage_cef(cef, kf, n, k_s, cef_s);
    for (int q0 = 0; q0 < n; q0 += XEQ_ILP) {
      // the rows of XEQ_ILP slots first, so their loads overlap
      float v[XEQ_ILP];
#pragma unroll
      for (int u = 0; u < XEQ_ILP; ++u) {
        const int q = q0 + u;
        v[u] = 0.f;
        if (q < n && h1 >= 0) {
          const float* e = ef_s + q * kf;
          const float* c = cef_s + q * kf;
          const T* xr = x + (int64_t)src_s[q] * xs;
          const T* cr = cx + (int64_t)src_s[q] * xs;
          const float gs1 = xeq_ld(xr, h1);
          const float fw1 = xeq_filter(e, w1, kw);
          const float a1 = xeq_rnd<BF16>(xeq_ld(cr, h1) * fw1 +
                                         xeq_filter_cot<CWF>(e, c, w1, c1, kw, kf) * gs1);
          if (h2 < 0) {
            v[u] = a1;
          } else {
            const float gs2 = xeq_ld(xr, h2);
            const float fw2 = xeq_filter(e, w2, kw);
            const float a2 = xeq_rnd<BF16>(xeq_ld(cr, h2) * fw2 +
                                           xeq_filter_cot<CWF>(e, c, w2, c2, kw, kf) * gs2);
            const float g1 = xeq_rnd<BF16>(gs1 * fw1);
            const float g2 = xeq_rnd<BF16>(gs2 * fw2);
            v[u] = xeq_rnd<BF16>(xeq_ld(xr, vx) * a1 + e[yc] * a2 +
                                 xeq_ld(cr, vx) * g1 + g2 * c[yc]);
          }
        }
      }
      // then the sums, in slot order
#pragma unroll
      for (int u = 0; u < XEQ_ILP; ++u) {
        const int q = q0 + u;
        if (q >= n) break;
        const int i = dst_s[q];
        if (i != cur) {  // the same for every thread of the block
          d2g[(int64_t)cur * ocols + col] = acc;
          for (int r = cur + 1; r < i; ++r) d2g[(int64_t)r * ocols + col] = 0.f;
          cur = i;
          acc = 0.f;
        }
        acc += v[u];
      }
    }
  }
  d2g[(int64_t)cur * ocols + col] = acc;
  for (int r = cur + 1; r < r1; ++r) d2g[(int64_t)r * ocols + col] = 0.f;
}

template <typename T, bool BF16, bool CWF>
__global__ void __launch_bounds__(128)
message_bwd2_dx_kernel(const T* __restrict__ x, const T* __restrict__ ef,
                       const T* __restrict__ wf, const T* __restrict__ g,
                       const T* __restrict__ cx, const T* __restrict__ cef,
                       const T* __restrict__ cwf, const int* __restrict__ src_ptr,
                       const int* __restrict__ src_slots,
                       const int* __restrict__ slot_src,
                       const int* __restrict__ slot_dst,
                       const int* __restrict__ lane_gate,
                       const int* __restrict__ lane_ycol,
                       const int* __restrict__ gate_lane0,
                       const int* __restrict__ gate_dim, float* __restrict__ d2x,
                       int n_rows, int rows_per_block, int ni, int h_dim, int hp,
                       int d, int dp, int sdp, int kw, int kf) {
  __shared__ int k_s[XEQ_STAGE], src_s[XEQ_STAGE], dst_s[XEQ_STAGE];
  __shared__ float ef_s[XEQ_STAGE * XEQ_FPACK];
  __shared__ float cef_s[XEQ_STAGE * XEQ_FPACK];
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
  float w[XEQ_MAXK], cw[XEQ_MAXK];
  xeq_load_column(wf, hp, wcol, kw, w);
  xeq_load_column(cwf, hp, CWF ? wcol : -1, kf, cw);

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
    xeq_stage_cef(cef, kf, n, k_s, cef_s);
    for (int q0 = 0; q0 < n; q0 += XEQ_ILP) {
      // the contributions of XEQ_ILP slots first, so their loads overlap
      float v[XEQ_ILP];
#pragma unroll
      for (int u = 0; u < XEQ_ILP; ++u) {
        const int q = q0 + u;
        v[u] = 0.f;
        if (q < n && wcol >= 0) {
          const float* e = ef_s + q * kf;
          const float* c = cef_s + q * kf;
          const T* xr = x + (int64_t)src_s[q] * xs;
          const T* cr = cx + (int64_t)src_s[q] * xs;
          const T* gr = g + (int64_t)dst_s[q] * gs;
          const float fw = xeq_filter(e, w, kw);
          const float r = xeq_filter_cot<CWF>(e, c, w, cw, kw, kf);
          if (h_col >= 0) {
            const float dfo = dfo_at<T, BF16>(h_col, e, gr, xr, gate_lane0,
                                              gate_dim, lane_ycol, ni, hp, sdp);
            float uc = 0.f;
            if (h_col < 2 * ni) {
              const bool state = h_col < ni;
              uc = xeq_gate_sum<T, BF16>(state, state ? h_col : h_col - ni, c, cr,
                                         gr, gate_lane0, gate_dim, lane_ycol, hp, sdp);
            }
            v[u] = xeq_rnd<BF16>(dfo * r + uc * fw);
          } else {
            const float a = xeq_rnd<BF16>(xeq_ld(cr, wcol) * fw + r * xeq_ld(xr, wcol));
            v[u] = xeq_rnd<BF16>(xeq_ld(gr, sdp + jv) * a);
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
          d2x[(int64_t)cur * xs + col] = acc;
          for (int r = cur + 1; r < s; ++r) d2x[(int64_t)r * xs + col] = 0.f;
          cur = s;
          acc = 0.f;
        }
        acc += v[u];
      }
    }
  }
  d2x[(int64_t)cur * xs + col] = acc;
  for (int r = cur + 1; r < r1; ++r) d2x[(int64_t)r * xs + col] = 0.f;
}

#define XEQ_TS2 16
#define XEQ_SLOT2_THREADS 512

template <typename T, bool BF16, bool CWF>
__global__ void __launch_bounds__(XEQ_SLOT2_THREADS)
message_bwd2_slot_kernel(const T* __restrict__ x, const T* __restrict__ ef,
                         const T* __restrict__ wf, const T* __restrict__ g,
                         const T* __restrict__ cx, const T* __restrict__ cef,
                         const T* __restrict__ cwf,
                         const int* __restrict__ slot_src,
                         const int* __restrict__ slot_dst,
                         const int* __restrict__ lane_gate,
                         const int* __restrict__ lane_ycol,
                         const int* __restrict__ gate_lane0,
                         const int* __restrict__ gate_dim,
                         const int* __restrict__ ylane_ptr,
                         const int* __restrict__ ylane_idx,
                         float* __restrict__ d2ef, float* __restrict__ dwf_part,
                         int n_slots, int slots_per_block, int ni, int h_dim,
                         int hp, int dp, int sdp, int kw, int kf) {
  extern __shared__ float smem[];
  float* a2_s = smem;                        // [TS][ni]  a at the edge gates
  float* dfw2_s = a2_s + XEQ_TS2 * ni;       // [TS][H]
  float* dfwr_s = dfw2_s + XEQ_TS2 * h_dim;  // [TS][H]
  float* ef_s = dfwr_s + XEQ_TS2 * h_dim;    // [TS][Kf]
  float* cef_s = ef_s + XEQ_TS2 * kf;        // [TS][Kf]
  float* dwf_s = cef_s + XEQ_TS2 * kf;       // [Kf][H]  this block's partial
  float* wf_s = dwf_s + kf * h_dim;          // [Kw][H]  live rows of wf
  __shared__ int src_s[XEQ_TS2], dst_s[XEQ_TS2];

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
  for (int base = k0; base < k1; base += XEQ_TS2) {
    if (tid < XEQ_TS2) {
      const int k = base + tid;
      const bool ok = k < k1 && slot_dst[k] >= 0;
      src_s[tid] = ok ? slot_src[k] : -1;
      dst_s[tid] = ok ? slot_dst[k] : -1;
    }
    __syncthreads();
    for (int i = tid; i < XEQ_TS2 * kf; i += nthr) {
      const int t = i / kf, f = i - t * kf;
      const bool ok = dst_s[t] >= 0;
      const int64_t at = (int64_t)(base + t) * XEQ_FPACK + f;
      ef_s[i] = ok ? xeq_ld(ef, at) : 0.f;
      cef_s[i] = ok ? xeq_ld(cef, at) : 0.f;
    }
    __syncthreads();
    // A1: a at the edge gates h = ni + u of each slot of the step,
    // XEQ_ILP items per thread at a time so their loads overlap
    for (int i0 = tid; i0 < XEQ_TS2 * ni; i0 += XEQ_ILP * nthr) {
      float v[XEQ_ILP];
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        v[c] = 0.f;
        if (i >= XEQ_TS2 * ni) continue;
        const int t = i / ni, u = i - t * ni;
        if (dst_s[t] >= 0) {
          const int h = ni + u;
          const float* e = ef_s + t * kf;
          const float* cr = cef_s + t * kf;
          float fw = 0.f, r = 0.f;
          for (int f = 0; f < kw; ++f) {
            fw += e[f] * wf_s[f * h_dim + h];
            r += cr[f] * wf_s[f * h_dim + h];
          }
          if (CWF) {
            for (int f = 0; f < kf; ++f) r += e[f] * xeq_ld(cwf, (int64_t)f * hp + h);
          }
          const int64_t row = (int64_t)src_s[t] * xs;
          v[c] = xeq_rnd<BF16>(xeq_ld(cx, row + h) * fw + r * xeq_ld(x, row + h));
        }
      }
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        if (i < XEQ_TS2 * ni) a2_s[i] = v[c];
      }
    }
    // A2: dfw2 = rnd(dfo cxh + u gs) and dfwr = rnd(dfo gs) at every hidden
    // column, XEQ_ILP items per thread at a time
    for (int i0 = tid; i0 < XEQ_TS2 * h_dim; i0 += XEQ_ILP * nthr) {
      float v2[XEQ_ILP], vr[XEQ_ILP];
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        v2[c] = 0.f;
        vr[c] = 0.f;
        if (i >= XEQ_TS2 * h_dim) continue;
        const int t = i / h_dim, h = i - t * h_dim;
        if (dst_s[t] >= 0) {
          const T* gr = g + (int64_t)dst_s[t] * gs;
          const T* xr = x + (int64_t)src_s[t] * xs;
          const T* cr = cx + (int64_t)src_s[t] * xs;
          const float dfo = dfo_at<T, BF16>(h, ef_s + t * kf, gr, xr, gate_lane0,
                                            gate_dim, lane_ycol, ni, hp, sdp);
          float uc = 0.f;
          if (h < 2 * ni) {
            const bool state = h < ni;
            uc = xeq_gate_sum<T, BF16>(state, state ? h : h - ni, cef_s + t * kf, cr,
                                       gr, gate_lane0, gate_dim, lane_ycol, hp, sdp);
          }
          const float gsh = xeq_ld(xr, h);
          v2[c] = xeq_rnd<BF16>(dfo * xeq_ld(cr, h) + uc * gsh);
          vr[c] = xeq_rnd<BF16>(dfo * gsh);
        }
      }
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        if (i < XEQ_TS2 * h_dim) {
          dfw2_s[i] = v2[c];
          dfwr_s[i] = vr[c];
        }
      }
    }
    __syncthreads();
    // A3: d2wf partial, element (f, h) owned by one thread, slots in order
    for (int i = tid; i < kf * h_dim; i += nthr) {
      const int f = i / h_dim, h = i - f * h_dim;
      float acc = dwf_s[i];
#pragma unroll
      for (int t = 0; t < XEQ_TS2; ++t)
        acc += ef_s[t * kf + f] * dfw2_s[t * h_dim + h] +
               cef_s[t * kf + f] * dfwr_s[t * h_dim + h];
      dwf_s[i] = acc;
    }
    // B: d2ef rows, one warp per slot
    for (int t = warp; t < XEQ_TS2; t += nthr / 32) {
      const int k = base + t;
      if (k >= k1) continue;
      float* row = d2ef + (int64_t)k * XEQ_FPACK;
      if (dst_s[t] < 0) {
        for (int f = lane; f < XEQ_FPACK; f += 32) row[f] = 0.f;
        continue;
      }
      const float* p2 = dfw2_s + t * h_dim;
      const float* pr = dfwr_s + t * h_dim;
      for (int f = 0; f < kw; ++f) {
        float acc = 0.f;
        for (int h = lane; h < h_dim; h += 32) {
          acc += p2[h] * wf_s[f * h_dim + h];
          if (CWF) acc += pr[h] * xeq_ld(cwf, (int64_t)f * hp + h);
        }
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) row[f] = acc;
      }
      const T* gr = g + (int64_t)dst_s[t] * gs;
      for (int y = 0; y < n_y; ++y) {
        float acc = 0.f;
        for (int q = ylane_ptr[y] + lane; q < ylane_ptr[y + 1]; q += 32) {
          const int j = ylane_idx[q];
          acc += xeq_rnd<BF16>(xeq_ld(gr, sdp + j) * a2_s[t * ni + lane_gate[j]]);
        }
        if (CWF) {
          for (int h = lane; h < h_dim; h += 32)
            acc += pr[h] * xeq_ld(cwf, (int64_t)(kw + y) * hp + h);
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

template <typename T, bool BF16, bool CWF>
static int launch_bwd2(const void* x, const void* ef, const void* wf,
                       const void* g, const void* cx, const void* cef,
                       const void* cwf, const void* dst_ptr,
                       const void* dst_slots, const void* src_ptr,
                       const void* src_slots, const void* slot_src,
                       const void* slot_dst, const void* lane_gate,
                       const void* lane_ycol, const void* gate_lane0,
                       const void* gate_dim, const void* ylane_ptr,
                       const void* ylane_idx, void* d2x, void* d2ef,
                       void* dwf_part, void* d2wf, void* d2g, int n_out,
                       int n_rows, int n_slots, int n_part, int ni, int nd,
                       int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                       cudaStream_t s) {
  const int rows_per_block = 8;
  if (n_out > 0) {
    dim3 grid((n_out + rows_per_block - 1) / rows_per_block, (sdp + dp) / 128);
    message_bwd2_dg_kernel<T, BF16, CWF><<<grid, 128, 0, s>>>(
        (const T*)x, (const T*)ef, (const T*)wf, (const T*)cx, (const T*)cef,
        (const T*)cwf, (const int*)dst_ptr, (const int*)dst_slots,
        (const int*)slot_src, (const int*)slot_dst, (const int*)lane_gate,
        (const int*)lane_ycol, (float*)d2g, n_out, rows_per_block, ni, nd, hp, d,
        dp, sdp, kw, kf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_rows > 0) {
    dim3 grid((n_rows + rows_per_block - 1) / rows_per_block, (hp + dp) / 128);
    message_bwd2_dx_kernel<T, BF16, CWF><<<grid, 128, 0, s>>>(
        (const T*)x, (const T*)ef, (const T*)wf, (const T*)g, (const T*)cx,
        (const T*)cef, (const T*)cwf, (const int*)src_ptr, (const int*)src_slots,
        (const int*)slot_src, (const int*)slot_dst, (const int*)lane_gate,
        (const int*)lane_ycol, (const int*)gate_lane0, (const int*)gate_dim,
        (float*)d2x, n_rows, rows_per_block, ni, h_dim, hp, d, dp, sdp, kw, kf);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem =
      sizeof(float) * ((size_t)XEQ_TS2 * ni + 2 * (size_t)XEQ_TS2 * h_dim +
                       2 * (size_t)XEQ_TS2 * kf + (size_t)kf * h_dim +
                       (size_t)kw * h_dim);
  cudaError_t err = cudaFuncSetAttribute(
      message_bwd2_slot_kernel<T, BF16, CWF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = ((n_slots + n_part - 1) / n_part + XEQ_TS2 - 1) / XEQ_TS2 * XEQ_TS2;
  message_bwd2_slot_kernel<T, BF16, CWF><<<n_part, XEQ_SLOT2_THREADS, smem, s>>>(
      (const T*)x, (const T*)ef, (const T*)wf, (const T*)g, (const T*)cx,
      (const T*)cef, (const T*)cwf, (const int*)slot_src, (const int*)slot_dst,
      (const int*)lane_gate, (const int*)lane_ycol, (const int*)gate_lane0,
      (const int*)gate_dim, (const int*)ylane_ptr, (const int*)ylane_idx,
      (float*)d2ef, (float*)dwf_part, n_slots, per, ni, h_dim, hp, dp, sdp, kw, kf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)d2wf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

#define XEQ_BWD2_ARGS                                                          \
  x, ef, wf, g, cx, cef, cwf, dst_ptr, dst_slots, src_ptr, src_slots,          \
      slot_src, slot_dst, lane_gate, lane_ycol, gate_lane0, gate_dim,          \
      ylane_ptr, ylane_idx, d2x, d2ef, dwf_part, d2wf, d2g, n_out, n_rows,     \
      n_slots, n_part, ni, nd, h_dim, hp, d, dp, sdp, kw, kf, s

extern "C" int xeq_message_bwd2(
    const void* x, const void* ef, const void* wf, const void* g,
    const void* cx, const void* cef, const void* cwf, const void* dst_ptr,
    const void* dst_slots, const void* src_ptr, const void* src_slots,
    const void* slot_src, const void* slot_dst, const void* lane_gate,
    const void* lane_ycol, const void* gate_lane0, const void* gate_dim,
    const void* ylane_ptr, const void* ylane_idx, void* d2x, void* d2ef,
    void* dwf_part, void* d2wf, void* d2g, int n_out, int n_rows, int n_slots,
    int n_part, int ni, int nd, int h_dim, int hp, int d, int dp, int sdp,
    int kw, int kf, int bf16, int has_cwf, void* stream) {
  if (kw > XEQ_MAXK || kf > XEQ_FPACK || (has_cwf && kf > XEQ_MAXK) ||
      (hp + dp) % 128 != 0 || (sdp + dp) % 128 != 0 || n_part < 1 ||
      (has_cwf && cwf == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    if (has_cwf) return launch_bwd2<__nv_bfloat16, true, true>(XEQ_BWD2_ARGS);
    return launch_bwd2<__nv_bfloat16, true, false>(XEQ_BWD2_ARGS);
  }
  if (has_cwf) return launch_bwd2<float, false, true>(XEQ_BWD2_ARGS);
  return launch_bwd2<float, false, false>(XEQ_BWD2_ARGS);
}
