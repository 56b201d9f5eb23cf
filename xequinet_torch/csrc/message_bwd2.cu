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
// Bound on the H100: the function reads x, cx, ef, cef, g and wf once and
// writes d2x, d2ef, d2g and d2wf once, 289.6 MB at the flagship batch in
// bf16 (0.087 ms at 3.35 TB/s); its filter contractions are ~27 GFLOP,
// 0.027 ms on the bf16 tensor cores.  Memory bound.  The first version
// (10.598 ms per launch in bf16) ran the contractions on the FP32 pipes out
// of shared memory, and its d2x and d2g walks recomputed fw, r, a, dfo and
// u of every slot from single-element loads, once per column.
//
// The bf16 instance without cwf (force training's) is three passes and the
// reduction, no float atomics, so results repeat bit for bit:
//  * message_bwd2_tile_kernel: persistent blocks of 512 threads, one per
//    SM, walk tiles of XEQ_BT = 16 consecutive slots (tile = block + i *
//    grid), as message_bwd_tile_kernel does.  Each slot's x and cx rows
//    (live H + D columns), g row (node_dim + D) and the first Kf (rounded
//    up to 32) columns of ef and cef are staged with cp.async.  One stage only: with wf's live
//    rows, the bf16 dfw2 / dfwr tiles and the f32 dfo / u gate sums it
//    takes 226 KB at the flagship widths, so the next tile's copies are
//    issued once the current tile's rows have been read (before its d2ef
//    columns are written), and its slot indices a tile earlier.  On the
//    tensor cores (mma.sync m16n8k16, bf16 operands, f32 accumulators):
//      fw = ef[:, :32] @ wf, r = cef[:, :32] @ wf  (shared B fragments)
//      d2ef[:, :Kw] = dfw2 @ wf^T                  (K = H in 4 quarters,
//                                                  summed in a fixed order)
//      d2wf partial += ef^T @ dfw2 + cef^T @ dfwr   (registers, all of the
//                                                  block's tiles)
//    The elementwise steps take one warp per slot (the gate sums dfo and
//    u; the vector part of the d2x row, the d2g row and the harmonic d2ef
//    columns as per-lane sums and a butterfly) or follow the mma fragments
//    (a, fo, dfw2, dfwr and the hidden part of the d2x row).  Each valid
//    slot writes two bf16 rows: [rnd(dfo r + u fw) | rnd(gms_v a[gate])]
//    at its position in the CSR list by source (plan["src_pos"]) and
//    [rnd(a[2ni + c]) | rnd(gv a[gate] + ef[ycol] a[ni + gate] + cxv
//    fo[gate] + fo[ni + gate] cef[ycol])] at its position in the list by
//    destination (plan["dst_pos"]).  Both are rounded to bf16 in the TPU
//    kernel, so the scratch loses nothing.
//  * message_bwd2_d2x_rows_kernel and message_bwd2_d2g_rows_kernel: one
//    warp per row sums its slots' scratch rows in list order (xeq_rows_sum
//    of message_tile.cuh, as message_bwd.cu's dx pass), writing each d2x /
//    d2g element once; nothing is recomputed.
//  * xeq_dwf_reduce_kernel (message_common.cuh): the d2wf partials summed
//    in block order.
// Wider shapes, as message_bwd.cu: instance WIDE (Kf > 32 or H > 768)
// runs fw and r over 32-row K slices and sends each slot's bf16 dfw2 and
// dfwr rows to xeq_dwf_pass for the d2wf partials; wf's fragments come
// from L2 where its live rows do not fit beside the stage (Kf = 128).  At
// H = 1152 the stage alone is 175 KB and the f32 dfo / u tiles 113 KB, so
// instance LEAN keeps neither dfo / u nor dfwr tiles: phase B forms each
// gate column's sums from the staged rows itself (the same products in the
// same order, so the same bits) and writes dfwr straight to its scratch
// (230 KB at H = 1152, Kf = 33; walk kernels at H = 1152, Kf = 128).
// The f32 operands without cwf at the widths of
// ops/fused_message.py::f32_route (the flagship's) take the f32 tile pass,
// message_bwd2_f32_kernel (message_f32_tile.cuh, its notes there; no TF32):
// message_bwd.cu's f32 pass with the second order's terms, cx and cef
// staged beside x and ef, d2x summed in registers along the list by
// source, and each valid slot's d2g row to an f32 scratch at its position
// by destination, summed by message_bwd2_d2g_rows_f32_kernel; then
// xeq_dwf_reduce_kernel.  On the flagship batch it replaced walk kernels
// that took 13.48 ms (slot pass 5.79, d2x walk 4.00, d2g walk 3.66; NVIDIA
// H100 80GB HBM3, 700 W; xequinet_torch/tools/bwd_compare.py --kernel
// message_bwd2 --dtype float32).
// The walk kernels take the other f32 widths, the operands with cwf (on
// no model path: tests and chip_smoke.py reach it) and any bf16 shape the
// tile pass cannot hold, the first version's four launches with or
// without the cwf terms (CWF); the filter's rows past 32 and the slot
// pass's column chunks as in message_bwd.cu:
//  * message_bwd2_dg_kernel: d2g, one thread per (destination row, output
//    column), walking the CSR list by destination as message_fwd.cu's f32
//    kernel does.
//  * message_bwd2_dx_kernel: d2x, one thread per (source row, x column),
//    walking the CSR list by source.  Each block stages its slots
//    (indices and the live columns of ef and cef, as f32).
//  * message_bwd2_slot_kernel: one block per (contiguous slot range,
//    column chunk), 16 slots per step, 512 threads: d2ef rows or their
//    chunk partials (one warp per slot, shuffle sums in fixed order) and
//    the block's d2wf partial in shared memory.
//  * xeq_dwf_reduce_kernel.
// These replace the TPU kernel's per-block d2g and window tiles and the
// overlap-add of the windows (:864-869).
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
// Rounding in bf16 mode mirrors _bwd2_kernel (:678, :703, :719-720, :724,
// :744-754): fo, a, the products summed into dfo and u, dfw2, dfwr, the
// harmonic terms of d2ef and the d2x and d2g rows are rounded to bf16;
// sums are f32.
//
// At the flagship's widths (ops/fused_message.py::hopper2_route) the bf16
// tile pass without cwf is the Hopper one of message_bwd2_hopper.cuh (a
// producer warp's bulk copies into a ring of stages, wgmma with H on M,
// packed single products), with the same scratch rows, row passes and
// reduction; the tile pass below takes the other bf16 widths.
#include "message_bwd2_hopper.cuh"
#include "message_f32_tile.cuh"

// r = c . w + (CWF) e . cw: the cotangent of the radial filter at hidden
// column col (the first rows from the registers w / cw, the rest from wf /
// cwf in 32-row slices, as xeq_filter_full).
template <typename T, bool CWF>
__device__ __forceinline__ float xeq_filter_cot(const float* e, const float* c,
                                                const float (&w)[XEQ_MAXK],
                                                const float (&cw)[XEQ_MAXK],
                                                const T* __restrict__ wf,
                                                const T* __restrict__ cwf, int hp, int col,
                                                int kw, int kf) {
  float r = xeq_filter_full(c, w, wf, hp, col, kw);
  if (CWF) r += xeq_filter_full(e, cw, cwf, hp, col, kf);
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
          const float fw1 = xeq_filter_full(e, w1, wf, hp, h1, kw);
          const float a1 = xeq_rnd<BF16>(
              xeq_ld(cr, h1) * fw1 +
              xeq_filter_cot<T, CWF>(e, c, w1, c1, wf, cwf, hp, h1, kw, kf) * gs1);
          if (h2 < 0) {
            v[u] = a1;
          } else {
            const float gs2 = xeq_ld(xr, h2);
            const float fw2 = xeq_filter_full(e, w2, wf, hp, h2, kw);
            const float a2 = xeq_rnd<BF16>(
                xeq_ld(cr, h2) * fw2 +
                xeq_filter_cot<T, CWF>(e, c, w2, c2, wf, cwf, hp, h2, kw, kf) * gs2);
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
          const float fw = xeq_filter_full(e, w, wf, hp, wcol, kw);
          const float r = xeq_filter_cot<T, CWF>(e, c, w, cw, wf, cwf, hp, wcol, kw, kf);
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

// One block per (contiguous slot range, column chunk of hc filter columns),
// as message_bwd.cu's slot pass: per 16 slots the chunk's dfw2 and dfwr
// columns, the chunk's d2wf partial, and the d2ef rows' partial sums over
// the chunk (whole rows with one chunk; else per-chunk partial rows f < kf
// in def_part, summed by xeq_def_reduce_kernel).  The lane sums of the
// harmonic d2ef columns come with chunk 0.
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
                         float* __restrict__ d2ef, float* __restrict__ def_part,
                         float* __restrict__ dwf_part,
                         int n_slots, int slots_per_block, int ni, int h_dim,
                         int hp, int dp, int sdp, int kw, int kf, int hc) {
  extern __shared__ float smem[];
  float* a2_s = smem;                        // [TS][ni]  a at the edge gates
  float* dfw2_s = a2_s + XEQ_TS2 * ni;       // [TS][hc]
  float* dfwr_s = dfw2_s + XEQ_TS2 * hc;     // [TS][hc]
  float* ef_s = dfwr_s + XEQ_TS2 * hc;       // [TS][Kf]
  float* cef_s = ef_s + XEQ_TS2 * kf;        // [TS][Kf]
  float* dwf_s = cef_s + XEQ_TS2 * kf;       // [Kf][hc]  this block's partial
  float* wf_s = dwf_s + kf * hc;             // [Kw][hc]  live rows of wf
  __shared__ int src_s[XEQ_TS2], dst_s[XEQ_TS2];

  const int xs = hp + dp;
  const int gs = sdp + dp;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_y = kf - kw;
  const int c0 = blockIdx.y * hc, hn = min(hc, h_dim - c0);  // the chunk's columns
  const bool first = blockIdx.y == 0, chunked = gridDim.y > 1;

  for (int i = tid; i < kf * hn; i += nthr) dwf_s[i] = 0.f;
  for (int i = tid; i < kw * hn; i += nthr) {
    const int f = i / hn, hh = i - f * hn;
    wf_s[i] = xeq_ld(wf, (int64_t)f * hp + c0 + hh);
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
    // A1 (chunk 0): a at the edge gates h = ni + u of each slot of the
    // step, XEQ_ILP items per thread at a time so their loads overlap
    for (int i0 = tid; first && i0 < XEQ_TS2 * ni; i0 += XEQ_ILP * nthr) {
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
            const float w = xeq_ld(wf, (int64_t)f * hp + h);
            fw += e[f] * w;
            r += cr[f] * w;
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
    // A2: dfw2 = rnd(dfo cxh + u gs) and dfwr = rnd(dfo gs) at the chunk's
    // hidden columns, XEQ_ILP items per thread at a time
    for (int i0 = tid; i0 < XEQ_TS2 * hn; i0 += XEQ_ILP * nthr) {
      float v2[XEQ_ILP], vr[XEQ_ILP];
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        v2[c] = 0.f;
        vr[c] = 0.f;
        if (i >= XEQ_TS2 * hn) continue;
        const int t = i / hn, h = c0 + i - t * hn;
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
        if (i < XEQ_TS2 * hn) {
          dfw2_s[i] = v2[c];
          dfwr_s[i] = vr[c];
        }
      }
    }
    __syncthreads();
    // A3: d2wf partial, element (f, h) owned by one thread, slots in order
    for (int i = tid; i < kf * hn; i += nthr) {
      const int f = i / hn, hh = i - f * hn;
      float acc = dwf_s[i];
#pragma unroll
      for (int t = 0; t < XEQ_TS2; ++t)
        acc += ef_s[t * kf + f] * dfw2_s[t * hn + hh] +
               cef_s[t * kf + f] * dfwr_s[t * hn + hh];
      dwf_s[i] = acc;
    }
    // B: d2ef rows (or their chunk partials), one warp per slot
    for (int t = warp; t < XEQ_TS2; t += nthr / 32) {
      const int k = base + t;
      if (k >= k1) continue;
      float* row = chunked ? def_part + ((int64_t)blockIdx.y * n_slots + k) * kf
                           : d2ef + (int64_t)k * XEQ_FPACK;
      const int width = chunked ? kf : XEQ_FPACK;
      if (dst_s[t] < 0) {
        for (int f = lane; f < width; f += 32) row[f] = 0.f;
        continue;
      }
      const float* p2 = dfw2_s + t * hn;
      const float* pr = dfwr_s + t * hn;
      for (int f = 0; f < kw; ++f) {
        float acc = 0.f;
        for (int hh = lane; hh < hn; hh += 32) {
          acc += p2[hh] * wf_s[f * hn + hh];
          if (CWF) acc += pr[hh] * xeq_ld(cwf, (int64_t)f * hp + c0 + hh);
        }
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) row[f] = acc;
      }
      const T* gr = g + (int64_t)dst_s[t] * gs;
      for (int y = 0; y < n_y; ++y) {
        float acc = 0.f;
        for (int q = ylane_ptr[y] + lane; first && q < ylane_ptr[y + 1]; q += 32) {
          const int j = ylane_idx[q];
          acc += xeq_rnd<BF16>(xeq_ld(gr, sdp + j) * a2_s[t * ni + lane_gate[j]]);
        }
        if (CWF) {
          for (int hh = lane; hh < hn; hh += 32)
            acc += pr[hh] * xeq_ld(cwf, (int64_t)(kw + y) * hp + c0 + hh);
        }
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) row[kw + y] = acc;
      }
      for (int f = kf + lane; f < width; f += 32) row[f] = 0.f;
    }
    __syncthreads();
  }
  float* part = dwf_part + (int64_t)blockIdx.x * kf * h_dim;
  for (int i = tid; i < kf * hn; i += nthr) {
    const int f = i / hn, hh = i - f * hn;
    part[(int64_t)f * h_dim + c0 + hh] = dwf_s[i];
  }
}

// Shared memory of the walk kernels' slot pass at column chunk hc.
static size_t bwd2_slot_smem(int ni, int hc, int kw, int kf) {
  return sizeof(float) * ((size_t)XEQ_TS2 * ni + 2 * (size_t)XEQ_TS2 * hc +
                          2 * (size_t)XEQ_TS2 * kf + (size_t)kf * hc + (size_t)kw * hc);
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
                       const void* ylane_idx, void* def_part, void* d2x, void* d2ef,
                       void* dwf_part, void* d2wf, void* d2g, int n_out,
                       int n_rows, int n_slots, int n_part, int ni, int nd,
                       int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                       int n_hc, cudaStream_t s) {
  if (n_hc != xeq_walk_chunks(bwd2_slot_smem(ni, h_dim, kw, kf), h_dim) ||
      (n_hc > 1 && def_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int hc = n_hc == 1 ? h_dim : XEQ_WALK_HC;
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
  const size_t smem = bwd2_slot_smem(ni, hc, kw, kf);
  cudaError_t err = cudaFuncSetAttribute(
      message_bwd2_slot_kernel<T, BF16, CWF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = ((n_slots + n_part - 1) / n_part + XEQ_TS2 - 1) / XEQ_TS2 * XEQ_TS2;
  message_bwd2_slot_kernel<T, BF16, CWF><<<dim3(n_part, n_hc), XEQ_SLOT2_THREADS, smem, s>>>(
      (const T*)x, (const T*)ef, (const T*)wf, (const T*)g, (const T*)cx,
      (const T*)cef, (const T*)cwf, (const int*)slot_src, (const int*)slot_dst,
      (const int*)lane_gate, (const int*)lane_ycol, (const int*)gate_lane0,
      (const int*)gate_dim, (const int*)ylane_ptr, (const int*)ylane_idx,
      (float*)d2ef, (float*)def_part, (float*)dwf_part, n_slots, per, ni, h_dim, hp, dp,
      sdp, kw, kf, hc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_hc > 1 && n_slots > 0) {
    const int64_t n = (int64_t)n_slots * XEQ_FPACK;
    xeq_def_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        (const float*)def_part, (float*)d2ef, n_hc, n_slots, kf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)d2wf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 instance without cwf: the slot-tile pass on the tensor cores and the
// row passes by source and by destination
// ---------------------------------------------------------------------------
// Sizes and shared-memory offsets (bytes) of the tile pass, from the host.
struct XeqTile2Dims {
  int n_slots, ni, h, hp, d, dp, sdp, kw, kf, nd;
  int hs;      // H rounded up to 16: the N of fw and r, the K of d2ef
  int ht8;     // H rounded up to 8
  int dt8;     // D rounded up to 8
  int sd8;     // node_dim rounded up to 8
  int rsx;     // d2x scratch row: ht8 + dt8
  int rsg;     // d2g scratch row: sd8 + dt8
  int xs_st;   // staged x and cx rows: [h part (ht8) | vector part (dt8)] + 8
  int gs_st;   // staged g row: [gms_s (sd8) | gms_v (dt8)] + 8
  int w_st;    // wf_s, dfw2_s, dfwr_s rows: hs rounded up to 64, + 8
  int dfo_st;  // dfo_s and u_s rows (f32): 2 ni + 8
  int off_cx, off_g, off_e, off_ce, off_pos, stage;  // the stage (one)
  int off_dfw2, off_dfwr, off_dfo, off_u, off_tab, smem;  // wf_s at ``stage``
};

// The launcher's view: the layout choices, which select the kernel's
// instance and so need not reach it.  (A kernel parameter block 24 bytes
// larger made the flagship instance's tile loop reload shared-memory
// offsets from the constant bank, 4-5% slower on the H100.)
struct XeqTile2Layout : XeqTile2Dims {
  int est;       // staged edge-feature row stride (bf16): Kf rounded up to 32, + 8
  int kwp;       // rows of wf in the K slices of fw and r, columns of d2ef
  int wf_smem;   // wf's live rows copied to shared memory, else read from L2
  int lean;      // no dfo / u / dfwr tiles (the kernel's LEAN instance)
  int dwf_regs;  // the d2wf partial in registers (Kf <= 32, H <= 768, not lean),
                 // else dfw2 / dfwr rows to scratch and xeq_dwf_pass
};

// Issue the cp.async copies of one tile (slots k0 .. k0+XEQ_BT-1, one warp
// per slot, its indices in ``ix``): each slot's x and cx rows (H and D
// columns), g row (node_dim and D columns), and the staged columns of ef and
// cef, zero-filled for slots that add nothing; and its scratch rows by
// source and by destination (-1 for slots that add nothing).
__device__ __forceinline__ void xeq_tile2_load(unsigned char* st, int est, int k0, XeqSlotIdx ix,
                                               const XeqTile2Dims& p,
                                               const xeq_bf16* __restrict__ x,
                                               const xeq_bf16* __restrict__ cx,
                                               const xeq_bf16* __restrict__ g,
                                               const xeq_bf16* __restrict__ ef,
                                               const xeq_bf16* __restrict__ cef) {
  const int t = threadIdx.x >> 5;
  const bool ok = ix.dst >= 0;
  const int64_t xr = (int64_t)(ok ? ix.src : 0) * (p.hp + p.dp);
  const int64_t er = (int64_t)(ok ? k0 + t : 0) * XEQ_FPACK;
  const XeqSeg sg[5] = {
      {(xeq_bf16*)st + t * p.xs_st, x + xr, p.ht8, p.hp, p.rsx >> 3},
      {(xeq_bf16*)(st + p.off_cx) + t * p.xs_st, cx + xr, p.ht8, p.hp, p.rsx >> 3},
      {(xeq_bf16*)(st + p.off_g) + t * p.gs_st, g + (int64_t)(ok ? ix.dst : 0) * (p.sdp + p.dp),
       p.sd8, p.sdp, p.rsg >> 3},
      {(xeq_bf16*)(st + p.off_e) + t * est, ef + er, est - 8, 0, (est - 8) / 8},
      {(xeq_bf16*)(st + p.off_ce) + t * est, cef + er, est - 8, 0, (est - 8) / 8}};
  xeq_stage_segs(sg, ok);
  if ((threadIdx.x & 31) == 0) {
    int* pos = (int*)(st + p.off_pos);
    pos[t] = ok ? ix.pos : -1;
    pos[XEQ_BT + t] = ok ? ix.pos2 : -1;
  }
}

// The lean tile pass's gate sums of dfo and u at hidden column h < 2 ni of
// one slot, as phase A forms them: the products of the irrep's lanes (xv,
// cv: the staged gv and cxv rows; state gate) or of their harmonic columns
// (er, cr: the staged ef and cef rows from column Kw; harmonic gate) with
// gv (the staged gms_v row), in lane order.
__device__ __forceinline__ void xeq_gate_sums2(float& sd, float& su, int h, const xeq_bf16* xv,
                                               const xeq_bf16* cv, const xeq_bf16* gv,
                                               const xeq_bf16* er, const xeq_bf16* cr,
                                               const int* gate_tab, const int* lane_tab, int ni) {
  const bool state = h < ni;
  const int tab = gate_tab[state ? h : h - ni], l0 = tab & 0xffff, m1 = tab >> 16;
  sd = su = 0.f;
#pragma unroll
  for (int m = 0; m < XEQ_MAXM; ++m) {
    if (m < m1) {
      const int j = l0 + m;
      const float gm = xeq_f(gv[j]);
      if (state) {
        sd += xeq_rnd<true>(xeq_f(xv[j]) * gm);
        su += xeq_rnd<true>(xeq_f(cv[j]) * gm);
      } else {
        const int y = lane_tab[j] >> 16;
        sd += xeq_rnd<true>(xeq_f(er[y]) * gm);
        su += xeq_rnd<true>(xeq_f(cr[y]) * gm);
      }
    }
  }
}

// WF_SMEM: wf's live rows copied to shared memory, else read from L2.
// WIDE: Kf > 32 or H > 768 (or LEAN), so fw and r run over 32-row K slices
// and each slot's dfw2 and dfwr rows go to the d2wf pass instead of a
// partial in registers (compiled only where needed: the other instance
// keeps the flagship's registers).  LEAN (widths whose dfo / u tiles do not
// fit beside the stage, H = 1152): no phase A; phase B forms each gate
// column's sums itself from the staged rows, in the same order, and writes
// dfwr straight to its scratch.
//
// STAMP: the phase probe's instance (message_bwd2_tile_stamped_kernel,
// launched by xeq_bwd2_phases only): thread 0 adds the clock64() cycles of
// each phase of its block, written to stamps[block][XEQ_STAMPS] (prologue
// and epilogue, the wait for a tile and its barrier, A, B, C, D1, D2 with
// the next tile's copies, E).  A kernel of its own, so that the other
// instances keep their parameter block.
#define XEQ_TILE2_PARAMS                                                                      \
  const xeq_bf16 *__restrict__ x, const xeq_bf16 *__restrict__ ef,                          \
      const xeq_bf16 *__restrict__ wf, const xeq_bf16 *__restrict__ g,                      \
      const xeq_bf16 *__restrict__ cx, const xeq_bf16 *__restrict__ cef,                    \
      const int *__restrict__ slot_src, const int *__restrict__ slot_dst,                   \
      const int *__restrict__ src_pos, const int *__restrict__ dst_pos,                     \
      const int *__restrict__ lane_gate, const int *__restrict__ lane_ycol,                 \
      const int *__restrict__ gate_lane0, const int *__restrict__ gate_dim,                 \
      xeq_bf16 *__restrict__ rows_x, xeq_bf16 *__restrict__ rows_g,                         \
      xeq_bf16 *__restrict__ dfw2_rows, xeq_bf16 *__restrict__ dfwr_rows,                   \
      float *__restrict__ d2ef, float *__restrict__ dwf_part, const XeqTile2Dims p
#define XEQ_TILE2_ARGS                                                                        \
  x, ef, wf, g, cx, cef, slot_src, slot_dst, src_pos, dst_pos, lane_gate, lane_ycol,         \
      gate_lane0, gate_dim, rows_x, rows_g, dfw2_rows, dfwr_rows, d2ef, dwf_part, p

template <bool WF_SMEM, bool WIDE, bool LEAN, bool STAMP>
__device__ __forceinline__ void xeq_tile2_body(XEQ_TILE2_PARAMS, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  XeqStamps<STAMP> sp;
  xeq_bf16* x_s = (xeq_bf16*)tile_smem;                // [BT][xs_st] gs|gv; fo at the gates
  xeq_bf16* cx_s = (xeq_bf16*)(tile_smem + p.off_cx);  // [BT][xs_st] cxh|cxv; a in cxh
  const xeq_bf16* g_s = (const xeq_bf16*)(tile_smem + p.off_g);  // [BT][gs_st] gms_s|gms_v
  const xeq_bf16* e_s = (const xeq_bf16*)(tile_smem + p.off_e);  // [BT][EST]
  const xeq_bf16* ce_s = (const xeq_bf16*)(tile_smem + p.off_ce);
  const int* pos_s = (const int*)(tile_smem + p.off_pos);  // [BT] by source, [BT] by destination
  xeq_bf16* wf_s = (xeq_bf16*)(tile_smem + p.stage);         // [kwp][w_st] live rows of wf
  xeq_bf16* dfw2_s = (xeq_bf16*)(tile_smem + p.off_dfw2);    // [BT][w_st]
  xeq_bf16* dfwr_s = (xeq_bf16*)(tile_smem + p.off_dfwr);    // [BT][w_st]
  float* dfo_s = (float*)(tile_smem + p.off_dfo);  // [BT][dfo_st]; then the d2ef quarters
  float* u_s = (float*)(tile_smem + p.off_u);      // [BT][dfo_st]
  int* lane_tab = (int*)(tile_smem + p.off_tab);   // [dt8]: gate | harmonic col << 16
  int* gate_tab = lane_tab + p.dt8;                // [ni]: first lane | lanes << 16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;  // mma fragment: row group, column pair
  const int ni2 = 2 * p.ni, n8 = p.hs >> 3, n_y = p.kf - p.kw;
  // not WIDE (Kf <= 32): the staged edge-feature stride and K width as
  // constants
  const int est = WIDE ? xeq_round_up(p.kf, XEQ_BT_KE) + 8 : XEQ_BT_KE + 8;
  const int kwp = WIDE ? xeq_round_up(p.kw, XEQ_BT_KE) : XEQ_BT_KE;
  const int n_tiles = (p.n_slots + XEQ_BT - 1) / XEQ_BT;

  if (WF_SMEM) xeq_load_wf(wf_s, p.w_st, wf, p.kw, p.h, p.hp, p.hs, kwp, XEQ_BT_THREADS);
  const xeq_bf16* wfp = WF_SMEM ? wf_s : wf;
  const int wst = WF_SMEM ? p.w_st : p.hp;
  for (int j = tid; j < p.dt8; j += XEQ_BT_THREADS)
    lane_tab[j] = j < p.d ? __ldg(lane_gate + j) | ((__ldg(lane_ycol + j) - p.kw) << 16) : 0;
  for (int u = tid; u < p.ni; u += XEQ_BT_THREADS)
    gate_tab[u] = __ldg(gate_lane0 + u) | (__ldg(gate_dim + u) << 16);
  float acc[WIDE ? 1 : XEQ_BT_NTW][2][4];
#pragma unroll
  for (int i = 0; i < (WIDE ? 1 : XEQ_BT_NTW); ++i)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][m][q] = 0.f;

  // one stage: the next tile's copies are issued once this tile's rows
  // have been read (before phase E); its slot indices a tile earlier
  const int grid = gridDim.x;
  if ((int)blockIdx.x < n_tiles)
    xeq_tile2_load(tile_smem, est, blockIdx.x * XEQ_BT,
                   xeq_slot_idx(blockIdx.x, n_tiles, p.n_slots, slot_src, slot_dst, src_pos,
                                dst_pos),
                   p, x, cx, g, ef, cef);
  xeq_cp_commit();
  XeqSlotIdx ahead = xeq_slot_idx(blockIdx.x + grid, n_tiles, p.n_slots, slot_src, slot_dst,
                                  src_pos, dst_pos);
  sp.mark(0);
  for (int tl = blockIdx.x; tl < n_tiles; tl += grid) {
    xeq_cp_wait_all();
    __syncthreads();  // this tile has landed
    sp.mark(1);
    const int k_w = tl * XEQ_BT + warp;  // the slot of this warp in phases A, C, E

    // A: the gate sums of dfo and u, one warp per slot, a lane per irrep
    if constexpr (!LEAN) {
      const xeq_bf16* xv = x_s + warp * p.xs_st + p.ht8;
      const xeq_bf16* cv = cx_s + warp * p.xs_st + p.ht8;
      const xeq_bf16* gv = g_s + warp * p.gs_st + p.sd8;
      const xeq_bf16* er = e_s + warp * est + p.kw;
      const xeq_bf16* cr = ce_s + warp * est + p.kw;
      float* dr = dfo_s + warp * p.dfo_st;
      float* ur = u_s + warp * p.dfo_st;
      for (int u = lane; u < p.ni; u += 32) {
        const int tab = gate_tab[u], l0 = tab & 0xffff, m1 = tab >> 16;
        float sv = 0.f, sr = 0.f, tv = 0.f, tr = 0.f;
#pragma unroll
        for (int m = 0; m < XEQ_MAXM; ++m) {
          if (m < m1) {
            const int j = l0 + m, y = lane_tab[j] >> 16;
            const float gm = xeq_f(gv[j]);
            sv += xeq_rnd<true>(xeq_f(xv[j]) * gm);
            sr += xeq_rnd<true>(xeq_f(er[y]) * gm);
            tv += xeq_rnd<true>(xeq_f(cv[j]) * gm);
            tr += xeq_rnd<true>(xeq_f(cr[y]) * gm);
          }
        }
        dr[u] = sv;
        dr[p.ni + u] = sr;
        ur[u] = tv;
        ur[p.ni + u] = tr;
      }
    }
    sp.mark(2);
    __syncthreads();

    // B: fw = ef @ wf and r = cef @ wf on the tensor cores (shared B
    // fragments; K in 32-row slices of wf, the first slice's A fragments
    // held), one n8 column tile per warp at a time; per element a (in place
    // of cxh), fo at the gate columns (in place of gs), dfw2 and dfwr (to
    // shared memory) and the hidden part of the d2x row
    {
      uint32_t ae[2][4], ac[2][4];
      xeq_frag_a(ae, e_s, est);
      xeq_frag_a(ac, ce_s, est);
      for (int nt = warp; nt < n8; nt += XEQ_BT_WARPS) {
        const int n = nt * 8 + gq;
        float cf[4] = {0.f, 0.f, 0.f, 0.f}, cr[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t b0, b1;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          xeq_wf_b(b0, b1, wfp, wst, ks * 16, n);
          xeq_mma(cf, ae[ks], b0, b1);
          xeq_mma(cr, ac[ks], b0, b1);
        }
        if constexpr (WIDE) {
          for (int k0 = XEQ_BT_KE; k0 < kwp; k0 += XEQ_BT_KE) {
            uint32_t a2e[2][4], a2c[2][4];
            xeq_frag_a(a2e, e_s + k0, est);
            xeq_frag_a(a2c, ce_s + k0, est);
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              xeq_wf_b(b0, b1, wfp, wst, k0 + ks * 16, n);
              xeq_mma(cf, a2e[ks], b0, b1);
              xeq_mma(cr, a2c[ks], b0, b1);
            }
          }
        }
        const int h0 = nt * 8 + 2 * cq;  // even, as 2 ni is: a pair lies on
                                         // one side of the gate columns
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = gq + 8 * half;
          float2 w2 = make_float2(0.f, 0.f), wr = w2, dx = w2;
          if (h0 < p.h) {
            xeq_bf16* xr = x_s + t * p.xs_st + h0;
            xeq_bf16* cxr = cx_s + t * p.xs_st + h0;
            const float2 fw = make_float2(cf[2 * half], cf[2 * half + 1]);
            const float2 r = make_float2(cr[2 * half], cr[2 * half + 1]);
            const float2 gs = xeq_f2(xr), cxh = xeq_f2(cxr);
            float2 dfo, uu = make_float2(0.f, 0.f);
            if constexpr (LEAN) {  // h0 even, 2 ni even: h0 + 1 < 2 ni
              if (h0 < ni2) {
                xeq_gate_sums2(dfo.x, uu.x, h0, x_s + t * p.xs_st + p.ht8,
                               cx_s + t * p.xs_st + p.ht8, g_s + t * p.gs_st + p.sd8,
                               e_s + t * est + p.kw, ce_s + t * est + p.kw, gate_tab,
                               lane_tab, p.ni);
                xeq_gate_sums2(dfo.y, uu.y, h0 + 1, x_s + t * p.xs_st + p.ht8,
                               cx_s + t * p.xs_st + p.ht8, g_s + t * p.gs_st + p.sd8,
                               e_s + t * est + p.kw, ce_s + t * est + p.kw, gate_tab,
                               lane_tab, p.ni);
              } else {
                dfo = xeq_f2(g_s + t * p.gs_st + h0 - ni2);
              }
            } else {
              if (h0 < ni2) {
                dfo = *reinterpret_cast<const float2*>(dfo_s + t * p.dfo_st + h0);
                uu = *reinterpret_cast<const float2*>(u_s + t * p.dfo_st + h0);
              } else {
                dfo = xeq_f2(g_s + t * p.gs_st + h0 - ni2);
              }
            }
            float2 a = make_float2(cxh.x * fw.x + r.x * gs.x, cxh.y * fw.y + r.y * gs.y);
            w2 = make_float2(dfo.x * cxh.x + uu.x * gs.x, dfo.y * cxh.y + uu.y * gs.y);
            wr = make_float2(dfo.x * gs.x, dfo.y * gs.y);
            dx = make_float2(dfo.x * r.x + uu.x * fw.x, dfo.y * r.y + uu.y * fw.y);
            if (h0 + 1 >= p.h) a.y = w2.y = wr.y = dx.y = 0.f;  // odd H: column H is padding
            xeq_st2(cxr, a.x, a.y);
            if (h0 < ni2) xeq_st2(xr, gs.x * fw.x, gs.y * fw.y);
          }
          xeq_st2(dfw2_s + t * p.w_st + h0, w2.x, w2.y);
          if constexpr (LEAN)
            xeq_st2(dfwr_rows + (int64_t)(tl * XEQ_BT + t) * p.hs + h0, wr.x, wr.y);
          else
            xeq_st2(dfwr_s + t * p.w_st + h0, wr.x, wr.y);
          const int pos = pos_s[t];
          if (pos >= 0 && h0 < p.ht8) xeq_st2(rows_x + (int64_t)pos * p.rsx + h0, dx.x, dx.y);
        }
      }
    }
    __syncthreads();
    sp.mark(3);

    // C: one warp per slot, lane pairs: the vector part of the d2x row, the
    // d2g row, and the harmonic d2ef columns (per lane in lane order, then
    // a butterfly over the warp)
    {
      const xeq_bf16* xr = x_s + warp * p.xs_st;   // fo at the gates | gv
      const xeq_bf16* cr = cx_s + warp * p.xs_st;  // a | cxv
      const xeq_bf16* gm_r = g_s + warp * p.gs_st + p.sd8;
      const xeq_bf16* er = e_s + warp * est + p.kw;
      const xeq_bf16* cer = ce_s + warp * est + p.kw;
      const int px = pos_s[warp], pg = pos_s[XEQ_BT + warp];
      float hy[XEQ_MAXY];
#pragma unroll
      for (int y = 0; y < XEQ_MAXY; ++y) hy[y] = 0.f;
      for (int j0 = 2 * lane; j0 < p.dt8; j0 += 64) {
        float vx[2] = {0.f, 0.f}, vg[2] = {0.f, 0.f};
        const float2 gm = xeq_f2(gm_r + j0), gv = xeq_f2(xr + p.ht8 + j0);
        const float2 cv = xeq_f2(cr + p.ht8 + j0);
        const int2 tab = *reinterpret_cast<const int2*>(lane_tab + j0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (j0 + q < p.d) {
            const int tq = q ? tab.y : tab.x, u = tq & 0xffff, y = tq >> 16;
            const float gmq = q ? gm.y : gm.x, gvq = q ? gv.y : gv.x, cvq = q ? cv.y : cv.x;
            const float au = xeq_f(cr[u]), anu = xeq_f(cr[p.ni + u]);
            const float fu = xeq_f(xr[u]), fnu = xeq_f(xr[p.ni + u]);
            vx[q] = gmq * au;
            vg[q] = gvq * au + xeq_f(er[y]) * anu + cvq * fu + fnu * xeq_f(cer[y]);
            const float hr = xeq_rnd<true>(gmq * anu);
#pragma unroll
            for (int yy = 0; yy < XEQ_MAXY; ++yy) hy[yy] += yy == y ? hr : 0.f;
          }
        }
        if (px >= 0) xeq_st2(rows_x + (int64_t)px * p.rsx + p.ht8 + j0, vx[0], vx[1]);
        if (pg >= 0) xeq_st2(rows_g + (int64_t)pg * p.rsg + p.sd8 + j0, vg[0], vg[1]);
      }
      if (pg >= 0) {
        for (int c0 = 2 * lane; c0 < p.sd8; c0 += 64) {
          float2 v = make_float2(0.f, 0.f);
          if (c0 < p.nd) v = xeq_f2(cr + ni2 + c0);
          if (c0 + 1 >= p.nd) v.y = 0.f;
          xeq_st2(rows_g + (int64_t)pg * p.rsg + c0, v.x, v.y);
        }
      }
      const float mine = xeq_harmonic_sums(hy);
      if (k_w < p.n_slots && lane < n_y) d2ef[(int64_t)k_w * XEQ_FPACK + p.kw + lane] = mine;
      // the slot's dfw2 and dfwr rows, for the d2wf pass (every slot of the
      // tile: zero where it adds nothing)
      if constexpr (WIDE) {
        xeq_copy_row(dfw2_rows + (int64_t)k_w * p.hs, dfw2_s + warp * p.w_st, p.hs >> 3);
        if constexpr (!LEAN)
          xeq_copy_row(dfwr_rows + (int64_t)k_w * p.hs, dfwr_s + warp * p.w_st, p.hs >> 3);
      }
    }
    sp.mark(4);

    // D1: d2ef[:, f < kwp] = dfw2 @ wf^T on the tensor cores; warp w takes
    // the column tiles w % 4 (+ 4 j) and K quarter w / 4, its partials to
    // shared memory
    xeq_def_quarters(dfw2_s, p.w_st, wfp, wst, p.hs, kwp, dfo_s);
    sp.mark(5);
    // D2: the block's d2wf partial += ef^T @ dfw2 + cef^T @ dfwr on the
    // tensor cores, in the warp's own column tiles (rows f of two m16 tiles)
    if constexpr (!WIDE) {
      uint32_t ae[2][4], ac[2][4];
      xeq_frag_at(ae, e_s, est);
      xeq_frag_at(ac, ce_s, est);
#pragma unroll
      for (int i = 0; i < XEQ_BT_NTW; ++i) {
        const int nt = warp + i * XEQ_BT_WARPS;
        if (nt < n8) {
          const xeq_bf16* d0 = dfw2_s + 2 * cq * p.w_st + nt * 8 + gq;
          const xeq_bf16* d1 = dfwr_s + 2 * cq * p.w_st + nt * 8 + gq;
          uint32_t b0 = xeq_pack(d0[0], d0[p.w_st]);
          uint32_t b1 = xeq_pack(d0[8 * p.w_st], d0[9 * p.w_st]);
          xeq_mma(acc[i][0], ae[0], b0, b1);
          xeq_mma(acc[i][1], ae[1], b0, b1);
          b0 = xeq_pack(d1[0], d1[p.w_st]);
          b1 = xeq_pack(d1[8 * p.w_st], d1[9 * p.w_st]);
          xeq_mma(acc[i][0], ac[0], b0, b1);
          xeq_mma(acc[i][1], ac[1], b0, b1);
        }
      }
    }
    __syncthreads();  // the stage is read: the next tile's copies may land

    if (tl + grid < n_tiles)
      xeq_tile2_load(tile_smem, est, (tl + grid) * XEQ_BT, ahead, p, x, cx, g, ef, cef);
    xeq_cp_commit();
    ahead = xeq_slot_idx(tl + 2 * grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos,
                         dst_pos);
    sp.mark(6);

    // E: the filter columns of the warp's d2ef row (the four quarters in
    // order) and zeros past Kf; dfo_s is rewritten only after the next
    // tile's first barrier
    if (k_w < p.n_slots)
      xeq_def_row(dfo_s, warp, d2ef + (int64_t)k_w * XEQ_FPACK, p.kw, p.kf, kwp);
    sp.mark(7);
  }

  if constexpr (!WIDE)
    xeq_dwf_part_write(acc, dwf_part + (int64_t)blockIdx.x * p.kf * p.h, p.kf, p.h, n8);
  sp.mark(0);
  if (STAMP && threadIdx.x == 0) sp.write(stamps + (int64_t)blockIdx.x * XEQ_STAMPS);
}

template <bool WF_SMEM, bool WIDE, bool LEAN>
__global__ void __launch_bounds__(XEQ_BT_THREADS, 1)
message_bwd2_tile_kernel(XEQ_TILE2_PARAMS) {
  xeq_tile2_body<WF_SMEM, WIDE, LEAN, false>(XEQ_TILE2_ARGS, nullptr);
}

// The flagship instance (wf's live rows in shared memory, d2wf in
// registers) with the phase stamps.
__global__ void __launch_bounds__(XEQ_BT_THREADS, 1)
message_bwd2_tile_stamped_kernel(XEQ_TILE2_PARAMS, long long* __restrict__ stamps) {
  xeq_tile2_body<true, false, false, true>(XEQ_TILE2_ARGS, stamps);
}

// d2x [n_rows, Hp+Dp] f32: the d2x scratch rows summed by source.
__global__ void __launch_bounds__(256)
message_bwd2_d2x_rows_kernel(const xeq_bf16* __restrict__ rows, const int* __restrict__ src_ptr,
                             float* __restrict__ d2x, int n_rows, int ht8, int dt8, int hp,
                             int xw) {
  xeq_rows_sum(rows, src_ptr, d2x, n_rows, ht8, dt8, hp, xw);
}

// d2g [n_out, SDp+Dp] f32: the d2g scratch rows summed by destination.
__global__ void __launch_bounds__(256)
message_bwd2_d2g_rows_kernel(const xeq_bf16* __restrict__ rows, const int* __restrict__ dst_ptr,
                             float* __restrict__ d2g, int n_out, int sd8, int dt8, int sdp,
                             int gw) {
  xeq_rows_sum(rows, dst_ptr, d2g, n_out, sd8, dt8, sdp, gw);
}

// The tile pass's shared-memory layout (one stage): wf's live rows in
// shared memory where they fit beside it, else wf from L2, else the lean
// layout (no dfo / u / dfwr tiles); false when none fits
// (ops/fused_message.py::_tile_layouts states the most compact).
static bool bwd2_tile_dims(XeqTile2Layout& p, int n_slots, int ni, int nd, int h_dim, int hp,
                           int d, int dp, int sdp, int kw, int kf) {
  p.n_slots = n_slots; p.ni = ni; p.h = h_dim; p.hp = hp; p.d = d; p.dp = dp;
  p.sdp = sdp; p.kw = kw; p.kf = kf; p.nd = nd;
  p.hs = xeq_round_up(h_dim, 16);
  p.ht8 = xeq_round_up(h_dim, 8);
  p.dt8 = xeq_round_up(d, 8);
  p.sd8 = xeq_round_up(nd, 8);
  p.rsx = p.ht8 + p.dt8;
  p.rsg = p.sd8 + p.dt8;
  p.xs_st = p.rsx + 8;
  p.gs_st = p.rsg + 8;
  p.w_st = xeq_round_up(p.hs, 64) + 8;
  p.dfo_st = 2 * ni + 8;
  p.est = xeq_round_up(kf, XEQ_BT_KE) + 8;
  p.kwp = xeq_round_up(kw, XEQ_BT_KE);
  p.off_cx = XEQ_BT * p.xs_st * 2;
  p.off_g = p.off_cx + XEQ_BT * p.xs_st * 2;
  p.off_e = p.off_g + XEQ_BT * p.gs_st * 2;
  p.off_ce = p.off_e + XEQ_BT * p.est * 2;
  p.off_pos = p.off_ce + XEQ_BT * p.est * 2;
  p.stage = xeq_round_up(p.off_pos + 2 * XEQ_BT * 4, 16);
  const int wf_bytes = p.kwp * p.w_st * 2, tile_bytes = XEQ_BT * p.w_st * 2;
  const int dfo_bytes = 2 * XEQ_BT * p.dfo_st * 4, red_bytes = 4 * XEQ_BT * p.kwp * 4;
  const int tabs = xeq_round_up((p.dt8 + ni) * 4, 16);
  const int full = 2 * tile_bytes + (dfo_bytes > red_bytes ? dfo_bytes : red_bytes) + tabs;
  p.wf_smem = p.stage + wf_bytes + full <= XEQ_SMEM_MAX;
  p.lean = !p.wf_smem && p.stage + full > XEQ_SMEM_MAX;
  p.dwf_regs = !p.lean && kf <= XEQ_BT_KE && p.hs <= 16 * 8 * XEQ_BT_NTW;
  p.off_dfw2 = p.stage + (p.wf_smem ? wf_bytes : 0);
  p.off_dfwr = p.off_dfw2 + tile_bytes;
  p.off_dfo = p.off_dfwr + (p.lean ? 0 : tile_bytes);
  p.off_u = p.off_dfo + XEQ_BT * p.dfo_st * 4;
  p.off_tab = p.off_dfo + (p.lean ? red_bytes : (dfo_bytes > red_bytes ? dfo_bytes : red_bytes));
  p.smem = p.off_tab + tabs;
  return kf - kw <= XEQ_MAXY && d < 65536 && p.ht8 <= hp && p.dt8 <= dp && p.sd8 <= sdp &&
         p.smem <= XEQ_SMEM_MAX;
}

static int launch_bwd2_tiles(const void* x, const void* ef, const void* wf, const void* g,
                             const void* cx, const void* cef, const void* dst_ptr,
                             const void* src_ptr, const void* slot_src, const void* slot_dst,
                             const void* src_pos, const void* dst_pos, const void* lane_gate,
                             const void* lane_ycol, const void* gate_lane0,
                             const void* gate_dim, void* rows_x, void* rows_g, void* dfw2_rows,
                             void* dfwr_rows, void* d2x, void* d2ef, void* dwf_part, void* d2wf,
                             void* d2g, int n_out, int n_rows, int n_slots, int n_part, int ni,
                             int nd, int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                             cudaStream_t s) {
  XeqTile2Layout p;
  if (!bwd2_tile_dims(p, n_slots, ni, nd, h_dim, hp, d, dp, sdp, kw, kf) ||
      (!p.dwf_regs && (dfw2_rows == nullptr || dfwr_rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto kernel = p.lean       ? message_bwd2_tile_kernel<false, true, true>
                : p.wf_smem  ? (p.dwf_regs ? message_bwd2_tile_kernel<true, false, false>
                                           : message_bwd2_tile_kernel<true, true, false>)
                : p.dwf_regs ? message_bwd2_tile_kernel<false, false, false>
                             : message_bwd2_tile_kernel<false, true, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, XEQ_BT_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const xeq_bf16*)cx, (const xeq_bf16*)cef, (const int*)slot_src, (const int*)slot_dst,
      (const int*)src_pos, (const int*)dst_pos, (const int*)lane_gate, (const int*)lane_ycol,
      (const int*)gate_lane0, (const int*)gate_dim, (xeq_bf16*)rows_x, (xeq_bf16*)rows_g,
      (xeq_bf16*)dfw2_rows, (xeq_bf16*)dfwr_rows, (float*)d2ef, (float*)dwf_part,
      static_cast<const XeqTile2Dims&>(p));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    message_bwd2_d2x_rows_kernel<<<(n_rows + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows_x, (const int*)src_ptr, (float*)d2x, n_rows, p.ht8, p.dt8, hp,
        hp + dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_out > 0) {
    message_bwd2_d2g_rows_kernel<<<(n_out + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows_g, (const int*)dst_ptr, (float*)d2g, n_out, p.sd8, p.dt8, sdp,
        sdp + dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!p.dwf_regs)
    return xeq_dwf_pass((const xeq_bf16*)ef, (const xeq_bf16*)dfw2_rows, (const xeq_bf16*)cef,
                        (const xeq_bf16*)dfwr_rows, (float*)dwf_part, (float*)d2wf,
                        n_slots, n_part, p.hs, kf, h_dim, hp, s);
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)d2wf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

#define XEQ_BWD2_ARGS                                                          \
  x, ef, wf, g, cx, cef, cwf, dst_ptr, dst_slots, src_ptr, src_slots,          \
      slot_src, slot_dst, lane_gate, lane_ycol, gate_lane0, gate_dim,          \
      ylane_ptr, ylane_idx, def_part, d2x, d2ef, dwf_part, d2wf, d2g, n_out,   \
      n_rows, n_slots, n_part, ni, nd, h_dim, hp, d, dp, sdp, kw, kf, n_hc, s

// The Hopper tile pass (message_bwd2_hopper.cuh), the row passes and the
// d2wf reduction.
static int launch_bwd2_hopper_route(const void* x, const void* ef, const void* wf,
                                    const void* g, const void* cx, const void* cef,
                                    const void* dst_ptr, const void* src_ptr,
                                    const void* slot_src, const void* slot_dst,
                                    const void* src_pos, const void* dst_pos, const void* tab,
                                    void* rows_x, void* rows_g, void* d2x, void* d2ef,
                                    void* dwf_part, void* d2wf, void* d2g, int n_out,
                                    int n_rows, int n_slots, int n_part, int ni, int nd,
                                    int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                                    int n_pt, cudaStream_t s) {
  XeqH2Dims p;
  if (tab == nullptr ||
      !bwd2_hopper_dims(p, n_slots, ni, nd, h_dim, hp, d, dp, sdp, kw, kf, n_pt))
    return (int)cudaErrorInvalidValue;
  int err = launch_bwd2_hopper(x, ef, wf, g, cx, cef, slot_src, slot_dst, src_pos, dst_pos, tab,
                               rows_x, rows_g, d2ef, dwf_part, p, n_part, nullptr, s);
  if (err != cudaSuccess) return err;
  if (n_rows > 0) {
    message_bwd2_d2x_rows_kernel<<<(n_rows + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows_x, (const int*)src_ptr, (float*)d2x, n_rows, p.ht8, p.dt8, hp,
        hp + dp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n_out > 0) {
    message_bwd2_d2g_rows_kernel<<<(n_out + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows_g, (const int*)dst_ptr, (float*)d2g, n_out, p.sd8, p.dt8, sdp,
        sdp + dp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)d2wf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

// The f32 tile pass (message_f32_tile.cuh), the d2g pass over its f32
// scratch rows (rows_g, by destination) and the d2wf reduction.  STAMP: the
// phase probe's instance (xeq_bwd2_f32_phases).
template <bool STAMP>
__global__ void __launch_bounds__(XEQ_F32_THREADS, 1)
message_bwd2_f32_kernel(const XeqF32Args a, const XeqF32Dims p) {
  xeq_f32_body<true, STAMP>(a, p);
}

template <bool STAMP>
static int launch_bwd2_f32_route(const void* x, const void* ef, const void* wf, const void* g,
                                 const void* cx, const void* cef, const void* dst_ptr,
                                 const void* src_ptr, const void* src_slots,
                                 const void* slot_src, const void* slot_dst,
                                 const void* dst_pos, const void* units, void* rows_g,
                                 void* d2x, void* d2ef, void* dwf_part, void* d2wf, void* d2g,
                                 int n_out, int n_rows, int n_slots, int n_part, int ni, int nd,
                                 int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                                 int n_cw, long long* stamps, cudaStream_t s) {
  XeqF32Dims p;
  if (units == nullptr || (rows_g == nullptr && n_slots > 0) || (STAMP && stamps == nullptr) ||
      (sdp + dp) % 128 != 0 ||
      !f32_tile_dims(p, true, n_slots, n_rows, ni, nd, h_dim, hp, d, dp, sdp, kw, kf, n_cw))
    return (int)cudaErrorInvalidValue;
  const XeqF32Args a = {(const float*)x, (const float*)ef, (const float*)wf, (const float*)g,
                        (const float*)cx, (const float*)cef, (const int*)src_ptr,
                        (const int*)src_slots, (const int*)slot_src, (const int*)slot_dst,
                        (const int*)dst_pos, (const int4*)units, (float*)d2x, (float*)d2ef,
                        (float*)dwf_part, (float*)rows_g, stamps};
  int err = xeq_f32_launch(message_bwd2_f32_kernel<STAMP>, a, p, n_part, s);
  if (err != cudaSuccess) return err;
  if (n_out > 0) {
    message_bwd2_d2g_rows_f32_kernel<<<(n_out + 7) / 8, 256, 0, s>>>(
        (const float*)rows_g, (const int*)dst_ptr, (float*)d2g, n_out, p.gs, nd, p.sd8, d, sdp,
        sdp + dp);
    err = (int)cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)d2wf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

// tiles, chosen by the wrapper by shape: 3 (f32 without cwf), the f32 tile
// pass (message_f32_tile.cuh; tab: its unit table, one int4 per consumer
// thread, n_tab its consumer warps; rows_g: its f32 d2g scratch rows); 2
// (bf16 without cwf), the Hopper tile pass (message_bwd2_hopper.cuh; tab:
// its pair rows [32 n_tab], n_tab pair tiles); 1 (bf16 without cwf), the
// tile pass above when a layout of it fits (dfw2_rows / dfwr_rows: its
// scratch when d2wf leaves the registers); 0, the walk kernels in the
// operands' dtype, with or without the cwf terms, over n_hc column chunks
// (def_part: their d2ef partials when n_hc > 1).
extern "C" int xeq_message_bwd2(
    const void* x, const void* ef, const void* wf, const void* g,
    const void* cx, const void* cef, const void* cwf, const void* dst_ptr,
    const void* dst_slots, const void* src_ptr, const void* src_slots,
    const void* slot_src, const void* slot_dst, const void* src_pos,
    const void* dst_pos, const void* lane_gate, const void* lane_ycol,
    const void* gate_lane0, const void* gate_dim, const void* ylane_ptr,
    const void* ylane_idx, const void* tab, void* rows_x, void* rows_g, void* dfw2_rows,
    void* dfwr_rows, void* def_part, void* d2x, void* d2ef, void* dwf_part, void* d2wf,
    void* d2g, int n_out, int n_rows, int n_slots, int n_part, int ni, int nd, int h_dim,
    int hp, int d, int dp, int sdp, int kw, int kf, int bf16, int has_cwf, int tiles,
    int n_hc, int n_tab, void* stream) {
  if (kw > kf || kf > XEQ_FPACK || (hp + dp) % 128 != 0 || (sdp + dp) % 128 != 0 ||
      n_part < 1 || (has_cwf && cwf == nullptr) || (tiles && has_cwf) ||
      ((tiles == 1 || tiles == 2) && !bf16) || (tiles == 3 && bf16) || tiles < 0 || tiles > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles == 3)
    return launch_bwd2_f32_route<false>(x, ef, wf, g, cx, cef, dst_ptr, src_ptr, src_slots,
                                        slot_src, slot_dst, dst_pos, tab, rows_g, d2x, d2ef,
                                        dwf_part, d2wf, d2g, n_out, n_rows, n_slots, n_part, ni,
                                        nd, h_dim, hp, d, dp, sdp, kw, kf, n_tab, nullptr, s);
  if (tiles == 2)
    return launch_bwd2_hopper_route(x, ef, wf, g, cx, cef, dst_ptr, src_ptr, slot_src, slot_dst,
                                    src_pos, dst_pos, tab, rows_x, rows_g, d2x, d2ef, dwf_part,
                                    d2wf, d2g, n_out, n_rows, n_slots, n_part, ni, nd, h_dim,
                                    hp, d, dp, sdp, kw, kf, n_tab, s);
  if (tiles)
    return launch_bwd2_tiles(x, ef, wf, g, cx, cef, dst_ptr, src_ptr, slot_src, slot_dst,
                             src_pos, dst_pos, lane_gate, lane_ycol, gate_lane0, gate_dim,
                             rows_x, rows_g, dfw2_rows, dfwr_rows, d2x, d2ef, dwf_part, d2wf,
                             d2g, n_out, n_rows, n_slots, n_part, ni, nd, h_dim, hp, d, dp,
                             sdp, kw, kf, s);
  if (bf16) {
    if (has_cwf) return launch_bwd2<__nv_bfloat16, true, true>(XEQ_BWD2_ARGS);
    return launch_bwd2<__nv_bfloat16, true, false>(XEQ_BWD2_ARGS);
  }
  if (has_cwf) return launch_bwd2<float, false, true>(XEQ_BWD2_ARGS);
  return launch_bwd2<float, false, false>(XEQ_BWD2_ARGS);
}

// The phase probe (xequinet_torch/tools/bwd_compare.py; on no model path):
// one launch of a bf16 tile pass without cwf alone, with clock64() stamps
// per phase in stamps: which = 0, the mma.sync tile pass's flagship
// instance (wf's live rows in shared memory, d2wf in registers;
// [n_part][8]); which = 1, the Hopper tile pass ([n_part][XEQ_H2_WGS +
// 1][8]: the consumer warpgroups, then the producer; tab, n_tab: its pair
// rows).  Its outputs are the pass's: d2ef, the scratch rows and the d2wf
// partials.
extern "C" int xeq_bwd2_phases(const void* x, const void* ef, const void* wf, const void* g,
                               const void* cx, const void* cef, const void* slot_src,
                               const void* slot_dst, const void* src_pos, const void* dst_pos,
                               const void* lane_gate, const void* lane_ycol,
                               const void* gate_lane0, const void* gate_dim, const void* tab,
                               void* rows_x, void* rows_g, void* d2ef, void* dwf_part,
                               int n_slots, int n_part, int ni, int nd, int h_dim, int hp, int d,
                               int dp, int sdp, int kw, int kf, int n_tab, int which,
                               void* stamps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_part < 1 || stamps == nullptr) return (int)cudaErrorInvalidValue;
  if (which == 1) {
    XeqH2Dims q;
    if (tab == nullptr ||
        !bwd2_hopper_dims(q, n_slots, ni, nd, h_dim, hp, d, dp, sdp, kw, kf, n_tab))
      return (int)cudaErrorInvalidValue;
    return launch_bwd2_hopper(x, ef, wf, g, cx, cef, slot_src, slot_dst, src_pos, dst_pos, tab,
                              rows_x, rows_g, d2ef, dwf_part, q, n_part, (long long*)stamps, s);
  }
  XeqTile2Layout p;
  if (which != 0 || !bwd2_tile_dims(p, n_slots, ni, nd, h_dim, hp, d, dp, sdp, kw, kf) ||
      !p.wf_smem || !p.dwf_regs || p.lean)
    return (int)cudaErrorInvalidValue;
  auto kernel = message_bwd2_tile_stamped_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, XEQ_BT_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const xeq_bf16*)cx, (const xeq_bf16*)cef, (const int*)slot_src, (const int*)slot_dst,
      (const int*)src_pos, (const int*)dst_pos, (const int*)lane_gate, (const int*)lane_ycol,
      (const int*)gate_lane0, (const int*)gate_dim, (xeq_bf16*)rows_x, (xeq_bf16*)rows_g,
      nullptr, nullptr, (float*)d2ef, (float*)dwf_part, static_cast<const XeqTile2Dims&>(p),
      (long long*)stamps);
  return (int)cudaGetLastError();
}

// The f32 tile pass's phase probe (xequinet_torch/tools/bwd_compare.py
// --kernel message_bwd2 --dtype float32 --phases; on no model path): the f32
// route of xeq_message_bwd2 (tiles = 3) with the stamped instance of its
// tile pass, clock64() cycles per phase in stamps [n_part][2][8] (the
// consumers, then the producer).  Its outputs are the route's.
extern "C" int xeq_bwd2_f32_phases(const void* x, const void* ef, const void* wf, const void* g,
                                   const void* cx, const void* cef, const void* dst_ptr,
                                   const void* src_ptr, const void* src_slots,
                                   const void* slot_src, const void* slot_dst,
                                   const void* dst_pos, const void* units, void* rows_g,
                                   void* d2x, void* d2ef, void* dwf_part, void* d2wf, void* d2g,
                                   int n_out, int n_rows, int n_slots, int n_part, int ni,
                                   int nd, int h_dim, int hp, int d, int dp, int sdp, int kw,
                                   int kf, int n_cw, void* stamps, void* stream) {
  if (n_part < 1 || kw > kf || (hp + dp) % 128 != 0) return (int)cudaErrorInvalidValue;
  return launch_bwd2_f32_route<true>(x, ef, wf, g, cx, cef, dst_ptr, src_ptr, src_slots,
                                     slot_src, slot_dst, dst_pos, units, rows_g, d2x, d2ef,
                                     dwf_part, d2wf, d2g, n_out, n_rows, n_slots, n_part, ni, nd,
                                     h_dim, hp, d, dp, sdp, kw, kf, n_cw, (long long*)stamps,
                                     (cudaStream_t)stream);
}
