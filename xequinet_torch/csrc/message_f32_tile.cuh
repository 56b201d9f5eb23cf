// The f32 instances of the first- and second-order message backward
// (message_bwd.cu, message_bwd2.cu without cwf) as tile passes for the
// H100's FP32 pipes, at the widths of ops/fused_message.py::f32_route (Kw
// <= 24, Kf <= 32, at most XEQ_F32_CW consumer warps of units, below).
// They replace the walk kernels at those widths: one thread per (row,
// column) walking a CSR list and recomputing each slot's filter once per
// output column (message_bwd: 6.0 ms at the flagship batch against an
// FP32 bound of 0.23; message_bwd2: 13.5 against 0.40; NVIDIA H100 80GB
// HBM3, 700 W).  f32 stays exact f32: no TF32, no tensor cores, no
// rounding step (the TPU kernel runs f32 at Precision.HIGHEST).
//
// What bounds it: the FP32 contractions (fw = ef . wf, r = cef . wf, the
// d_ef / d2ef filter columns dfw . wf^T and the d_wf / d2wf partials,
// ~83 kFLOP a slot in the first order, ~150 kFLOP in the second) and the
// sums of d_ef's columns over H, which cross threads.  The design computes
// each slot's filter once per column, keeps wf's columns and the d_wf
// partial in registers for the whole walk, and sums dx (d2x) in registers
// along the list by source, so the first order has no scratch at all.
//
// Block: XEQ_F32_CW consumer warps at most and one producer warp, one
// block per SM.  Each block walks a contiguous range of the CSR list by
// source (plan["src_slots"]), cut at row boundaries so that the blocks'
// slot counts differ by at most one row's: block b owns the rows [R_b,
// R_{b+1}), R_b the first row whose list starts at or past b P / grid (P
// the valid slots), and every dx row of its range is written by it alone,
// once.  Its tiles are XEQ_F32_BT consecutive positions of its range.
//  * The producer warp loads a tile's slot indices (the list entry, then
//    its source and destination rows) and stages it into a ring of
//    ``nst`` stages (as many as fit, at most XEQ_F32_MAXST) with a full and
//    an empty mbarrier each: lane t issues cp.async.bulk copies (global ->
//    shared, counted in bytes on the full barrier) of slot t's g row
//    [gms_s | gms_v], its 32 edge-feature columns (and cef's), and, where
//    slot t's source differs from slot t - 1's, the source's x row [gs |
//    gv] (and cx's): slots of one source share the first one's copy.
//  * Consumer thread i owns a unit (ops/fused_message.py::f32_units): an
//    irrep u (its state gate u, its harmonic gate ni + u and its 2l + 1
//    lanes) or two scalar columns 2 ni + c, 2 ni + c + 1; units of one
//    kind and one l fill whole warps, so the lane loops are uniform in a
//    warp.  The thread keeps its two columns of wf's live rows (2 x 24
//    f32) and of the d_wf partial (2 x 32) in registers.  Per slot, in
//    list order: the gate sums (dfo, u), the filter products of its two
//    columns over the slot's edge-feature row (broadcast from shared
//    memory, 4 columns a load), the d_wf partial, the elementwise terms,
//    and the d_ef filter partials (21 at the flagship) and harmonic terms
//    summed over the warp in one recursive halving of 32 values (lane f
//    ends with column f's sum, lanes 24 + m with the irrep's harmonic
//    column m) into the tile's reduction buffer.  One barrier of the consumers per tile; then d_ef's rows (the
//    warps' partials in warp order) and the stage's release.  dx rows (d2x
//    in the second order) are summed in registers while the source stays
//    and written when it changes, the rows of the range with no slot as
//    zeros, the padding columns as zeros.
//  * Second order: the d2g rows go by destination, so each valid slot's
//    [a[2ni:] | gv a[gate] + ef[ycol] a[ni + gate] + cxv fo[gate] +
//    fo[ni + gate] cef[ycol]] row goes to an f32 scratch at its position in
//    the list by destination (plan["dst_pos"]), which
//    message_bwd2_d2g_rows_f32_kernel sums by destination.
// No float atomics: d_wf as per-block partials summed by
// xeq_dwf_reduce_kernel in block order, d_ef's columns by a fixed halving
// and warp order, dx and d2g in list order.  Results repeat bit for bit.
// Slots that add nothing (slot_dst < 0) are in neither list: each block
// writes zero d_ef rows for those of its slice of the slots.
#pragma once

#include "hopper_ptx.cuh"

#define XEQ_F32_BT 8      // slots a tile
#define XEQ_F32_CW 9      // consumer warps at most
#define XEQ_F32_THREADS (32 * XEQ_F32_CW + 32)  // and the producer warp
#define XEQ_F32_KW 24     // rows of wf a thread keeps in registers: Kw <= 24
#define XEQ_F32_KF 32     // edge-feature columns staged and summed: Kf <= 32
#define XEQ_F32_MAXST 4   // ring stages at most
#define XEQ_F32_RED (XEQ_F32_BT * XEQ_F32_CW * 32)  // floats of one reduction buffer
static_assert(XEQ_F32_KW + XEQ_MAXM <= 32 && XEQ_F32_KF <= 32,
              "a warp's d_ef sums: the filter rows and an irrep's harmonic terms in 32 values");

// ---------------------------------------------------------------------------
// Sizes and shared-memory layout, from the host
// ---------------------------------------------------------------------------
struct XeqF32Dims {
  int n_slots, n_rows, ni, nd, h, hp, d, dp, sdp, kw, kf;
  int n_cw;           // consumer warps (units / 32)
  int ht8, dt8, sd8;  // H, D, node_dim rounded up to 8
  int xs, gs;         // staged row strides (floats): x and cx [gs | gv], g [gms_s | gms_v]
  int x_bytes, g_bytes;  // bytes of one staged x (or cx) row and of one g row
  int off_cx, off_g, off_e, off_ce, off_idx, stage;  // within a stage (bytes); its size
  int nst;            // ring stages
  int off_red, off_bar, smem;
};

// The layout, ``nst`` as large as the shared memory allows; false where
// the widths are not the pass's.  ops/fused_message.py::_f32_layout states
// the same sizes.  second: message_bwd2's (cx and cef staged too).
static bool f32_tile_dims(XeqF32Dims& p, bool second, int n_slots, int n_rows, int ni, int nd,
                          int h_dim, int hp, int d, int dp, int sdp, int kw, int kf, int n_cw) {
  p.n_slots = n_slots; p.n_rows = n_rows; p.ni = ni; p.nd = nd; p.h = h_dim; p.hp = hp;
  p.d = d; p.dp = dp; p.sdp = sdp; p.kw = kw; p.kf = kf; p.n_cw = n_cw;
  p.ht8 = xeq_round_up(h_dim, 8);
  p.dt8 = xeq_round_up(d, 8);
  p.sd8 = xeq_round_up(nd, 8);
  p.xs = p.ht8 + p.dt8;
  p.gs = p.sd8 + p.dt8;
  p.x_bytes = p.xs * 4;
  p.g_bytes = p.gs * 4;
  const int xb = XEQ_F32_BT * p.x_bytes, eb = XEQ_F32_BT * XEQ_F32_KF * 4;
  p.off_cx = xb;
  p.off_g = p.off_cx + (second ? xb : 0);
  p.off_e = p.off_g + XEQ_F32_BT * p.g_bytes;
  p.off_ce = p.off_e + eb;
  p.off_idx = p.off_ce + (second ? eb : 0);
  p.stage = xeq_round_up(p.off_idx + 4 * XEQ_F32_BT * 4, 128);
  const int fixed = 2 * XEQ_F32_RED * 4 + 2 * XEQ_F32_MAXST * 8 + 16;
  p.nst = (XEQ_SMEM_MAX - fixed) / p.stage;
  if (p.nst > XEQ_F32_MAXST) p.nst = XEQ_F32_MAXST;
  p.off_red = p.nst * p.stage;
  p.off_bar = p.off_red + 2 * XEQ_F32_RED * 4;
  p.smem = p.off_bar + 2 * XEQ_F32_MAXST * 8 + 16;
  return kw <= XEQ_F32_KW && kf <= XEQ_F32_KF && kw <= kf && kf - kw <= XEQ_MAXY &&
         n_cw >= 1 && n_cw <= XEQ_F32_CW && p.nst >= 2 && p.smem <= XEQ_SMEM_MAX &&
         2 * ni + nd == h_dim && p.ht8 <= hp && p.dt8 <= dp && p.sd8 <= sdp;
}

// The pointers a pass takes (the second order's cx, cef, dst_pos and
// rows_g; dx is d2x there and d_ef d2ef).
struct XeqF32Args {
  const float *x, *ef, *wf, *g, *cx, *cef;
  const int *src_ptr, *src_slots, *slot_src, *slot_dst, *dst_pos;
  const int4* units;
  float *dx, *d_ef, *dwf_part, *rows_g;
  long long* stamps;
};

// The first row r in [0, n] whose list starts at or past position pos
// (ptr nondecreasing, ptr[0] = 0).
__device__ __forceinline__ int xeq_row_at(const int* __restrict__ ptr, int n, long long pos) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ptr + mid) >= pos) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// ---------------------------------------------------------------------------
// The pass.  SECOND: message_bwd2's (the closed form of message_bwd2.cu's
// header without the cwf terms), else message_bwd's.  STAMP: the phase
// probe's instance: thread 0 of the consumers and lane 0 of the producer
// add the clock64() cycles of their phases, written to
// stamps[(block * 2 + role) * XEQ_STAMPS] (role 0 the consumers, 1 the
// producer; fused_message.PHASES["f32"] and ["producer_f32"]).
// ---------------------------------------------------------------------------
template <bool SECOND, bool STAMP>
__device__ __forceinline__ void xeq_f32_body(const XeqF32Args& a, const XeqF32Dims& p) {
  extern __shared__ __align__(128) unsigned char f_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(f_smem + p.off_bar);
  uint64_t* empty = full + XEQ_F32_MAXST;
  int* range = reinterpret_cast<int*>(empty + XEQ_F32_MAXST);  // the block's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_ct = 32 * p.n_cw, grid = gridDim.x, b = blockIdx.x;
  XeqStamps<STAMP> sp;

  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      xeq_mbar_init(full + s, 1);
      xeq_mbar_init(empty + s, n_ct);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const long long total = __ldg(a.src_ptr + p.n_rows);
    range[0] = xeq_row_at(a.src_ptr, p.n_rows, (long long)b * total / grid);
    range[1] = b + 1 == grid ? p.n_rows
                             : xeq_row_at(a.src_ptr, p.n_rows, (long long)(b + 1) * total / grid);
  }
  // zero d_ef rows for the slots of this block's slice that add nothing
  // (they are in no list), a warp's 32 slots at a time
  if (warp < p.n_cw) {
    const int k_lo = (int)((long long)b * p.n_slots / grid);
    const int k_hi = (int)((long long)(b + 1) * p.n_slots / grid);
    for (int k0 = k_lo + 32 * warp; k0 < k_hi; k0 += n_ct) {
      const bool pad = k0 + lane < k_hi && __ldg(a.slot_dst + k0 + lane) < 0;
      for (unsigned m = __ballot_sync(0xffffffffu, pad); m; m &= m - 1)
        reinterpret_cast<float4*>(a.d_ef + (int64_t)(k0 + __ffs(m) - 1) * XEQ_FPACK)[lane] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  const int r0 = range[0], r1 = range[1];
  const int P0 = __ldg(a.src_ptr + r0), P1 = __ldg(a.src_ptr + r1);
  const int n_tiles = (P1 - P0 + XEQ_F32_BT - 1) / XEQ_F32_BT;
  sp.mark(0);

  if (warp == p.n_cw) {
    // ---- the producer warp: lane t < XEQ_F32_BT stages slot t of a tile
    const int xw = p.hp + p.dp, gw = p.sdp + p.dp;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % p.nst, q = P0 + it * XEQ_F32_BT + lane;
      const bool ok = lane < XEQ_F32_BT && q < P1;
      int k = -1, src = -1, dst = 0, pos2 = -1;
      if (ok) {
        k = __ldg(a.src_slots + q);
        src = __ldg(a.slot_src + k);
        dst = __ldg(a.slot_dst + k);
        if (SECOND) pos2 = __ldg(a.dst_pos + k);
      }
      // slots of one source share the staged row of the first of them
      const int prev = __shfl_up_sync(0xffffffffu, src, 1);
      const bool first = ok && (lane == 0 || prev != src);
      const unsigned fm = __ballot_sync(0xffffffffu, first);
      const int xrow = ok ? 31 - __clz(fm & (0xffffffffu >> (31 - lane))) : 0;
      const uint32_t mine =
          ok ? p.g_bytes + (SECOND ? 2 : 1) * (XEQ_F32_KF * 4 + (first ? p.x_bytes : 0)) : 0;
      const uint32_t bytes = __reduce_add_sync(0xffffffffu, mine);
      sp.mark(2);
      xeq_mbar_wait(empty + s, ((it / p.nst) & 1) ^ 1);
      sp.mark(1);
      unsigned char* st = f_smem + s * p.stage;
      if (lane < XEQ_F32_BT) {
        int* idx = reinterpret_cast<int*>(st + p.off_idx);
        idx[lane] = k;
        idx[XEQ_F32_BT + lane] = src;
        idx[2 * XEQ_F32_BT + lane] = xrow;
        idx[3 * XEQ_F32_BT + lane] = pos2;
      }
      __syncwarp();
      if (lane == 0) xeq_mbar_arrive_tx(full + s, bytes);
      __syncwarp();
      if (ok) {
        if (first) {
          float* xs = reinterpret_cast<float*>(st) + lane * p.xs;
          const float* xr = a.x + (int64_t)src * xw;
          xeq_bulk_g2s(xs, xr, p.ht8 * 4, full + s);
          xeq_bulk_g2s(xs + p.ht8, xr + p.hp, p.dt8 * 4, full + s);
          if (SECOND) {
            float* cs = reinterpret_cast<float*>(st + p.off_cx) + lane * p.xs;
            const float* cr = a.cx + (int64_t)src * xw;
            xeq_bulk_g2s(cs, cr, p.ht8 * 4, full + s);
            xeq_bulk_g2s(cs + p.ht8, cr + p.hp, p.dt8 * 4, full + s);
          }
        }
        float* gs = reinterpret_cast<float*>(st + p.off_g) + lane * p.gs;
        const float* gr = a.g + (int64_t)dst * gw;
        if (p.sd8 == p.sdp) {
          xeq_bulk_g2s(gs, gr, p.g_bytes, full + s);
        } else {
          xeq_bulk_g2s(gs, gr, p.sd8 * 4, full + s);
          xeq_bulk_g2s(gs + p.sd8, gr + p.sdp, p.dt8 * 4, full + s);
        }
        xeq_bulk_g2s(st + p.off_e + lane * XEQ_F32_KF * 4, a.ef + (int64_t)k * XEQ_FPACK,
                     XEQ_F32_KF * 4, full + s);
        if (SECOND)
          xeq_bulk_g2s(st + p.off_ce + lane * XEQ_F32_KF * 4, a.cef + (int64_t)k * XEQ_FPACK,
                       XEQ_F32_KF * 4, full + s);
      }
      sp.mark(3);
    }
    sp.mark(7);
    if (STAMP && lane == 0) sp.write(a.stamps + ((int64_t)b * 2 + 1) * XEQ_STAMPS);
    return;
  }

  // ---- consumer thread tid: its unit (c0, c1: its columns of H, -1 where
  // none; j0, dim, yc: an irrep's first lane, lanes and harmonic column - Kw,
  // dim 0 in a scalar warp; dim and yc are the warp's, padding lanes too)
  const int4 un = __ldg(a.units + tid);
  const int c0 = un.x, c1 = un.y, j0 = un.z, dim = un.w & 0xff, yc = un.w >> 8;
  const int wdim = __shfl_sync(0xffffffffu, dim, 0);  // the same in the whole warp
  const bool irrep = wdim > 0 && c0 >= 0;
  const int ldim = irrep ? dim : 0;
  const int ni2 = 2 * p.ni, xw = p.hp + p.dp;
  float w0[XEQ_F32_KW], w1[XEQ_F32_KW];
#pragma unroll
  for (int f = 0; f < XEQ_F32_KW; ++f) {
    w0[f] = c0 >= 0 && f < p.kw ? __ldg(a.wf + (int64_t)f * p.hp + c0) : 0.f;
    w1[f] = c1 >= 0 && f < p.kw ? __ldg(a.wf + (int64_t)f * p.hp + c1) : 0.f;
  }
  float acc0[XEQ_F32_KF], acc1[XEQ_F32_KF];  // the d_wf (d2wf) partial of c0, c1
#pragma unroll
  for (int f = 0; f < XEQ_F32_KF; ++f) acc0[f] = acc1[f] = 0.f;
  // the open dx (d2x) row: hidden columns c0, c1 and the irrep's lanes
  float rh0 = 0.f, rh1 = 0.f, rv[XEQ_MAXM];
#pragma unroll
  for (int m = 0; m < XEQ_MAXM; ++m) rv[m] = 0.f;
  const int n_pad = (p.hp - p.h) + (p.dp - p.d);  // a row's padding columns
  // write row r of dx: the open row's sums, or zeros
  auto put_row = [&](int r, bool zero) {
    float* row = a.dx + (int64_t)r * xw;
    if (c0 >= 0) row[c0] = zero ? 0.f : rh0;
    if (c1 >= 0) row[c1] = zero ? 0.f : rh1;
#pragma unroll
    for (int m = 0; m < XEQ_MAXM; ++m)
      if (m < ldim) row[p.hp + j0 + m] = zero ? 0.f : rv[m];
    for (int c = tid; c < n_pad; c += n_ct) row[c < p.hp - p.h ? p.h + c : p.d + p.h + c] = 0.f;
  };
  int cur = -1, next = r0;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % p.nst, nt = min(XEQ_F32_BT, P1 - P0 - it * XEQ_F32_BT);
    xeq_mbar_wait(full + s, (it / p.nst) & 1);
    sp.mark(1);
    const unsigned char* st = f_smem + s * p.stage;
    const int* idx = reinterpret_cast<const int*>(st + p.off_idx);
    float* red = reinterpret_cast<float*>(f_smem + p.off_red) + (it & 1) * XEQ_F32_RED;
    for (int t = 0; t < nt; ++t) {
      const int src = idx[XEQ_F32_BT + t];
      if (src != cur) {  // the same in every consumer thread
        if (cur >= 0) put_row(cur, false);
        for (int r = next; r < src; ++r) put_row(r, true);
        cur = src;
        next = src + 1;
        rh0 = rh1 = 0.f;
#pragma unroll
        for (int m = 0; m < XEQ_MAXM; ++m) rv[m] = 0.f;
      }
      sp.mark(7);
      const int xrow = idx[2 * XEQ_F32_BT + t];
      const float* xr = reinterpret_cast<const float*>(st) + xrow * p.xs;
      const float* gr = reinterpret_cast<const float*>(st + p.off_g) + t * p.gs;
      const float* er = reinterpret_cast<const float*>(st + p.off_e) + t * XEQ_F32_KF;
      const float* cxr = reinterpret_cast<const float*>(st + p.off_cx) + xrow * p.xs;
      const float* cer = reinterpret_cast<const float*>(st + p.off_ce) + t * XEQ_F32_KF;
      // the operands of the thread's columns, and the gate sums: dfo (and
      // u) at c0 (state gate u, or scalar) and c1 (harmonic gate); the lane
      // operands are read again from the stage where the elementwise terms
      // need them, so that they hold no registers across the products
      const float x0 = c0 >= 0 ? xr[c0] : 0.f, x1 = c1 >= 0 ? xr[c1] : 0.f;
      float cx0 = 0.f, cx1 = 0.f;
      if (SECOND) {
        cx0 = c0 >= 0 ? cxr[c0] : 0.f;
        cx1 = c1 >= 0 ? cxr[c1] : 0.f;
      }
      const float* gv = gr + p.sd8 + j0;   // gms_v at the irrep's lanes
      const float* xv = xr + p.ht8 + j0;   // gv
      const float* cv = cxr + p.ht8 + j0;  // cxv
      const float* ey = er + p.kw + yc;    // the harmonic columns of ef and cef
      const float* cy = cer + p.kw + yc;
      float dfo0 = 0.f, dfo1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int m = 0; m < XEQ_MAXM; ++m) {
        if (m < ldim) {
          const float gm = gv[m];
          dfo0 += xv[m] * gm;
          dfo1 += ey[m] * gm;
          if (SECOND) {
            u0 += cv[m] * gm;
            u1 += cy[m] * gm;
          }
        }
      }
      if (wdim == 0) {  // scalar columns: dfo is gms_s, u zero
        dfo0 = c0 >= 0 ? gr[c0 - ni2] : 0.f;
        dfo1 = c1 >= 0 ? gr[c1 - ni2] : 0.f;
      }
      sp.mark(2);
      // the filter (and its cotangent) at both columns over the slot's
      // edge-feature row, and the d_wf (d2wf) partials, 4 columns a load
      // (columns >= Kf are zero in ef and cef, rows >= Kw of w zero)
      const float dfw0 = SECOND ? dfo0 * cx0 + u0 * x0 : dfo0 * x0;
      const float dfw1 = SECOND ? dfo1 * cx1 + u1 * x1 : dfo1 * x1;
      const float dfr0 = dfo0 * x0, dfr1 = dfo1 * x1;  // dfwr (second order)
      float fw0 = 0.f, fw1 = 0.f, rc0 = 0.f, rc1 = 0.f;
#pragma unroll
      for (int q = 0; q < XEQ_F32_KF / 4; ++q) {
        const float4 e4 = reinterpret_cast<const float4*>(er)[q];
        const float e[4] = {e4.x, e4.y, e4.z, e4.w};
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        if (SECOND) {
          const float4 c4 = reinterpret_cast<const float4*>(cer)[q];
          c[0] = c4.x;
          c[1] = c4.y;
          c[2] = c4.z;
          c[3] = c4.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = 4 * q + i;
          if (f < XEQ_F32_KW) {
            fw0 += e[i] * w0[f];
            fw1 += e[i] * w1[f];
            if (SECOND) {
              rc0 += c[i] * w0[f];
              rc1 += c[i] * w1[f];
            }
          }
          if (SECOND) {
            acc0[f] += e[i] * dfw0 + c[i] * dfr0;
            acc1[f] += e[i] * dfw1 + c[i] * dfr1;
          } else {
            acc0[f] += e[i] * dfw0;
            acc1[f] += e[i] * dfw1;
          }
        }
      }
      sp.mark(3);
      // the elementwise terms: the open row's sums, the harmonic columns'
      // per-lane terms hy and (second order) the slot's d2g scratch row
      const float fo0 = x0 * fw0, fo1 = x1 * fw1;
      float hy[XEQ_MAXM];
      if (SECOND) {
        const float a0 = cx0 * fw0 + rc0 * x0, a1 = cx1 * fw1 + rc1 * x1;
        rh0 += dfo0 * rc0 + u0 * fw0;
        rh1 += dfo1 * rc1 + u1 * fw1;
        float* rg = a.rows_g + (int64_t)idx[3 * XEQ_F32_BT + t] * p.gs;
        if (wdim == 0) {
          if (c0 >= 0) rg[c0 - ni2] = a0;
          if (c1 >= 0) rg[c1 - ni2] = a1;
        }
#pragma unroll
        for (int m = 0; m < XEQ_MAXM; ++m) {
          hy[m] = 0.f;
          if (m < ldim) {
            const float gm = gv[m];
            hy[m] = gm * a1;
            rv[m] += gm * a0;
            rg[p.sd8 + j0 + m] = xv[m] * a0 + ey[m] * a1 + cv[m] * fo0 + fo1 * cy[m];
          }
        }
      } else {
        rh0 += dfo0 * fw0;
        rh1 += dfo1 * fw1;
#pragma unroll
        for (int m = 0; m < XEQ_MAXM; ++m) {
          hy[m] = 0.f;
          if (m < ldim) {
            const float gm = gv[m];
            hy[m] = fo1 * gm;
            rv[m] += fo0 * gm;
          }
        }
      }
      sp.mark(4);
      // d_ef's columns summed over the warp in one recursive halving: value
      // f < XEQ_F32_KW the thread's filter partial over its two columns
      // (zero for f >= Kw), value XEQ_F32_KW + m its harmonic term hy[m];
      // lane f keeps filter column f, lane XEQ_F32_KW + m moves its sum to
      // harmonic column Kw + yc + m (yc is the warp's), where the filter
      // part is zero
      float v[32];
#pragma unroll
      for (int f = 0; f < 32; ++f)
        v[f] = f < XEQ_F32_KW ? dfw0 * w0[f] + dfw1 * w1[f]
               : f < XEQ_F32_KW + XEQ_MAXM ? hy[f < XEQ_F32_KW + XEQ_MAXM ? f - XEQ_F32_KW : 0]
                                            : 0.f;
      xeq_halving_sum(v);
      float* rw = red + (t * XEQ_F32_CW + warp) * 32;
      rw[lane] = lane < XEQ_F32_KW ? v[0] : 0.f;
      if (lane >= XEQ_F32_KW && lane < XEQ_F32_KW + wdim) rw[p.kw + yc + lane - XEQ_F32_KW] = v[0];
      sp.mark(5);
    }
    xeq_bar_sync(1, n_ct);  // the tile's warp sums are in red
    // d_ef rows of the tile's slots: the warps' partials in warp order,
    // zeros past Kf; a float4 of a row per thread at a time
    for (int i = tid; i < nt * (XEQ_FPACK / 4); i += n_ct) {
      const int t = i / (XEQ_FPACK / 4), f0 = 4 * (i % (XEQ_FPACK / 4));
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (f0 + c < p.kf) {
          for (int w = 0; w < p.n_cw; ++w) o[c] += red[(t * XEQ_F32_CW + w) * 32 + f0 + c];
        }
      }
      reinterpret_cast<float4*>(a.d_ef + (int64_t)idx[t] * XEQ_FPACK)[f0 / 4] =
          make_float4(o[0], o[1], o[2], o[3]);
    }
    xeq_mbar_arrive(empty + s);  // the stage is read
    sp.mark(6);
  }
  if (cur >= 0) put_row(cur, false);
  for (int r = next; r < r1; ++r) put_row(r, true);
  sp.mark(7);
  float* part = a.dwf_part + (int64_t)b * p.kf * p.h;
#pragma unroll
  for (int f = 0; f < XEQ_F32_KF; ++f) {
    if (f < p.kf) {
      if (c0 >= 0) part[(int64_t)f * p.h + c0] = acc0[f];
      if (c1 >= 0) part[(int64_t)f * p.h + c1] = acc1[f];
    }
  }
  sp.mark(0);
  if (STAMP && tid == 0) sp.write(a.stamps + (int64_t)b * 2 * XEQ_STAMPS);
}

// Launch ``kernel`` (an instance of the pass) with its layout: one block
// per SM (n_part), the consumer warps and the producer warp.
template <typename K>
static int xeq_f32_launch(K kernel, const XeqF32Args& a, const XeqF32Dims& p, int n_part,
                          cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, 32 * (p.n_cw + 1), p.smem, s>>>(a, p);
  return (int)cudaGetLastError();
}

// out [n_rows, ow] f32: one warp per row r sums the f32 scratch rows ptr[r]
// .. ptr[r+1]-1 (rs floats each, contiguous, in list order); scratch
// column c < w1 goes to column c, s2 <= c < s2 + w2 to off2 + c - s2, and
// every other column is written zero, as is a row with no scratch row.
// Each element is written once.  Launched with 256 threads, 8 rows a block
// (message_bwd2.cu's d2g pass of the f32 route).
#define XEQ_F32_CPL 8  // output columns a lane sums at a time, 32 apart
__global__ void __launch_bounds__(256)
message_bwd2_d2g_rows_f32_kernel(const float* __restrict__ rows, const int* __restrict__ ptr,
                                 float* __restrict__ out, int n_rows, int rs, int w1, int s2,
                                 int w2, int off2, int ow) {
  const int lane = threadIdx.x & 31, r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int p0 = __ldg(ptr + r), p1 = __ldg(ptr + r + 1);
  float* o = out + (int64_t)r * ow;
  for (int cg = 0; cg < ow; cg += 32 * XEQ_F32_CPL) {
    int sc[XEQ_F32_CPL];  // the scratch column of each output column, -1: zero
    float acc[XEQ_F32_CPL];
#pragma unroll
    for (int i = 0; i < XEQ_F32_CPL; ++i) {
      const int col = cg + lane + 32 * i;
      sc[i] = col < w1 ? col : (col >= off2 && col < off2 + w2 ? s2 + col - off2 : -1);
      acc[i] = 0.f;
    }
    for (int q = p0; q < p1; q += 2) {
      float v[2][XEQ_F32_CPL];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < XEQ_F32_CPL; ++i)
          v[u][i] = q + u < p1 && sc[i] >= 0 ? __ldcs(rows + (int64_t)(q + u) * rs + sc[i]) : 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (q + u >= p1) break;
#pragma unroll
        for (int i = 0; i < XEQ_F32_CPL; ++i) acc[i] += v[u][i];
      }
    }
#pragma unroll
    for (int i = 0; i < XEQ_F32_CPL; ++i) {
      const int col = cg + lane + 32 * i;
      if (col < ow) o[col] = acc[i];
    }
  }
}
