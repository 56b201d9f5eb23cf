// The second-order message backward's bf16 tile pass (no cwf) redesigned
// for Hopper: message_bwd2.cu's tile pass at the widths of
// ops/fused_message.py::hopper2_route (the flagship's: bf16 without cwf,
// Kf <= 32, at most 9 m64 tiles of H in the pass's row order, runs of
// irreps of one l of even multiplicity, at most 8 runs).  On those widths
// it replaces the mma.sync tile pass of message_bwd2.cu (one cp.async
// stage of per-warp 16-byte chunks, whose next copies wait on the whole
// body; four block-wide barriers of 512 threads per tile; mma.sync with
// per-warp fragment loads; elementwise steps of one warp per slot).
//
// Block: XEQ_H2_WGS = 3 consumer warpgroups and a producer warp (416
// threads, one block per SM, persistent: tile = block + i * grid, 16 slots
// a tile).
//  * The producer warp stages each tile into a ring of ``nst`` stages (2 at
//    the flagship widths, 90.6 KB a stage) with a full and an empty
//    mbarrier each: lane t issues the cp.async.bulk copies (completion
//    counted in bytes on the full barrier) of slot t's x row [gs | gv] and
//    cx row [cxh | cxv] (two copies each) and g row [gms_s | gms_v] (one
//    where node_dim is a multiple of 8, else two); lane 16 + t loads the
//    slot's 32 edge-feature columns of ef and of cef before the wait for
//    the stage, stores them into wgmma's core-matrix layout and copies the
//    harmonic columns (Kw .. Kf) into slot-contiguous rows, so that a
//    consumer reads two slots' with one load.  Bulk copies do not
//    zero-fill: padding slots (dst2 == BN) and slots past the covered
//    range are not copied, their edge-feature columns are stored as zeros
//    and their scratch positions as -1, and the consumers give them zero
//    contributions and zero d2ef rows (pallas_message.py:870-873).  Before
//    it refills a stage, lane t stores the two scratch rows the consumers
//    left there for slot t of the stage's last tile (one bulk copy each,
//    waited for until read), so that no consumer waits on a store; it also
//    writes each tile's d2ef columns past Kf (zeros).
//  * The shared-memory budget forces the design.  A stage holds 16 x, cx
//    and g rows (16 x 2,128 + 16 x 2,128 + 16 x 1,232 bytes at the
//    flagship) and the edge-feature columns; two stages and wf's live rows
//    (9 m64 tiles x 4 KB) leave 15.6 KB, where the old pass's f32 dfo and
//    u gate sums (2 x 28 KB) and the f32 fo / a tiles would not fit.  So
//    nothing of the elementwise steps goes through shared memory: H's rows
//    are put in an order (the ``tab`` of pair rows) in which each thread's
//    two accumulator rows of an m64 tile are an irrep u's state gate u and
//    its harmonic gate ni + u (pair tiles), or two node_dim columns
//    (scalar tiles).  The thread that owns (u, ni + u) for four slots
//    then forms everything of irrep u from its own registers: dfo and u's
//    gate sums over u's lanes, fo, a, dfw2, dfwr and the hidden d2x
//    column of both rows, the vector d2x and d2g lanes of u and the
//    harmonic d2ef products.  Its outputs are written in place of what
//    only it reads: the d2x row over the staged x row (hidden part over gs,
//    vector part over gv) and the d2g row over the staged g row (a's
//    node_dim columns over gms_s, the vector part over gms_v), which the
//    producer stores; the cx rows, dead by then, hold the warpgroups'
//    d2ef partials.  The host orders the pair rows in groups
//    of 8 irreps of one l (a warp's 8 row groups), balanced over the 12
//    consumer warps by lane count.
//  * Every consumer warpgroup takes every tile; warpgroup wg owns the m64
//    tiles i = wg, wg + 3, ... and their d2wf accumulators (48 f32 a
//    thread).  Per m64 tile: [fw^T | r^T] = wf_live^T . [ef | cef]^T (one
//    wgmma m64n32k16 per k16 step, K = 32: the stage's ef and cef columns
//    lie side by side as one 32-column B); the elementwise step above;
//    the warpgroup's named barrier; d2wf^T += dfw2^T . ef + dfwr^T . cef
//    (m64n32k16, A from registers in fw's accumulator layout) and
//    d2ef^T[:Kw] += wf_live . dfw2^T (m64n16k16, M = 32 real rows of 64, K
//    = the tile's 64 h), issued with the next m64 tile's fw and r (one wait
//    per m64 tile).  The harmonic d2ef products are summed over a warp's 8
//    irreps by recursive halving, then per warp into shared memory, then
//    over the 12 warps in order.  Two barriers of the 384 consumer threads
//    end a tile (rows complete; partials written); none of all 416.  The
//    tile's end (the harmonic sums, d2ef's filter columns) falls to the
//    warpgroups past the first, which the table gives fewer lanes.
//  * ptxas serializes every wgmma of a kernel (a wait after each) where a
//    wgmma sits on a path it takes for divergent or its accumulators are
//    defined by other instructions.  So the warp index comes through a
//    shuffle (known warp-uniform: the roles and m64 tiles follow from it),
//    the walk over m64 tiles has the same length on every warpgroup, and
//    accumulators are set by their first wgmma (scale-d 0), never zeroed.
//  * wgmma reads shared memory in the no-swizzle core-matrix layout, as in
//    message_bwd_hopper.cuh: wf's live rows (in the pass's row order) are
//    fw's and r's A (M-major) and d2ef's A (K-major); a stage's ef and cef
//    columns are fw's and r's B (K-major) and d2wf's B (N-major).
//
// Packed single products: a product of two bf16 values is exact in f32, so
// one bf16 rounding by __hmul2 gives the bits of the TPU kernel's
// f32-then-round (tests/test_torch_gpu.py holds them on the card, also
// below f32's normal range).  The pass packs two slots' values (the
// accumulator layout's column pairs) for exactly those products: the gate
// sums' rnd(gv gms_v), rnd(ef[y] gms_v), rnd(cxv gms_v), rnd(cef[y]
// gms_v), the d2x lanes rnd(gms_v a[gate]) and the harmonic rnd(gms_v
// a[ni + gate]).  Sums of products keep an f32 sum and one rounding, as
// _bwd2_kernel does (:678, :703, :719-724, :744-754): a, dfw2, dfwr, the
// hidden d2x column and the d2g lanes.  No float atomics: d2wf as
// per-block partials summed by xeq_dwf_reduce_kernel in block order;
// d2ef's filter columns are each wgmma's own sum, then the warpgroups'
// partials in order; its harmonic columns fixed-order sums.  Results
// repeat bit for bit.
#pragma once

#include "hopper_ptx.cuh"

#define XEQ_H2_WGS 3                           // consumer warpgroups
#define XEQ_H2_THREADS (128 * XEQ_H2_WGS + 32)  // and the producer warp
#define XEQ_H2_CW (4 * XEQ_H2_WGS)             // consumer warps
#define XEQ_H2_CT (128 * XEQ_H2_WGS)           // consumer threads
#define XEQ_H2_MT 9                            // m64 tiles of H at most
#define XEQ_H2_MTW ((XEQ_H2_MT + XEQ_H2_WGS - 1) / XEQ_H2_WGS)  // of them a warpgroup's
#define XEQ_H2_MAXST 4                         // ring stages at most
#define XEQ_H2_EF 1024                         // a stage's 16 x 32 ef (or cef) columns
#define XEQ_H2_DFW 2048                        // a dfw2 tile: 64 h x 16 slots

// ---------------------------------------------------------------------------
// Sizes and shared-memory layout, from the host
// ---------------------------------------------------------------------------
struct XeqH2Dims {
  int n_slots, ni, nd, h, hp, d, dp, sdp, kw, kf, n_y;
  int n_pt;    // pair tiles (the first ones; then the scalar tiles)
  int n_mt;    // m64 tiles of H: n_pt + node_dim over 64, rounded up
  int mtw;     // m64 tiles a warpgroup walks at most
  int ht8, dt8, sd8;
  int xs_b, gs_b;        // staged row strides (bytes): [gs | gv], [gms_s | gms_v], + 16
  int x_bytes, g_bytes;  // bytes copied per valid slot of an x (or cx) row and a g row
  int off_cx, off_g, off_e, off_ce, off_eh, off_ch, off_pos, stage;  // within a stage
  int nst;               // ring stages
  int off_wf, off_dfw, off_hs, off_tab, off_bar, smem;
};

// The layout, ``nst`` as large as the shared memory allows (at most
// XEQ_H2_MAXST); false where the widths are not the pass's.
// ops/fused_message.py::_hopper2_layout states the same sizes.
static bool bwd2_hopper_dims(XeqH2Dims& p, int n_slots, int ni, int nd, int h_dim, int hp,
                             int d, int dp, int sdp, int kw, int kf, int n_pt) {
  p.n_slots = n_slots; p.ni = ni; p.nd = nd; p.h = h_dim; p.hp = hp; p.d = d; p.dp = dp;
  p.sdp = sdp; p.kw = kw; p.kf = kf; p.n_y = kf - kw; p.n_pt = n_pt;
  p.n_mt = n_pt + (nd + 63) / 64;
  p.mtw = (p.n_mt + XEQ_H2_WGS - 1) / XEQ_H2_WGS;
  p.ht8 = xeq_round_up(h_dim, 8);
  p.dt8 = xeq_round_up(d, 8);
  p.sd8 = xeq_round_up(nd, 8);
  p.x_bytes = (p.ht8 + p.dt8) * 2;
  p.g_bytes = (p.sd8 + p.dt8) * 2;
  p.xs_b = p.x_bytes + 16;
  p.gs_b = p.g_bytes + 16;
  p.off_cx = XEQ_BT * p.xs_b;
  p.off_g = p.off_cx + XEQ_BT * p.xs_b;
  p.off_e = p.off_g + XEQ_BT * p.gs_b;
  p.off_ce = p.off_e + XEQ_H2_EF;
  p.off_eh = p.off_ce + XEQ_H2_EF;
  p.off_ch = p.off_eh + XEQ_MAXY * XEQ_BT * 2;
  p.off_pos = p.off_ch + XEQ_MAXY * XEQ_BT * 2;
  p.stage = xeq_round_up(p.off_pos + 2 * XEQ_BT * 4, 128);
  // wf's live rows (mtw x XEQ_H2_WGS m64 tiles, zero past H), the dfw2
  // tiles (after them: d2ef's 64-row A reads 512 bytes past the last
  // tile), the per-warp harmonic sums, the pair table and the barriers
  const int fixed = p.mtw * XEQ_H2_WGS * 4096 + XEQ_H2_WGS * XEQ_H2_DFW +
                    XEQ_H2_CW * XEQ_BT * p.n_y * 4 + xeq_round_up(n_pt * 32 * 4, 16) +
                    2 * XEQ_H2_MAXST * 8;
  p.nst = (XEQ_SMEM_MAX - fixed) / p.stage;
  if (p.nst > XEQ_H2_MAXST) p.nst = XEQ_H2_MAXST;
  p.off_wf = p.nst * p.stage;
  p.off_dfw = p.off_wf + p.mtw * XEQ_H2_WGS * 4096;
  p.off_hs = p.off_dfw + XEQ_H2_WGS * XEQ_H2_DFW;
  p.off_tab = p.off_hs + XEQ_H2_CW * XEQ_BT * p.n_y * 4;
  p.off_bar = p.off_tab + xeq_round_up(n_pt * 32 * 4, 16);
  p.smem = p.off_bar + 2 * XEQ_H2_MAXST * 8;
  return kf <= XEQ_BT_KE && kw <= kf && p.n_y <= XEQ_MAXY && n_pt >= 1 && 32 * n_pt >= ni &&
         p.n_mt <= XEQ_H2_MT && p.nst >= 2 && 2 * ni + nd == h_dim && ni < 1024 &&
         d < 4096 && p.ht8 <= hp && p.dt8 <= dp && p.sd8 <= sdp && p.smem <= XEQ_SMEM_MAX;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ __nv_bfloat162 xeq_ld_pair(const xeq_bf16* a, const xeq_bf16* b,
                                                     int j) {
  return xeq_bf2(a[j], b[j]);
}

// N per-lane values summed over a warp's 8 row groups (lanes 4 gq + cq, gq
// = 0 .. 7) by recursive halving (the lanes with bit O keep the upper half
// of the 2 O values left, adding their partner's): lane gq ends with the
// sums of values (gq >> 2 & 1) N / 2 + (gq >> 1 & 1) N / 4 + (gq & 1) N / 8
// + k in v[k], k < N / 8.
template <int N, int O>
__device__ __forceinline__ void xeq_h2_halve(float (&v)[N]) {
  const bool up = threadIdx.x & O;
  constexpr int H = N * O / 32;  // values left after this step
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H], keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The elementwise step of a pair tile for one thread: irrep u (DIM lanes
// from j0) of its table entry e (-1: a padding row pair, which only takes
// part in the warp's sums), the warp's harmonic columns from y0, its four slots
// tt = 2 cq + 8 j + e (fr: [fw^T | r^T] of the tile in the accumulator
// layout, rows gq (u) and gq + 8 (ni + u)).  Returns dfw2 and dfwr as
// wgmma A fragments (a2, ar; zero on slots that add nothing), writes
// dfw2^T into the warpgroup's tile (dfw_b), the d2x and d2g rows in place,
// and adds the harmonic d2ef products, summed over the warp, into the
// warp's cells hs[slot][y].
template <int DIM>
__device__ __forceinline__ void xeq_h2_pair(const float (&fr)[16],
                                            uint32_t (&a2)[4], uint32_t (&ar)[4],
                                            unsigned char* st, const XeqH2Dims& p, int e,
                                            int y0, const bool (&va)[4], unsigned char* dfw_b,
                                            float* hs, int w, int gq, int cq) {
  constexpr int N = (2 * DIM + 7) / 8 * 8;  // a slot pair's harmonic products, padded
  const int u = e & 1023, j0 = (e >> 10) & 4095;
  const xeq_bf16* eh = reinterpret_cast<const xeq_bf16*>(st + p.off_eh) + y0 * XEQ_BT;
  const xeq_bf16* ch = reinterpret_cast<const xeq_bf16*>(st + p.off_ch) + y0 * XEQ_BT;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tt = 2 * cq + 8 * j;
    float hv[N];
#pragma unroll
    for (int k = 0; k < N; ++k) hv[k] = 0.f;
    if (e >= 0) {
      xeq_bf16* xa = reinterpret_cast<xeq_bf16*>(st + tt * p.xs_b);
      xeq_bf16* xb = reinterpret_cast<xeq_bf16*>(st + (tt + 1) * p.xs_b);
      const xeq_bf16* ca = reinterpret_cast<const xeq_bf16*>(st + p.off_cx + tt * p.xs_b);
      const xeq_bf16* cb = reinterpret_cast<const xeq_bf16*>(st + p.off_cx + (tt + 1) * p.xs_b);
      xeq_bf16* ga = reinterpret_cast<xeq_bf16*>(st + p.off_g + tt * p.gs_b) + p.sd8;
      xeq_bf16* gb = reinterpret_cast<xeq_bf16*>(st + p.off_g + (tt + 1) * p.gs_b) + p.sd8;
      const int nu = p.ni + u;
      const float2 fu = make_float2(fr[4 * j], fr[4 * j + 1]);
      const float2 fn = make_float2(fr[4 * j + 2], fr[4 * j + 3]);
      const float2 ru = make_float2(fr[8 + 4 * j], fr[8 + 4 * j + 1]);
      const float2 rn = make_float2(fr[8 + 4 * j + 2], fr[8 + 4 * j + 3]);
      const float2 gsu = make_float2(xeq_f(xa[u]), xeq_f(xb[u]));
      const float2 gsn = make_float2(xeq_f(xa[nu]), xeq_f(xb[nu]));
      const float2 chu = make_float2(xeq_f(ca[u]), xeq_f(cb[u]));
      const float2 chn = make_float2(xeq_f(ca[nu]), xeq_f(cb[nu]));
      // fo and a of both rows (f32 products and sums, one rounding)
      const float2 fou = xeq_rnd2(gsu.x * fu.x, gsu.y * fu.y);
      const float2 fon = xeq_rnd2(gsn.x * fn.x, gsn.y * fn.y);
      const __nv_bfloat162 au2 =
          __floats2bfloat162_rn(chu.x * fu.x + ru.x * gsu.x, chu.y * fu.y + ru.y * gsu.y);
      const __nv_bfloat162 an2 =
          __floats2bfloat162_rn(chn.x * fn.x + rn.x * gsn.x, chn.y * fn.y + rn.y * gsn.y);
      const float2 au = __bfloat1622float2(au2), an = __bfloat1622float2(an2);
      float2 du = make_float2(0.f, 0.f), dn = du, uu = du, un = du;
      xeq_bf16* xva = xa + p.ht8;
      xeq_bf16* xvb = xb + p.ht8;
      const xeq_bf16* cva = ca + p.ht8;
      const xeq_bf16* cvb = cb + p.ht8;
      // a lane's values are loaded before the lane before it stores its
      // outputs (in place), so that no load waits behind a store
      __nv_bfloat162 gm = xeq_ld_pair(ga, gb, j0), gv = xeq_ld_pair(xva, xvb, j0);
      __nv_bfloat162 cv = xeq_ld_pair(cva, cvb, j0);
      __nv_bfloat162 ey = *reinterpret_cast<const __nv_bfloat162*>(eh + tt);
      __nv_bfloat162 cy = *reinterpret_cast<const __nv_bfloat162*>(ch + tt);
#pragma unroll
      for (int m = 0; m < DIM; ++m) {
        const int jl = j0 + m;
        __nv_bfloat162 gm1 = gm, gv1 = gv, cv1 = cv, ey1 = ey, cy1 = cy;
        if (m + 1 < DIM) {
          gm1 = xeq_ld_pair(ga, gb, jl + 1);
          gv1 = xeq_ld_pair(xva, xvb, jl + 1);
          cv1 = xeq_ld_pair(cva, cvb, jl + 1);
          ey1 = *reinterpret_cast<const __nv_bfloat162*>(eh + (m + 1) * XEQ_BT + tt);
          cy1 = *reinterpret_cast<const __nv_bfloat162*>(ch + (m + 1) * XEQ_BT + tt);
        }
        // the gate sums' products, one bf16 product each
        const float2 p1 = __bfloat1622float2(__hmul2(gv, gm));
        const float2 p2 = __bfloat1622float2(__hmul2(ey, gm));
        const float2 p3 = __bfloat1622float2(__hmul2(cv, gm));
        const float2 p4 = __bfloat1622float2(__hmul2(cy, gm));
        du.x += p1.x; du.y += p1.y;
        dn.x += p2.x; dn.y += p2.y;
        uu.x += p3.x; uu.y += p3.y;
        un.x += p4.x; un.y += p4.y;
        // the d2x lane and the harmonic product, one bf16 product each
        const __nv_bfloat162 dxv = __hmul2(gm, au2);
        const float2 hr = __bfloat1622float2(__hmul2(gm, an2));
        hv[m] = hr.x;
        hv[DIM + m] = hr.y;
        // the d2g lane: a sum of four products, one rounding
        const float2 gvf = __bfloat1622float2(gv), eyf = __bfloat1622float2(ey);
        const float2 cvf = __bfloat1622float2(cv), cyf = __bfloat1622float2(cy);
        const __nv_bfloat162 dg = __floats2bfloat162_rn(
            gvf.x * au.x + eyf.x * an.x + cvf.x * fou.x + fon.x * cyf.x,
            gvf.y * au.y + eyf.y * an.y + cvf.y * fou.y + fon.y * cyf.y);
        // in place: the d2x row's lane over gv, the d2g row's over gms_v
        xva[jl] = dxv.x;
        xvb[jl] = dxv.y;
        ga[jl] = dg.x;
        gb[jl] = dg.y;
        gm = gm1, gv = gv1, cv = cv1, ey = ey1, cy = cy1;
      }
      // dfw2, dfwr and the hidden d2x column of both rows
      const bool v0 = va[2 * j], v1 = va[2 * j + 1];
      const float2 w2u = xeq_rnd2(du.x * chu.x + uu.x * gsu.x, du.y * chu.y + uu.y * gsu.y);
      const float2 w2n = xeq_rnd2(dn.x * chn.x + un.x * gsn.x, dn.y * chn.y + un.y * gsn.y);
      const __nv_bfloat162 xu =
          __floats2bfloat162_rn(du.x * ru.x + uu.x * fu.x, du.y * ru.y + uu.y * fu.y);
      const __nv_bfloat162 xn =
          __floats2bfloat162_rn(dn.x * rn.x + un.x * fn.x, dn.y * rn.y + un.y * fn.y);
      a2[2 * j] = xeq_pack(xeq_b(v0 ? w2u.x : 0.f), xeq_b(v1 ? w2u.y : 0.f));
      a2[2 * j + 1] = xeq_pack(xeq_b(v0 ? w2n.x : 0.f), xeq_b(v1 ? w2n.y : 0.f));
      ar[2 * j] = xeq_pack(xeq_b(v0 ? du.x * gsu.x : 0.f), xeq_b(v1 ? du.y * gsu.y : 0.f));
      ar[2 * j + 1] = xeq_pack(xeq_b(v0 ? dn.x * gsn.x : 0.f), xeq_b(v1 ? dn.y * gsn.y : 0.f));
      // dfw2^T as d2ef's B (N = slot contiguous), rows gq (u) and gq + 8
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(dfw_b + (tt & 7) * 2 + j * 128 + gq * 16 +
                                     (2 * w + r) * 256) = a2[2 * j + r];
      xa[u] = xu.x;
      xb[u] = xu.y;
      xa[nu] = xn.x;
      xb[nu] = xn.y;
    }
    // the slot pair's harmonic products of the warp's 8 irreps (one l)
    // summed per slot and column, then into the warp's cells
    xeq_h2_halve<N, 16>(hv);
    xeq_h2_halve<N, 8>(hv);
    xeq_h2_halve<N, 4>(hv);
#pragma unroll
    for (int k = 0; k < N / 8; ++k) {
      const int idx =
          ((gq >> 2) & 1) * (N / 2) + ((gq >> 1) & 1) * (N / 4) + (gq & 1) * (N / 8) + k;
      if (idx < 2 * DIM) {
        const int s2 = idx / DIM, m = idx - s2 * DIM;
        hs[(tt + s2) * p.n_y + y0 + m] += hv[k];
      }
    }
  }
}

// The elementwise step of a scalar tile for one thread: rows gq and gq + 8
// (node_dim columns c, at 2 ni + c, or padding) for its four slots, with
// dfo = gms_s[c] and u = 0.  a goes in place of gms_s (the d2g row's
// node_dim part), the hidden d2x column in place of gs.
__device__ __forceinline__ void xeq_h2_scalar(const float (&fr)[16],
                                              uint32_t (&a2)[4], uint32_t (&ar)[4],
                                              unsigned char* st, const XeqH2Dims& p, int c0,
                                              const bool (&va)[4], unsigned char* dfw_b, int w,
                                              int gq, int cq) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tt = 2 * cq + 8 * j;
    xeq_bf16* xa = reinterpret_cast<xeq_bf16*>(st + tt * p.xs_b);
    xeq_bf16* xb = reinterpret_cast<xeq_bf16*>(st + (tt + 1) * p.xs_b);
    const xeq_bf16* ca = reinterpret_cast<const xeq_bf16*>(st + p.off_cx + tt * p.xs_b);
    const xeq_bf16* cb = reinterpret_cast<const xeq_bf16*>(st + p.off_cx + (tt + 1) * p.xs_b);
    xeq_bf16* ga = reinterpret_cast<xeq_bf16*>(st + p.off_g + tt * p.gs_b);
    xeq_bf16* gb = reinterpret_cast<xeq_bf16*>(st + p.off_g + (tt + 1) * p.gs_b);
    const bool v0 = va[2 * j], v1 = va[2 * j + 1];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = c0 + 8 * r, h = 2 * p.ni + c;
      float2 w2 = make_float2(0.f, 0.f), wr = w2;
      if (c < p.nd) {
        const float2 f = make_float2(fr[4 * j + 2 * r], fr[4 * j + 2 * r + 1]);
        const float2 rr = make_float2(fr[8 + 4 * j + 2 * r], fr[8 + 4 * j + 2 * r + 1]);
        const float2 gs = make_float2(xeq_f(xa[h]), xeq_f(xb[h]));
        const float2 chh = make_float2(xeq_f(ca[h]), xeq_f(cb[h]));
        const float2 dfo = make_float2(xeq_f(ga[c]), xeq_f(gb[c]));
        const __nv_bfloat162 a =
            __floats2bfloat162_rn(chh.x * f.x + rr.x * gs.x, chh.y * f.y + rr.y * gs.y);
        const __nv_bfloat162 dx = __floats2bfloat162_rn(dfo.x * rr.x, dfo.y * rr.y);
        w2 = xeq_rnd2(dfo.x * chh.x, dfo.y * chh.y);
        wr = make_float2(dfo.x * gs.x, dfo.y * gs.y);
        ga[c] = a.x;
        gb[c] = a.y;
        xa[h] = dx.x;
        xb[h] = dx.y;
      }
      a2[2 * j + r] = xeq_pack(xeq_b(v0 ? w2.x : 0.f), xeq_b(v1 ? w2.y : 0.f));
      ar[2 * j + r] = xeq_pack(xeq_b(v0 ? wr.x : 0.f), xeq_b(v1 ? wr.y : 0.f));
      *reinterpret_cast<uint32_t*>(dfw_b + (tt & 7) * 2 + j * 128 + gq * 16 + (2 * w + r) * 256) =
          a2[2 * j + r];
    }
  }
}

#define XEQ_H2_PARAMS                                                                         \
  const xeq_bf16 *__restrict__ x, const xeq_bf16 *__restrict__ ef,                          \
      const xeq_bf16 *__restrict__ wf, const xeq_bf16 *__restrict__ g,                      \
      const xeq_bf16 *__restrict__ cx, const xeq_bf16 *__restrict__ cef,                    \
      const int *__restrict__ slot_src, const int *__restrict__ slot_dst,                   \
      const int *__restrict__ src_pos, const int *__restrict__ dst_pos,                     \
      const int *__restrict__ tab, xeq_bf16 *__restrict__ rows_x,                           \
      xeq_bf16 *__restrict__ rows_g, float *__restrict__ d2ef, float *__restrict__ dwf_part, \
      const XeqH2Dims p, long long *__restrict__ stamps
#define XEQ_H2_ARGS                                                                          \
  x, ef, wf, g, cx, cef, slot_src, slot_dst, src_pos, dst_pos, tab, rows_x, rows_g, d2ef,   \
      dwf_part, p, stamps

// The body of the pass.  STAMP: the phase probe's instance
// (xeq_bwd2_phases): thread 0 of each consumer warpgroup and lane 0 of the
// producer add the clock64() cycles of their phases, written to
// stamps[(block * (XEQ_H2_WGS + 1) + role) * XEQ_STAMPS] (role: the
// consumer warpgroups 0 to XEQ_H2_WGS - 1, then the producer).
template <bool STAMP>
__device__ __forceinline__ void xeq_h2_body(XEQ_H2_PARAMS) {
  extern __shared__ __align__(128) unsigned char h2_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(h2_smem + p.off_bar);
  uint64_t* empty = full + XEQ_H2_MAXST;
  int* tab_s = reinterpret_cast<int*>(h2_smem + p.off_tab);
  unsigned char* wf_s = h2_smem + p.off_wf;
  float* hs_all = reinterpret_cast<float*>(h2_smem + p.off_hs);  // [12 warps][16][n_y]
  // the warp index through a shuffle, so that the compiler knows it (and
  // every role and m64 tile derived from it) the same on the warp's lanes:
  // a wgmma on a path it takes for divergent is serialized
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int n_tiles = (p.n_slots + XEQ_BT - 1) / XEQ_BT, grid = gridDim.x;
  XeqStamps<STAMP> sp;

  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      xeq_mbar_init(full + s, 1);
      xeq_mbar_init(empty + s, XEQ_H2_CT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < 32 * p.n_pt; i += XEQ_H2_THREADS) tab_s[i] = __ldg(tab + i);
  __syncthreads();
  // wf's live rows in the pass's row order and the core-matrix layout
  xeq_load_wf_pairs(wf_s, wf, tab_s, p.mtw * XEQ_H2_WGS, p.n_mt, p.n_pt, p.ni, p.nd, p.kw, p.hp,
                    XEQ_H2_THREADS);
  for (int i = tid; i < XEQ_H2_CW * XEQ_BT * p.n_y; i += XEQ_H2_THREADS) hs_all[i] = 0.f;
  xeq_fence_async();
  __syncthreads();
  sp.mark(0);

  if (warp == XEQ_H2_CW) {
    // ---- the producer warp: lane t issues the bulk copies of slot t's x,
    // cx and g rows, lane 16 + t stores its edge-feature columns; before a
    // stage is refilled, lane t stores the scratch rows that the consumers
    // left in it for slot t of its last tile (d2x over the x row, d2g over
    // the g row, one bulk copy each), and the tile's d2ef columns past Kf
    // are zeros from lanes t and 16 + t
    const int t = lane & 15;
    auto store_rows = [&](unsigned char* st) {
      if (lane < 16) {
        const int px = reinterpret_cast<const int*>(st + p.off_pos)[t];
        const int pg = reinterpret_cast<const int*>(st + p.off_pos)[XEQ_BT + t];
        if (px >= 0)
          xeq_bulk_s2g(rows_x + (int64_t)px * (p.ht8 + p.dt8), st + t * p.xs_b, p.x_bytes);
        if (pg >= 0)
          xeq_bulk_s2g(rows_g + (int64_t)pg * (p.sd8 + p.dt8), st + p.off_g + t * p.gs_b,
                       p.g_bytes);
        xeq_bulk_commit();
      }
    };
    int it = 0;
    for (;; ++it) {
      const int tl = blockIdx.x + it * grid;
      if (tl >= n_tiles) break;
      const int s = it % p.nst, k = tl * XEQ_BT + t;
      int dst = -1, src = 0, px = -1, pg = -1;
      if (k < p.n_slots) dst = __ldg(slot_dst + k);
      if (dst >= 0) {
        src = __ldg(slot_src + k);
        px = __ldg(src_pos + k);
        pg = __ldg(dst_pos + k);
      }
      const bool ok = dst >= 0;
      // lanes 16 + t: slot t's 32 columns of ef and of cef (zeros where it
      // adds nothing), loaded before the wait for the stage
      uint4 ev[4], cv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ev[q] = cv[q] = make_uint4(0u, 0u, 0u, 0u);
        if (lane >= 16 && ok) {
          ev[q] = __ldg(reinterpret_cast<const uint4*>(ef + (int64_t)k * XEQ_FPACK) + q);
          cv[q] = __ldg(reinterpret_cast<const uint4*>(cef + (int64_t)k * XEQ_FPACK) + q);
        }
      }
      if (k < p.n_slots) {  // d2ef past Kf: scalars to a float4 boundary, then float4s
        float* row = d2ef + (int64_t)k * XEQ_FPACK;
        const int f4 = (p.kf + 3) & ~3, h0 = lane >> 4;
        for (int f = p.kf + h0; f < f4; f += 2) row[f] = 0.f;
        for (int f = f4 + 4 * h0; f < XEQ_FPACK; f += 8)
          *reinterpret_cast<float4*>(row + f) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const unsigned n_ok = __popc(__ballot_sync(0xffffffffu, ok) & 0xffffu);
      sp.mark(2);
      xeq_mbar_wait(empty + s, ((it / p.nst) & 1) ^ 1);
      sp.mark(1);
      unsigned char* st = h2_smem + s * p.stage;
      if (it >= p.nst) {  // the stage's last tile: its rows leave first
        store_rows(st);
        if (lane < 16) xeq_bulk_wait_read();
        __syncwarp();
      }
      if (lane < 16) {
        reinterpret_cast<int*>(st + p.off_pos)[t] = px;
        reinterpret_cast<int*>(st + p.off_pos)[XEQ_BT + t] = pg;
      } else {
        const int ro = (t >> 3) * 512 + (t & 7) * 16;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          *reinterpret_cast<uint4*>(st + p.off_e + ro + q * 128) = ev[q];
          *reinterpret_cast<uint4*>(st + p.off_ce + ro + q * 128) = cv[q];
        }
        // the harmonic columns, slot-contiguous (read back: their place in
        // the registers depends on Kw)
        for (int y = 0; y < p.n_y; ++y) {
          const int o = xeq_hb_ef_off(t, p.kw + y);
          reinterpret_cast<xeq_bf16*>(st + p.off_eh)[y * XEQ_BT + t] =
              *reinterpret_cast<const xeq_bf16*>(st + p.off_e + o);
          reinterpret_cast<xeq_bf16*>(st + p.off_ch)[y * XEQ_BT + t] =
              *reinterpret_cast<const xeq_bf16*>(st + p.off_ce + o);
        }
      }
      xeq_fence_async();  // the columns reach the async proxy (wgmma)
      __syncwarp();
      if (lane == 0) xeq_mbar_arrive_tx(full + s, n_ok * (2 * p.x_bytes + p.g_bytes));
      __syncwarp();
      if (ok && lane < 16) {
        const int64_t xo = (int64_t)src * (p.hp + p.dp);
        const xeq_bf16* gr = g + (int64_t)dst * (p.sdp + p.dp);
        unsigned char* xs = st + t * p.xs_b;
        unsigned char* cs = st + p.off_cx + t * p.xs_b;
        unsigned char* gs = st + p.off_g + t * p.gs_b;
        xeq_bulk_g2s(xs, x + xo, p.ht8 * 2, full + s);
        xeq_bulk_g2s(xs + p.ht8 * 2, x + xo + p.hp, p.dt8 * 2, full + s);
        xeq_bulk_g2s(cs, cx + xo, p.ht8 * 2, full + s);
        xeq_bulk_g2s(cs + p.ht8 * 2, cx + xo + p.hp, p.dt8 * 2, full + s);
        if (p.sd8 == p.sdp) {
          xeq_bulk_g2s(gs, gr, p.g_bytes, full + s);
        } else {
          xeq_bulk_g2s(gs, gr, p.sd8 * 2, full + s);
          xeq_bulk_g2s(gs + p.sd8 * 2, gr + p.sdp, p.dt8 * 2, full + s);
        }
      }
      sp.mark(3);
    }
    // the last tiles' rows, each once the consumers have released its stage
    for (int j = it - p.nst < 0 ? 0 : it - p.nst; j < it; ++j) {
      xeq_mbar_wait(empty + j % p.nst, (j / p.nst) & 1);
      store_rows(h2_smem + (j % p.nst) * p.stage);
    }
    if (lane < 16) xeq_bulk_wait();
    sp.mark(7);
    if (STAMP && lane == 0)
      sp.write(stamps + ((int64_t)blockIdx.x * (XEQ_H2_WGS + 1) + XEQ_H2_WGS) * XEQ_STAMPS);
    return;
  }

  // ---- consumer warpgroup wg: warp w, fragment row group gq, column pair
  // cq; the thread's slots 2 cq + 8 j + e
  const int wg = warp >> 2, w = warp & 3, gq = lane >> 2, cq = lane & 3, wt = tid & 127;
  unsigned char* dfw_b = h2_smem + p.off_dfw + wg * XEQ_H2_DFW;
  float* hs = hs_all + warp * XEQ_BT * p.n_y;  // this warp's cells
  // d2wf^T of the warpgroup's m64 tiles, f32: set by the block's first
  // tile's products, added to by the others (no instruction but a wgmma
  // defines a wgmma's accumulators, or the compiler serializes them)
  float acc[XEQ_H2_MTW][16];

  for (int it = 0;; ++it) {
    const int tl = blockIdx.x + it * grid;
    if (tl >= n_tiles) break;
    const int s = it % p.nst, k0 = tl * XEQ_BT;
    xeq_mbar_wait(full + s, (it / p.nst) & 1);
    sp.mark(1);
    unsigned char* st = h2_smem + s * p.stage;
    const int* pos_s = reinterpret_cast<const int*>(st + p.off_pos);
    bool va[4];  // the thread's slots: valid (a position by source)
#pragma unroll
    for (int q = 0; q < 4; ++q) va[q] = pos_s[2 * cq + (q & 1) + 8 * (q >> 1)] >= 0;
    // [ef | cef]^T as [fw | r]'s B (K = f, N = 16 slots of ef, then of cef)
    const uint64_t e_k = xeq_desc(st + p.off_e, 128, 512);
    const uint64_t e_n = xeq_desc(st + p.off_e, 512, 128);   // ef as d2wf's B (K = slot)
    const uint64_t c_n = xeq_desc(st + p.off_ce, 512, 128);  // cef as d2wf's B

    float def[8];  // d2ef^T [64 f x 16 slots] over the warpgroup's m64 tiles
    float fr[16];  // [fw^T | r^T] of the current m64 tile (the first k16 step sets it)
    xeq_wg_fence();
    xeq_wg_regs(fr);
    xeq_wgmma_n32<1, 0>(fr, xeq_desc(wf_s + wg * 4096, 128, 512), e_k, 0);
    xeq_wgmma_n32<1, 0>(fr, xeq_desc(wf_s + wg * 4096 + 256, 128, 512), e_k + (256 >> 4));
    xeq_wg_commit();

    // the walk over the warpgroup's m64 tiles has the same length on every
    // warpgroup (mtw, a kernel parameter; past n_mt wf_s's zero rows make
    // every product zero), so that no wgmma sits on a path the compiler
    // takes for divergent (it would serialize them)
#pragma unroll 1
    for (int ii = 0; ii < p.mtw; ++ii) {
      const int i = XEQ_H2_WGS * ii + wg;  // the m64 tile (the same on the warpgroup's warps)
      xeq_wg_wait();
      xeq_wg_regs(fr);
      xeq_wg_regs(def);
      xeq_wg_regs(acc[0]);
      xeq_wg_regs(acc[1]);
      xeq_wg_regs(acc[2]);
      sp.mark(2);
      uint32_t a2[4], ar[4];
      if (i < p.n_pt) {
        // the warp's 8 irreps share one l and harmonic block (the table's
        // groups; entries of -1 pad a group, and a padding lane takes part
        // in the warp's sums with zeros)
        const int e = tab_s[32 * i + 8 * w + gq];
        int ew = -1;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          const int eo = __shfl_sync(0xffffffffu, e, 4 * o);
          if (ew < 0) ew = eo;
        }
        const int lw = ew < 0 ? -1 : (ew >> 22) & 3, y0 = (ew >> 24) & 15;
        if (e < 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) a2[q] = ar[q] = 0u;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              *reinterpret_cast<uint32_t*>(dfw_b + (2 * cq) * 2 + j * 128 + gq * 16 +
                                           (2 * w + r) * 256) = 0u;
        }
        if (lw == 0)
          xeq_h2_pair<1>(fr, a2, ar, st, p, e, y0, va, dfw_b, hs, w, gq, cq);
        else if (lw == 1)
          xeq_h2_pair<3>(fr, a2, ar, st, p, e, y0, va, dfw_b, hs, w, gq, cq);
        else if (lw == 2)
          xeq_h2_pair<5>(fr, a2, ar, st, p, e, y0, va, dfw_b, hs, w, gq, cq);
      } else {
        xeq_h2_scalar(fr, a2, ar, st, p, 64 * (i - p.n_pt) + 16 * w + gq, va, dfw_b, w, gq,
                      cq);
      }
      xeq_fence_async();
      xeq_bar_sync(1 + wg, 128);  // the dfw2 tile is whole
      sp.mark(3);

      // d2wf^T += dfw2^T . ef + dfwr^T . cef (A from registers); d2ef^T +=
      // wf_s . dfw2^T over this tile's 64 h in four k16 steps; fw^T and r^T
      // of the next m64 tile
      const bool next = ii + 1 < p.mtw;
      xeq_wg_fence();
      const int add = it > 0;  // 0: the block's first tile sets acc
      if (ii == 0) {
        xeq_wgmma_n32_rs<1>(acc[0], a2, e_n, add);
        xeq_wgmma_n32_rs<1>(acc[0], ar, c_n);
      } else if (ii == 1) {
        xeq_wgmma_n32_rs<1>(acc[1], a2, e_n, add);
        xeq_wgmma_n32_rs<1>(acc[1], ar, c_n);
      } else {
        xeq_wgmma_n32_rs<1>(acc[2], a2, e_n, add);
        xeq_wgmma_n32_rs<1>(acc[2], ar, c_n);
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)  // the tile's first step sets def
        xeq_wgmma_n16<0, 1>(def, xeq_desc(wf_s + (8 * i + 2 * ks) * 512, 512, 128),
                            xeq_desc(dfw_b + ks * 512, 256, 128), ii > 0 || ks > 0);
      if (next) {
        const unsigned char* an = wf_s + (i + XEQ_H2_WGS) * 4096;
        xeq_wgmma_n32<1, 0>(fr, xeq_desc(an, 128, 512), e_k, 0);
        xeq_wgmma_n32<1, 0>(fr, xeq_desc(an + 256, 128, 512), e_k + (256 >> 4));
      }
      xeq_wg_commit();
      sp.mark(4);
    }
    xeq_wg_wait();
    xeq_wg_regs(fr);
    xeq_wg_regs(def);
    xeq_wg_regs(acc[0]);
    xeq_wg_regs(acc[1]);
    xeq_wg_regs(acc[2]);
    sp.mark(5);

    // the tile's rows are whole and the cx rows dead: the warpgroups'
    // d2ef partials go over them; the harmonic d2ef columns (the 12 warps'
    // cells in order); the producer stores the rows once the stage is
    // released
    xeq_fence_async();
    xeq_bar_sync(XEQ_H2_WGS + 1, XEQ_H2_CT);
    // (the tile's end falls to the warpgroups past the first, whose m64
    // tiles hold fewer lanes: the table gives warpgroup 0 the l = 2 run)
    float* red = reinterpret_cast<float*>(st + p.off_cx);  // [WGS - 1][64][8]
    if (wg < XEQ_H2_WGS - 1 && w < 2) {
#pragma unroll
      for (int q = 0; q < 8; ++q) red[(wg * 64 + wt) * 8 + q] = def[q];
    }
    for (int c = tid - 128; c >= 0 && c < XEQ_BT * p.n_y; c += XEQ_H2_CT - 128) {
      const int t = c / p.n_y, y = c - t * p.n_y, k = k0 + t;
      float v = 0.f;
      for (int o = 0; o < XEQ_H2_CW; ++o) v += hs_all[(o * XEQ_BT + t) * p.n_y + y];
      if (k < p.n_slots) d2ef[(int64_t)k * XEQ_FPACK + p.kw + y] = pos_s[t] >= 0 ? v : 0.f;
    }
    // padding columns of the rows (H .. ht8, D .. dt8, node_dim .. sd8):
    // zeros, whatever was staged there
    if (p.ht8 != p.h || p.dt8 != p.d || p.sd8 != p.nd) {
      for (int c = tid; c < XEQ_BT * 8; c += XEQ_H2_CT) {
        const int t = c >> 3, q = c & 7;
        xeq_bf16* xr = reinterpret_cast<xeq_bf16*>(st + t * p.xs_b);
        xeq_bf16* gr = reinterpret_cast<xeq_bf16*>(st + p.off_g + t * p.gs_b);
        if (p.h + q < p.ht8) xr[p.h + q] = xeq_b(0.f);
        if (p.d + q < p.dt8) {
          xr[p.ht8 + p.d + q] = xeq_b(0.f);
          gr[p.sd8 + p.d + q] = xeq_b(0.f);
        }
        if (p.nd + q < p.sd8) gr[p.nd + q] = xeq_b(0.f);
      }
      xeq_fence_async();
    }
    xeq_bar_sync(XEQ_H2_WGS + 1, XEQ_H2_CT);  // partials written, cells read
    sp.mark(6);
    // d2ef's filter columns (the warpgroups' partials in order, the last
    // warpgroup's from its registers): rows f = 16 w + gq + 8 r < Kw (warps
    // 0, 1)
    if (wg == XEQ_H2_WGS - 1 && w < 2) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int f = 16 * w + gq + 8 * ((q >> 1) & 1);
        const int t = 8 * (q >> 2) + 2 * cq + (q & 1), k = k0 + t;
        if (f < p.kw && k < p.n_slots) {
          float v = red[wt * 8 + q];
#pragma unroll
          for (int o = 1; o < XEQ_H2_WGS - 1; ++o) v += red[(o * 64 + wt) * 8 + q];
          v += def[q];
          d2ef[(int64_t)k * XEQ_FPACK + f] = pos_s[t] >= 0 ? v : 0.f;
        }
      }
    }
    // the next tile's cells start from zero (read above, before the
    // barrier)
    for (int c = lane; c < XEQ_BT * p.n_y; c += 32) hs[c] = 0.f;
    __syncwarp();
    xeq_mbar_arrive(empty + s);  // the rows are the producer's to store
    sp.mark(7);
  }

  // the block's d2wf partial [kf, h]: each warpgroup its m64 tiles, rows
  // back in H's order
  float* part = dwf_part + (int64_t)blockIdx.x * p.kf * p.h;
  const bool has_tiles = (int)blockIdx.x < n_tiles;  // else acc was never set
#pragma unroll
  for (int ii = 0; ii < XEQ_H2_MTW; ++ii) {
    const int i = XEQ_H2_WGS * ii + wg;
    if (i >= p.n_mt) break;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int rho = 16 * w + gq + 8 * ((q >> 1) & 1);
      const int f = 8 * (q >> 2) + 2 * cq + (q & 1);
      const int h = xeq_pair_col(i, rho, tab_s, p.n_pt, p.ni, p.nd);
      if (f < p.kf && h >= 0) part[(int64_t)f * p.h + h] = has_tiles ? acc[ii][q] : 0.f;
    }
  }
  sp.mark(0);
  if (STAMP && wt == 0)
    sp.write(stamps + ((int64_t)blockIdx.x * (XEQ_H2_WGS + 1) + wg) * XEQ_STAMPS);
}

template <bool STAMP>
__global__ void __launch_bounds__(XEQ_H2_THREADS, 1) message_bwd2_hopper_kernel(XEQ_H2_PARAMS) {
  xeq_h2_body<STAMP>(XEQ_H2_ARGS);
}

// Launch the pass with its layout (``stamps``: the phase probe's instance).
static int launch_bwd2_hopper(const void* x, const void* ef, const void* wf, const void* g,
                              const void* cx, const void* cef, const void* slot_src,
                              const void* slot_dst, const void* src_pos, const void* dst_pos,
                              const void* tab, void* rows_x, void* rows_g, void* d2ef,
                              void* dwf_part, const XeqH2Dims& p, int n_part, long long* stamps,
                              cudaStream_t s) {
  auto kernel = stamps ? message_bwd2_hopper_kernel<true> : message_bwd2_hopper_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, XEQ_H2_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const xeq_bf16*)cx, (const xeq_bf16*)cef, (const int*)slot_src, (const int*)slot_dst,
      (const int*)src_pos, (const int*)dst_pos, (const int*)tab, (xeq_bf16*)rows_x,
      (xeq_bf16*)rows_g, (float*)d2ef, (float*)dwf_part, p, stamps);
  return (int)cudaGetLastError();
}
