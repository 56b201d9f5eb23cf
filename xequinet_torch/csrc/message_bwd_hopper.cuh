// The first-order message backward's bf16 tile pass redesigned for Hopper:
// message_bwd.cu's pass at the widths of ops/fused_message.py::
// hopper_route (the flagship's: bf16, Kf <= 32, H <= 576, runs of irreps of
// one l of even multiplicity); bwd_stream_floor.cu runs the same streams
// with a near-empty body.  On those widths it replaces the mma.sync tile
// pass of message_bwd.cu (per-warp cp.async staging in 16-byte chunks,
// mma.sync with per-warp fragment loads, four block-wide barriers per
// tile), whose stream floor read "body" (the streams and the tensor-core
// ideal 27% of its time).
//
// Block: XEQ_HB_WGS = 3 consumer warpgroups and a producer warp (416
// threads, one block per SM, persistent: tile = block + i * grid, 16 slots
// a tile).
//  * The producer warp stages each tile into a ring of ``nst`` stages (as
//    many as the shared memory holds beside the rest: 2 at the flagship
//    widths, 54.9 KB a stage) with a full and an empty mbarrier each: lane
//    t issues the cp.async.bulk copies (global -> shared, completion
//    counted in bytes on the full barrier) of slot t's x row as [gs | gv]
//    (two copies) and g row as [gms_s | gms_v] (one where node_dim is a
//    multiple of 8, else two); lane 16 + t loads the slot's 32
//    edge-feature columns (64 bytes) before the wait for the stage and
//    stores them into wgmma's core-matrix layout (16-byte bulk copies cost
//    the copy engine more than they move).  Bulk copies do not zero-fill:
//    padding slots (dst2 == BN) and slots past the covered range are not
//    copied; their edge-feature columns are stored as zeros and their
//    scratch position as -1, and the consumers give them zero
//    contributions and zero d_ef rows (pallas_message.py:547-552).
//  * Every consumer warpgroup takes every tile; warpgroup wg owns the m64
//    tiles i = wg, wg + 3, ... of H (three at H = 576) and their d_wf
//    accumulators, 48 f32 a thread (a warpgroup's whole H would take 144,
//    past the 168 registers a thread that 13 warps leave).  Per tile:
//      A  dfo's gate sums, per irrep segment (a run of irreps of one l, so
//         that the lane counts and harmonic columns are constants), two
//         slots a warp side by side (a half-warp per slot on runs of 16
//         irrep pairs or fewer), the rounded products of lane pairs as
//         __hmul2 on bf16x2, into the tile's dfo rows (f32, shared);
//         one barrier of the 384 consumer threads;
//      per m64 tile: fw^T = wf_live^T . ef^T (wgmma m64n16k16, K = 32),
//         then per element of its accumulator fragment (2 h x 4 slots a
//         thread) dfw, dgs (to the tile's dgs rows) and fo (in place of
//         gs, which nothing reads after it); the warpgroup's named barrier;
//         d_wf^T += dfw^T . ef (m64n32k16, A = dfw^T from registers in
//         fw's accumulator layout) and d_ef^T += wf_live . dfw^T (m64n16k16,
//         M = 32 real rows of 64 read, K = the tile's 64 h), issued with
//         the next m64 tile's fw (one wait per m64 tile);
//      the other warpgroups' d_ef partials to shared memory, one barrier of
//         the consumers;
//      C  dgv (in place of gv, which nothing reads after A) and drsh as
//         __hmul2 on lane pairs, per segment, two slots a warp as in A; drsh summed
//         in f32 per harmonic column in lane order, then over the warp by
//         recursive halving; each valid slot's scratch row [dgs | dgv]
//         leaves as two cp.async.bulk stores; d_ef's filter columns are
//         warpgroup 0's partial plus the others' in order.
//    No block-wide barrier of all threads runs per tile: the producer
//    never waits for the consumers' compute except through the ring.
//  * wgmma reads shared memory in the no-swizzle core-matrix layout (8
//    rows of 16 bytes).  wf's live rows are written once per block so that
//    one copy serves as fw's A (transposed) and as d_ef's A: element (f, h)
//    at (h/8) * 512 + (f/8) * 128 + (f%8) * 16 + (h%8) * 2 bytes; a stage's
//    edge-feature columns, (t, f) at (t/8) * 512 + (f/8) * 128 + (t%8) * 16
//    + (f%8) * 2, are fw's B (K-major) and d_wf's B (N-major).  The
//    contractions are ~110 kFLOP a slot, 0.015 ms at the flagship batch on
//    the tensor cores: what wgmma buys is issue slots, one asynchronous
//    instruction per warpgroup for what took per-warp fragment loads.
//
// A product of two bf16 values is exact in f32, so one bf16 rounding by
// __hmul2 gives the bits of the TPU kernel's f32-then-round (also below
// f32's normal range: tests/test_torch_gpu.py holds both on the card).
// No float atomics: d_wf as per-block partials (each warpgroup its m64
// tiles) summed by xeq_dwf_reduce_kernel in block order; d_ef's filter
// columns are each wgmma's own sum over its 64 h, then the warpgroups'
// partials in order.  Results repeat bit for bit.  Rounding mirrors
// _bwd_kernel (:411-433): fo, dgv, drsh, dgs and dfw are rounded to bf16;
// sums are f32.
#pragma once

#include "hopper_ptx.cuh"

#define XEQ_HB_WGS 3                          // consumer warpgroups
#define XEQ_HB_THREADS (128 * XEQ_HB_WGS + 32)  // and the producer warp
#define XEQ_HB_CW (4 * XEQ_HB_WGS)            // consumer warps
#define XEQ_HB_MT 9                           // m64 tiles of H: H <= 576
#define XEQ_HB_MTW ((XEQ_HB_MT + XEQ_HB_WGS - 1) / XEQ_HB_WGS)  // of them a warpgroup's
#define XEQ_HB_MAXST 4                        // ring stages at most
#define XEQ_HB_SEGS 8                         // irrep segments at most
#define XEQ_HB_EF 1024                        // a stage's 16 x 32 ef columns
#define XEQ_HB_DFW 2048                       // a dfw tile: 64 h x 16 slots

// ---------------------------------------------------------------------------
// Sizes and shared-memory layout, from the host
// ---------------------------------------------------------------------------
struct XeqHopperDims {
  int n_slots, ni, h, hp, d, dp, sdp, kw, kf, n_seg;
  int n_mt;            // m64 tiles of H
  int mtw;             // m64 tiles a warpgroup walks: n_mt over XEQ_HB_WGS, rounded up
                       // (wf_s holds mtw * XEQ_HB_WGS of them, zero past H)
  int ht8, dt8, sd8, rs;
  int xs_b, gs_b;      // staged row strides (bytes): [gs | gv] and [gms_s | gms_v],
                       // + 16 so that four rows two slots apart hit other banks
  int x_bytes, g_bytes;  // bytes copied per valid slot (and 64 of ef)
  int off_g, off_e, off_pos, stage;  // within a stage (bytes); stage size
  int nst;             // ring stages
  int dfo_st;          // dfo_s row (f32): 2 ni to 16, + 4 (conflict-free pairs of rows)
  int dgs_st;          // dgs_s row (bf16): ht8 + 8
  int off_wf, off_dfw, off_red, off_dfo, off_dgs, off_bar, off_gtab, off_seg, smem;
};

// The layout, ``nst`` as large as the shared memory allows (at most
// XEQ_HB_MAXST); false where the widths are not the kernel's (Kf <= 32, H
// <= 576, fewer than two stages fit).  ops/fused_message.py::
// _hopper_layout states the same sizes.
static bool bwd_hopper_dims(XeqHopperDims& p, int n_slots, int ni, int h_dim, int hp, int d,
                            int dp, int sdp, int kw, int kf, int n_seg) {
  p.n_slots = n_slots; p.ni = ni; p.h = h_dim; p.hp = hp; p.d = d; p.dp = dp;
  p.sdp = sdp; p.kw = kw; p.kf = kf; p.n_seg = n_seg;
  p.n_mt = (h_dim + 63) / 64;
  p.mtw = (p.n_mt + XEQ_HB_WGS - 1) / XEQ_HB_WGS;
  p.ht8 = xeq_round_up(h_dim, 8);
  p.dt8 = xeq_round_up(d, 8);
  p.sd8 = xeq_round_up(h_dim - 2 * ni, 8);
  p.rs = p.ht8 + p.dt8;
  p.x_bytes = p.rs * 2;
  p.g_bytes = (p.sd8 + p.dt8) * 2;
  p.xs_b = p.x_bytes + 16;
  p.gs_b = p.g_bytes + 16;
  p.off_g = XEQ_BT * p.xs_b;
  p.off_e = p.off_g + XEQ_BT * p.gs_b;
  p.off_pos = p.off_e + XEQ_HB_EF;
  p.stage = xeq_round_up(p.off_pos + XEQ_BT * 4, 128);
  // wf's live rows: mtw x XEQ_HB_WGS m64 tiles of 8 h-blocks of 4
  // f-blocks; the dfw tiles follow them (and take the 512 bytes past them
  // that d_ef's 64-row A reads)
  p.dfo_st = xeq_round_up(2 * ni, 16) + 4;
  p.dgs_st = p.ht8 + 8;
  const int fixed = p.mtw * XEQ_HB_WGS * 4096 + XEQ_HB_WGS * 2 * XEQ_HB_DFW +
                    2 * (XEQ_HB_WGS - 1) * 128 * 8 * 4 +
                    XEQ_BT * p.dfo_st * 4 + XEQ_BT * p.dgs_st * 2 + 2 * XEQ_HB_MAXST * 8 +
                    xeq_round_up(ni * 4, 16) +
                    XEQ_HB_SEGS * 16;
  p.nst = (XEQ_SMEM_MAX - fixed) / p.stage;
  if (p.nst > XEQ_HB_MAXST) p.nst = XEQ_HB_MAXST;
  p.off_wf = p.nst * p.stage;
  p.off_dfw = p.off_wf + p.mtw * XEQ_HB_WGS * 4096;
  p.off_red = p.off_dfw + XEQ_HB_WGS * 2 * XEQ_HB_DFW;
  p.off_dfo = p.off_red + 2 * (XEQ_HB_WGS - 1) * 128 * 8 * 4;
  p.off_dgs = p.off_dfo + XEQ_BT * p.dfo_st * 4;
  p.off_bar = p.off_dgs + XEQ_BT * p.dgs_st * 2;
  p.off_gtab = p.off_bar + 2 * XEQ_HB_MAXST * 8;
  p.off_seg = p.off_gtab + xeq_round_up(ni * 4, 16);
  p.smem = p.off_seg + XEQ_HB_SEGS * 16;
  return kf <= XEQ_BT_KE && kw <= kf && p.n_mt <= XEQ_HB_MT && p.nst >= 2 &&
         n_seg >= 1 && n_seg <= XEQ_HB_SEGS && ni % 2 == 0 && d % 2 == 0 && d < 4096 &&
         kf - kw <= XEQ_MAXY && p.sd8 <= p.ht8 && p.ht8 <= hp && p.dt8 <= dp &&
         p.sd8 <= sdp && p.smem <= XEQ_SMEM_MAX;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
// dgv and drsh of a warp's NV slots over one irrep segment of DIM-lane
// irreps (mul irreps from irrep u0 and lane j0, both even, mul even), the
// slots side by side for independent loads: a lane takes two irreps (2 DIM
// lanes) at a time (pairs q0, q0 + qs, ...), fo of both from the staged x rows xr (where the m64
// tiles left it, in place of gs), gms_v from gv, the lane pairs' products
// as __hmul2; dgv to the scratch rows rrow (null for a slot that adds
// nothing), drsh summed into hy per slot and harmonic column m of the
// irrep.
template <int DIM, int NV>
__device__ __forceinline__ void xeq_hb_segment(const xeq_bf16* const (&xr)[NV],
                                               const xeq_bf16* const (&gv)[NV],
                                               xeq_bf16* const (&rrow)[NV], int u0, int j0,
                                               int mul, int ni, float (&hy)[NV][DIM], int q0,
                                               int qs) {
  for (int q = q0; 2 * q < mul; q += qs) {
    const int u = u0 + 2 * q, jj = j0 + 2 * q * DIM;
    __nv_bfloat162 fa[NV], fb[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      fa[v] = *reinterpret_cast<const __nv_bfloat162*>(xr[v] + u);
      fb[v] = *reinterpret_cast<const __nv_bfloat162*>(xr[v] + ni + u);
    }
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      // lanes jj + 2k and jj + 2k + 1 belong to irreps u + (2k >= DIM) and
      // u + (2k + 1 >= DIM)
      const bool lo1 = 2 * k >= DIM, hi1 = 2 * k + 1 >= DIM;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const __nv_bfloat162 a = xeq_bf2(lo1 ? fa[v].y : fa[v].x, hi1 ? fa[v].y : fa[v].x);
        const __nv_bfloat162 b = xeq_bf2(lo1 ? fb[v].y : fb[v].x, hi1 ? fb[v].y : fb[v].x);
        const __nv_bfloat162 gm =
            *reinterpret_cast<const __nv_bfloat162*>(gv[v] + jj + 2 * k);
        const __nv_bfloat162 dgv = __hmul2(a, gm);
        const float2 r = __bfloat1622float2(__hmul2(b, gm));
        if (rrow[v]) *reinterpret_cast<__nv_bfloat162*>(rrow[v] + jj + 2 * k) = dgv;
        hy[v][(2 * k) % DIM] += r.x;
        hy[v][(2 * k + 1) % DIM] += r.y;
      }
    }
  }
}

// Step A: dfo's gate sums of NV slots over one irrep segment of DIM-lane
// irreps (as xeq_hb_segment walks it), the slots side by side:
//   dfo[u]      = sum over the lanes j of irrep u of rnd(gv[j] * gms_v[j])
//   dfo[ni + u] = sum over them of rnd(ef[yc + m(j)] * gms_v[j])
// with the rounded products of lane pairs as __hmul2 and the sums in f32 in
// lane order, a lane taking the irrep pairs q0, q0 + qs, ...; xr points at the slots' staged gv, gv at gms_v, dr at their
// dfo rows; ta are the slots (for their edge-feature columns).
template <int DIM, int NV>
__device__ __forceinline__ void xeq_hb_gate_sums(const xeq_bf16* const (&xr)[NV],
                                                 const xeq_bf16* const (&gv)[NV],
                                                 const unsigned char* e_s, const int (&ta)[NV],
                                                 float* const (&dr)[NV], int u0, int j0,
                                                 int mul, int yc, int ni, int q0, int qs) {
  xeq_bf16 ey[NV][DIM];  // the slots' harmonic columns of this l
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int m = 0; m < DIM; ++m)
      ey[v][m] = *reinterpret_cast<const xeq_bf16*>(e_s + xeq_hb_ef_off(ta[v], yc + m));
  for (int q = q0; 2 * q < mul; q += qs) {
    const int u = u0 + 2 * q, jj = j0 + 2 * q * DIM;
    float sv[NV][2], se[NV][2];
#pragma unroll
    for (int v = 0; v < NV; ++v) sv[v][0] = sv[v][1] = se[v][0] = se[v][1] = 0.f;
#pragma unroll
    for (int k = 0; k < DIM; ++k) {
      const int lo1 = 2 * k >= DIM, hi1 = 2 * k + 1 >= DIM;  // the irreps of the pair
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const __nv_bfloat162 gm = *reinterpret_cast<const __nv_bfloat162*>(gv[v] + jj + 2 * k);
        const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xr[v] + jj + 2 * k);
        const float2 pv = __bfloat1622float2(__hmul2(xv, gm));
        const float2 pe = __bfloat1622float2(
            __hmul2(xeq_bf2(ey[v][(2 * k) % DIM], ey[v][(2 * k + 1) % DIM]), gm));
        sv[v][lo1] += pv.x;
        sv[v][hi1] += pv.y;
        se[v][lo1] += pe.x;
        se[v][hi1] += pe.y;
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      *reinterpret_cast<float2*>(dr[v] + u) = make_float2(sv[v][0], sv[v][1]);
      *reinterpret_cast<float2*>(dr[v] + ni + u) = make_float2(se[v][0], se[v][1]);
    }
  }
}

#define XEQ_HB_PARAMS                                                                         \
  const xeq_bf16 *__restrict__ x, const xeq_bf16 *__restrict__ ef,                          \
      const xeq_bf16 *__restrict__ wf, const xeq_bf16 *__restrict__ g,                      \
      const int *__restrict__ slot_src, const int *__restrict__ slot_dst,                   \
      const int *__restrict__ src_pos, const int *__restrict__ lane_ycol,                   \
      const int *__restrict__ gate_lane0, const int *__restrict__ gate_dim,                 \
      const int4 *__restrict__ seg, xeq_bf16 *__restrict__ rows, float *__restrict__ d_ef, \
      float *__restrict__ dwf_part, const XeqHopperDims p, long long *__restrict__ stamps
#define XEQ_HB_ARGS \
  x, ef, wf, g, slot_src, slot_dst, src_pos, lane_ycol, gate_lane0, gate_dim, seg, rows, d_ef, \
      dwf_part, p, stamps

// The body of the Hopper tile pass.  FLOOR: the stream floor's
// (bwd_stream_floor_tile_kernel): the same producer, ring, walk and
// stores, with a near-empty body (each valid slot's scratch row zeros,
// each slot's d_ef row its staged edge-feature columns as f32 and zeros
// past them, the d_wf partial zeros).  STAMP: the phase probe's instance
// (xeq_bwd_phases): thread 0 of each consumer warpgroup and lane 0 of the
// producer add the clock64() cycles of their phases, written to
// stamps[(block * (XEQ_HB_WGS + 1) + role) * XEQ_STAMPS] (role: the
// consumer warpgroups 0 to XEQ_HB_WGS - 1, then the producer).
template <bool FLOOR, bool STAMP>
__device__ __forceinline__ void xeq_hb_body(XEQ_HB_PARAMS) {
  extern __shared__ __align__(128) unsigned char hb_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(hb_smem + p.off_bar);
  uint64_t* empty = full + XEQ_HB_MAXST;
  int* gtab = reinterpret_cast<int*>(hb_smem + p.off_gtab);  // j0 | dim << 16 | ycol - kw << 20
  int4* segs = reinterpret_cast<int4*>(hb_smem + p.off_seg);  // u0, j0, mul, l | ycol - kw << 8
  unsigned char* wf_s = hb_smem + p.off_wf;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = (p.n_slots + XEQ_BT - 1) / XEQ_BT, grid = gridDim.x;
  XeqStamps<STAMP> sp;

  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      xeq_mbar_init(full + s, 1);
      xeq_mbar_init(empty + s, 128 * XEQ_HB_WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int u = tid; u < p.ni; u += XEQ_HB_THREADS) {
    const int j0 = __ldg(gate_lane0 + u);
    gtab[u] = j0 | (__ldg(gate_dim + u) << 16) | ((__ldg(lane_ycol + j0) - p.kw) << 20);
  }
  if (tid < p.n_seg) segs[tid] = seg[tid];
  if (FLOOR) {  // the floor's dgs rows stay zero
    xeq_bf16* dgs0 = reinterpret_cast<xeq_bf16*>(hb_smem + p.off_dgs);
    for (int i = tid; i < XEQ_BT * p.dgs_st; i += XEQ_HB_THREADS) dgs0[i] = xeq_b(0.f);
    xeq_fence_async();
  }
  if (!FLOOR) {
    // wf's live rows in the core-matrix layout, one 16-byte row (8 h of one
    // f) per thread at a time; zero for f >= Kw and h >= H
    for (int i = tid; i < p.mtw * XEQ_HB_WGS * 8 * 32; i += XEQ_HB_THREADS) {
      const int hb = i >> 5, f = i & 31, h0 = hb * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (f < p.kw && h0 < p.h) {
        const xeq_bf16* src = wf + (int64_t)f * p.hp + h0;
        if (h0 + 8 <= p.h) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          xeq_bf16 e[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) e[c] = h0 + c < p.h ? src[c] : xeq_b(0.f);
          v = *reinterpret_cast<const uint4*>(e);
        }
      }
      *reinterpret_cast<uint4*>(wf_s + hb * 512 + (f >> 3) * 128 + (f & 7) * 16) = v;
    }
    xeq_fence_async();
  }
  __syncthreads();
  sp.mark(0);

  if (warp == XEQ_HB_CW) {
    // ---- the producer warp: lane t issues the bulk copies of slot t's x
    // and g rows, lane 16 + t stores its edge-feature columns
    const int t = lane & 15;
    for (int it = 0;; ++it) {
      const int tl = blockIdx.x + it * grid;
      if (tl >= n_tiles) break;
      const int s = it % p.nst, k = tl * XEQ_BT + t;
      int dst = -1, src = 0, pos = -1;
      if (k < p.n_slots) dst = __ldg(slot_dst + k);
      if (dst >= 0) {
        src = __ldg(slot_src + k);
        pos = __ldg(src_pos + k);
      }
      const bool ok = dst >= 0;
      // lanes 16 + t: slot t's 32 edge-feature columns (zeros where it adds
      // nothing), loaded before the wait for the stage
      uint4 ev[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ev[q] = make_uint4(0u, 0u, 0u, 0u);
        if (lane >= 16 && ok)
          ev[q] = __ldg(reinterpret_cast<const uint4*>(ef + (int64_t)k * XEQ_FPACK) + q);
      }
      const unsigned n_ok = __popc(__ballot_sync(0xffffffffu, ok) & 0xffffu);
      sp.mark(2);
      xeq_mbar_wait(empty + s, ((it / p.nst) & 1) ^ 1);
      sp.mark(1);
      unsigned char* st = hb_smem + s * p.stage;
      unsigned char* e_row = st + p.off_e + (t >> 3) * 512 + (t & 7) * 16;
      if (lane < 16) {
        reinterpret_cast<int*>(st + p.off_pos)[t] = pos;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) *reinterpret_cast<uint4*>(e_row + q * 128) = ev[q];
      }
      xeq_fence_async();  // the edge-feature columns reach the async proxy (wgmma)
      __syncwarp();
      if (lane == 0) xeq_mbar_arrive_tx(full + s, n_ok * (p.x_bytes + p.g_bytes));
      __syncwarp();
      if (ok && lane < 16) {
        const xeq_bf16* xr = x + (int64_t)src * (p.hp + p.dp);
        const xeq_bf16* gr = g + (int64_t)dst * (p.sdp + p.dp);
        unsigned char* xs = st + t * p.xs_b;
        unsigned char* gs = st + p.off_g + t * p.gs_b;
        xeq_bulk_g2s(xs, xr, p.ht8 * 2, full + s);
        xeq_bulk_g2s(xs + p.ht8 * 2, xr + p.hp, p.dt8 * 2, full + s);
        if (p.sd8 == p.sdp) {
          xeq_bulk_g2s(gs, gr, p.g_bytes, full + s);
        } else {
          xeq_bulk_g2s(gs, gr, p.sd8 * 2, full + s);
          xeq_bulk_g2s(gs + p.sd8 * 2, gr + p.sdp, p.dt8 * 2, full + s);
        }
      }
      sp.mark(3);
    }
    sp.mark(7);
    if (STAMP && lane == 0)
      sp.write(stamps + ((int64_t)blockIdx.x * (XEQ_HB_WGS + 1) + XEQ_HB_WGS) * XEQ_STAMPS);
    return;
  }

  // ---- consumer warpgroup wg: warp w, fragment row group gq, column pair
  // cq.  Every warpgroup takes every tile, warpgroup wg its m64 tiles i =
  // wg, wg + XEQ_HB_WGS, ... of H (and their d_wf accumulators).
  const int wg = warp >> 2, w = warp & 3, gq = lane >> 2, cq = lane & 3, wt = tid & 127;
  // the slots of warp ``warp`` in steps A and C: warp and, for the first
  // 16 - XEQ_HB_CW warps, warp + XEQ_HB_CW (else the first again, not
  // stored twice)
  const int tw0 = warp, tw1 = warp + XEQ_HB_CW < XEQ_BT ? warp + XEQ_HB_CW : warp;
  const int ni2 = 2 * p.ni;
  unsigned char* dfw_t = hb_smem + p.off_dfw + wg * 2 * XEQ_HB_DFW;
  float* red = reinterpret_cast<float*>(hb_smem + p.off_red);  // [2][WGS - 1][128 x 8]
  float* dfo_s = reinterpret_cast<float*>(hb_smem + p.off_dfo);  // [16][dfo_st]
  xeq_bf16* dgs_s = reinterpret_cast<xeq_bf16*>(hb_smem + p.off_dgs);  // [16][dgs_st]
  int yb[3] = {-1, -1, -1};  // each l's first harmonic column (- Kw), -1 if absent
  for (int i = 0; i < p.n_seg; ++i) {
    const int l = segs[i].w & 3, y = segs[i].w >> 8;
#pragma unroll
    for (int ll = 0; ll < 3; ++ll)
      if (l == ll) yb[ll] = y;
  }
  float acc[FLOOR ? 1 : XEQ_HB_MTW][16];  // d_wf^T of the warpgroup's m64 tiles, f32
#pragma unroll
  for (int i = 0; i < (FLOOR ? 1 : XEQ_HB_MTW); ++i)
#pragma unroll
    for (int q = 0; q < 16; ++q) acc[i][q] = 0.f;

  for (int it = 0;; ++it) {
    const int tl = blockIdx.x + it * grid;
    if (tl >= n_tiles) break;
    const int s = it % p.nst, k0 = tl * XEQ_BT;
    xeq_mbar_wait(full + s, (it / p.nst) & 1);
    sp.mark(1);
    unsigned char* st = hb_smem + s * p.stage;
    const unsigned char* e_s = st + p.off_e;
    const int* pos_s = reinterpret_cast<const int*>(st + p.off_pos);

    if constexpr (FLOOR) {
      // each warp's slots (tw0, tw1): each valid one's scratch row as the
      // pass writes it, [dgs | dgv] from dgs_s (zeros) and the staged gv
      // columns (written zero here, where step C writes dgv), in two bulk
      // copies; and each one's d_ef row (lane l: columns 4l .. 4l + 3)
      for (int v = 0; v < 2; ++v) {
        const int t = v ? tw1 : tw0, k = k0 + t;
        if (k >= p.n_slots || (v && tw1 == tw0)) break;
        const int pos = pos_s[t];
        if (pos >= 0) {
          xeq_bf16* gvr = reinterpret_cast<xeq_bf16*>(st + t * p.xs_b) + p.ht8;
          for (int c = lane; c < (p.dt8 >> 3); c += 32)
            reinterpret_cast<uint4*>(gvr)[c] = make_uint4(0u, 0u, 0u, 0u);
          xeq_fence_async();
          __syncwarp();
          if (lane == 0) {
            xeq_bf16* rr = rows + (int64_t)pos * p.rs;
            xeq_bulk_s2g(rr, dgs_s + t * p.dgs_st, p.ht8 * 2);
            xeq_bulk_s2g(rr + p.ht8, gvr, p.dt8 * 2);
            xeq_bulk_commit();
          }
        }
        const int f = 4 * lane;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (f < XEQ_BT_KE) {
          const float2 a = xeq_f2(reinterpret_cast<const xeq_bf16*>(e_s + xeq_hb_ef_off(t, f)));
          const float2 b =
              xeq_f2(reinterpret_cast<const xeq_bf16*>(e_s + xeq_hb_ef_off(t, f + 2)));
          val = make_float4(a.x, a.y, b.x, b.y);
        }
        reinterpret_cast<float4*>(d_ef + (int64_t)k * XEQ_FPACK)[lane] = val;
      }
      sp.mark(6);
    } else {
      // the thread's four slots in the accumulator layout: 2cq, 2cq + 1,
      // 2cq + 8, 2cq + 9 (index 2j + e)
      int pos4[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pos4[q] = pos_s[2 * cq + (q & 1) + 8 * (q >> 1)];
      const uint64_t e_k = xeq_desc(e_s, 128, 512);   // ef^T as fw's B (K = f)
      const uint64_t e_n = xeq_desc(e_s, 512, 128);   // ef as d_wf's B (K = slot)

      float def[8];  // d_ef^T [64 f x 16 slots] over the warpgroup's m64 tiles
#pragma unroll
      for (int q = 0; q < 8; ++q) def[q] = 0.f;
      // fw^T of the first m64 tile, issued here and waited for after step
      // A; each later one is issued with the products of the one before it
      // (one wait per m64 tile)
      float fw[2][8];
#pragma unroll
      for (int q = 0; q < 8; ++q) fw[0][q] = fw[1][q] = 0.f;
      xeq_wg_fence();
      xeq_wg_regs(fw[0]);
      xeq_wgmma_n16<1, 0>(fw[0], xeq_desc(wf_s + wg * 4096, 128, 512), e_k);
      xeq_wgmma_n16<1, 0>(fw[0], xeq_desc(wf_s + wg * 4096 + 256, 128, 512), e_k + (256 >> 4));
      xeq_wg_commit();

      // A: dfo's gate sums of the warp's slots (tw0, tw1), per irrep
      // segment, into dfo_s
      {
        const xeq_bf16* xr[2];
        const xeq_bf16* gv[2];
        float* dr[2];
        int ta[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          ta[v] = v ? tw1 : tw0;
          xr[v] = reinterpret_cast<const xeq_bf16*>(st + ta[v] * p.xs_b) + p.ht8;
          gv[v] = reinterpret_cast<const xeq_bf16*>(st + p.off_g + ta[v] * p.gs_b) + p.sd8;
          dr[v] = dfo_s + ta[v] * p.dfo_st;
        }
        // a run of 16 irrep pairs or fewer: a half-warp per slot, so that
        // every lane works
        const int hs = lane >> 4, q0 = lane & 15;
        const xeq_bf16* xr1[1] = {hs ? xr[1] : xr[0]};
        const xeq_bf16* gv1[1] = {hs ? gv[1] : gv[0]};
        float* dr1[1] = {hs ? dr[1] : dr[0]};
        const int ta1[1] = {hs ? ta[1] : ta[0]};
        for (int si = 0; si < p.n_seg; ++si) {
          const int4 sg = segs[si];
          const int l = sg.w & 3, yc = p.kw + (sg.w >> 8);
          if (sg.z > 32) {
            if (l == 0)
              xeq_hb_gate_sums<1>(xr, gv, e_s, ta, dr, sg.x, sg.y, sg.z, yc, p.ni, lane, 32);
            else if (l == 1)
              xeq_hb_gate_sums<3>(xr, gv, e_s, ta, dr, sg.x, sg.y, sg.z, yc, p.ni, lane, 32);
            else
              xeq_hb_gate_sums<5>(xr, gv, e_s, ta, dr, sg.x, sg.y, sg.z, yc, p.ni, lane, 32);
          } else {
            if (l == 0)
              xeq_hb_gate_sums<1>(xr1, gv1, e_s, ta1, dr1, sg.x, sg.y, sg.z, yc, p.ni, q0, 16);
            else if (l == 1)
              xeq_hb_gate_sums<3>(xr1, gv1, e_s, ta1, dr1, sg.x, sg.y, sg.z, yc, p.ni, q0, 16);
            else
              xeq_hb_gate_sums<5>(xr1, gv1, e_s, ta1, dr1, sg.x, sg.y, sg.z, yc, p.ni, q0, 16);
          }
        }
      }
      xeq_bar_sync(XEQ_HB_WGS + 1, 128 * XEQ_HB_WGS);  // dfo_s is whole
      sp.mark(7);

      xeq_wg_wait();
      xeq_wg_regs(fw[0]);
      sp.mark(2);
#pragma unroll
      for (int ii = 0; ii < XEQ_HB_MTW; ++ii) {
        // the m64 tile of H (past H on some warpgroups' last step: wf_s's
        // zero rows there make every product of that tile zero); the walk's
        // length is the same on every warpgroup, so that no wgmma sits on a
        // divergent path
        if (ii >= p.mtw) break;
        const int i = XEQ_HB_WGS * ii + wg;
        float (&fc)[8] = fw[ii & 1];
        float (&fn)[8] = fw[(ii + 1) & 1];

        // elementwise: rows h = 64 i + 16 w + gq + 8 r, slot pairs j
        unsigned char* dfw_b = dfw_t + (ii & 1) * XEQ_HB_DFW;
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int h = 64 * i + 16 * w + gq + 8 * r;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int tt = 2 * cq + 8 * j;
            xeq_bf16* xa = reinterpret_cast<xeq_bf16*>(st + tt * p.xs_b);
            xeq_bf16* xb = reinterpret_cast<xeq_bf16*>(st + (tt + 1) * p.xs_b);
            const float fa = fc[4 * j + 2 * r], fb = fc[4 * j + 2 * r + 1];
            float2 gs = make_float2(0.f, 0.f), dfo = gs;
            if (h < p.h) {
              gs = make_float2(xeq_f(xa[h]), xeq_f(xb[h]));
              if (h < ni2) {
                dfo = make_float2(dfo_s[tt * p.dfo_st + h], dfo_s[(tt + 1) * p.dfo_st + h]);
                // fo, in place of gs
                xa[h] = xeq_b(gs.x * fa);
                xb[h] = xeq_b(gs.y * fb);
              } else {
                const xeq_bf16* ga =
                    reinterpret_cast<const xeq_bf16*>(st + p.off_g + tt * p.gs_b);
                const xeq_bf16* gb =
                    reinterpret_cast<const xeq_bf16*>(st + p.off_g + (tt + 1) * p.gs_b);
                dfo = make_float2(xeq_f(ga[h - ni2]), xeq_f(gb[h - ni2]));
              }
            }
            const bool va = pos4[2 * j] >= 0, vb = pos4[2 * j + 1] >= 0;
            a[2 * j + r] =
                xeq_pack(xeq_b(va ? dfo.x * gs.x : 0.f), xeq_b(vb ? dfo.y * gs.y : 0.f));
            // dfw^T as d_ef's B (N = slot contiguous): slots tt, tt + 1
            *reinterpret_cast<uint32_t*>(dfw_b + (tt & 7) * 2 + j * 128 + gq * 16 +
                                         (2 * w + r) * 256) = a[2 * j + r];
            if (h < p.ht8) {  // dgs, to the tile's scratch rows in shared memory
              dgs_s[tt * p.dgs_st + h] = xeq_b(dfo.x * fa);
              dgs_s[(tt + 1) * p.dgs_st + h] = xeq_b(dfo.y * fb);
            }
          }
        }
        xeq_fence_async();
        xeq_bar_sync(1 + wg, 128);  // the dfw tile is whole
        sp.mark(3);

        // d_wf^T += dfw^T . ef (A from registers); d_ef^T += wf_s . dfw^T
        // over this tile's 64 h in four k16 steps; fw^T of the next m64 tile
        const bool next = ii + 1 < p.mtw;
        xeq_wg_fence();
        xeq_wg_regs(acc[ii]);
        xeq_wg_regs(def);
        xeq_wg_regs(fn);
        xeq_wgmma_n32_rs<1>(acc[ii], a, e_n);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          xeq_wgmma_n16<0, 1>(def, xeq_desc(wf_s + (8 * i + 2 * ks) * 512, 512, 128),
                              xeq_desc(dfw_b + ks * 512, 256, 128));
        if (next) {
#pragma unroll
          for (int q = 0; q < 8; ++q) fn[q] = 0.f;
          xeq_wg_regs(fn);
          xeq_wgmma_n16<1, 0>(fn, xeq_desc(wf_s + (i + XEQ_HB_WGS) * 4096, 128, 512), e_k);
          xeq_wgmma_n16<1, 0>(fn, xeq_desc(wf_s + (i + XEQ_HB_WGS) * 4096 + 256, 128, 512),
                              e_k + (256 >> 4));
        }
        xeq_wg_commit();
        xeq_wg_wait();
        xeq_wg_regs(acc[ii]);
        xeq_wg_regs(def);
        xeq_wg_regs(fn);
        sp.mark(4);
      }

      // the other warpgroups' d_ef partials through shared memory (two
      // buffers by tile parity); after the barrier every fo of the tile is
      // written too
      float* rb = red + (it & 1) * (XEQ_HB_WGS - 1) * 128 * 8 + wt * 8;
      if (wg > 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) rb[(wg - 1) * 128 * 8 + q] = def[q];
      }
      xeq_bar_sync(XEQ_HB_WGS + 1, 128 * XEQ_HB_WGS);
      sp.mark(6);

      // C: the warp's slots (tw0, tw1) side by side: dgv in place of gv
      // (which nothing reads after A), drsh into the harmonic d_ef columns;
      // zeros past Kf.  Then each valid slot's scratch row, [dgs | dgv],
      // goes out as two bulk copies.
      {
        const xeq_bf16* xr[2];
        const xeq_bf16* gv[2];
        xeq_bf16* rrow[2];
        float h0[2][1], h1[2][3], h2[2][5];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int t = v ? tw1 : tw0;
          xr[v] = reinterpret_cast<const xeq_bf16*>(st + t * p.xs_b);
          gv[v] = reinterpret_cast<const xeq_bf16*>(st + p.off_g + t * p.gs_b) + p.sd8;
          rrow[v] = reinterpret_cast<xeq_bf16*>(st + t * p.xs_b) + p.ht8;
          h0[v][0] = 0.f;
#pragma unroll
          for (int m = 0; m < 3; ++m) h1[v][m] = 0.f;
#pragma unroll
          for (int m = 0; m < 5; ++m) h2[v][m] = 0.f;
        }
        // runs of 16 irrep pairs or fewer: a half-warp per slot (sums in
        // k0s .. k2s, the half-warp's slot's)
        const int hs = lane >> 4, q0 = lane & 15;
        const xeq_bf16* xr1[1] = {hs ? xr[1] : xr[0]};
        const xeq_bf16* gv1[1] = {hs ? gv[1] : gv[0]};
        xeq_bf16* rrow1[1] = {hs ? rrow[1] : rrow[0]};
        float k0s[1][1] = {{0.f}}, k1s[1][3] = {{0.f, 0.f, 0.f}},
              k2s[1][5] = {{0.f, 0.f, 0.f, 0.f, 0.f}};
        for (int si = 0; si < p.n_seg; ++si) {
          const int4 sg = segs[si];
          const int l = sg.w & 3;
          if (sg.z > 32) {
            if (l == 0) xeq_hb_segment<1, 2>(xr, gv, rrow, sg.x, sg.y, sg.z, p.ni, h0, lane, 32);
            else if (l == 1)
              xeq_hb_segment<3, 2>(xr, gv, rrow, sg.x, sg.y, sg.z, p.ni, h1, lane, 32);
            else xeq_hb_segment<5, 2>(xr, gv, rrow, sg.x, sg.y, sg.z, p.ni, h2, lane, 32);
          } else {
            if (l == 0)
              xeq_hb_segment<1, 1>(xr1, gv1, rrow1, sg.x, sg.y, sg.z, p.ni, k0s, q0, 16);
            else if (l == 1)
              xeq_hb_segment<3, 1>(xr1, gv1, rrow1, sg.x, sg.y, sg.z, p.ni, k1s, q0, 16);
            else xeq_hb_segment<5, 1>(xr1, gv1, rrow1, sg.x, sg.y, sg.z, p.ni, k2s, q0, 16);
          }
        }
#pragma unroll
        for (int v = 0; v < 2; ++v)
          for (int jj = p.d + 2 * lane; jj < p.dt8; jj += 64)
            *reinterpret_cast<uint32_t*>(rrow[v] + jj) = 0u;
        // the 2 x 9 per-lane sums (value 16 v + c: c = 0 for l = 0, 1 + m for
        // l = 1, 4 + m for l = 2) summed over the warp by recursive halving:
        // lane L ends with the sum of value L
        float hv[32];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const bool mine = hs == v;  // the half-warp's slot
          hv[16 * v] = h0[v][0] + (mine ? k0s[0][0] : 0.f);
#pragma unroll
          for (int m = 0; m < 3; ++m) hv[16 * v + 1 + m] = h1[v][m] + (mine ? k1s[0][m] : 0.f);
#pragma unroll
          for (int m = 0; m < 5; ++m) hv[16 * v + 4 + m] = h2[v][m] + (mine ? k2s[0][m] : 0.f);
#pragma unroll
          for (int c = 9; c < 16; ++c) hv[16 * v + c] = 0.f;
        }
        xeq_halving_sum(hv);
        {
          const int v = lane >> 4, c = lane & 15;
          const int l = c == 0 ? 0 : (c < 4 ? 1 : 2), m = c - (l == 0 ? 0 : (l == 1 ? 1 : 4));
          const int y = l == 0 ? yb[0] : (l == 1 ? yb[1] : yb[2]);
          const int k = k0 + (v ? tw1 : tw0);
          if (c < 9 && y >= 0 && k < p.n_slots && !(v && tw1 == tw0))
            d_ef[(int64_t)k * XEQ_FPACK + p.kw + y + m] = pos_s[v ? tw1 : tw0] >= 0 ? hv[0] : 0.f;
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int k = k0 + (v ? tw1 : tw0);
          if (k >= p.n_slots || (v && tw1 == tw0)) break;
          float* row = d_ef + (int64_t)k * XEQ_FPACK;
          const int f4 = (p.kf + 3) & ~3;  // zeros past Kf: scalars to a float4 boundary
          if (lane < f4 - p.kf) row[p.kf + lane] = 0.f;
          for (int f = f4 + 4 * lane; f < XEQ_FPACK; f += 128)
            *reinterpret_cast<float4*>(row + f) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        xeq_fence_async();
        __syncwarp();
        if (lane == 0) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int t = v ? tw1 : tw0, pos = pos_s[t];
            if (pos < 0 || (v && tw1 == tw0)) continue;
            xeq_bf16* rr = rows + (int64_t)pos * p.rs;
            xeq_bulk_s2g(rr, dgs_s + t * p.dgs_st, p.ht8 * 2);
            xeq_bulk_s2g(rr + p.ht8, rrow[v], p.dt8 * 2);
          }
          xeq_bulk_commit();
        }
      }
      sp.mark(5);
      // d_ef's filter columns (warpgroup 0's partial, then the others' in
      // order): rows f = 16 w + gq + 8 r < Kw (warps 0, 1)
      if (wg == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int f = 16 * w + gq + 8 * ((q >> 1) & 1);
          const int t = 8 * (q >> 2) + 2 * cq + (q & 1), k = k0 + t;
          if (f < p.kw && k < p.n_slots) {
            float v = def[q];
#pragma unroll
            for (int o = 0; o < XEQ_HB_WGS - 1; ++o) v += rb[o * 128 * 8 + q];
            d_ef[(int64_t)k * XEQ_FPACK + f] = pos4[2 * (q >> 2) + (q & 1)] >= 0 ? v : 0.f;
          }
        }
      }
    }
    if (lane == 0) xeq_bulk_wait_read();  // the scratch rows have left
    xeq_fence_async();  // fo written in place: before the stage's next copies
    xeq_mbar_arrive(empty + s);
    sp.mark(6);
  }

  if (lane == 0) xeq_bulk_wait();
  // the block's d_wf partial [kf, h]: each warpgroup its m64 tiles
  float* part = dwf_part + (int64_t)blockIdx.x * p.kf * p.h;
  if constexpr (FLOOR) {
    for (int i = tid; i < p.kf * p.h; i += 128 * XEQ_HB_WGS) part[i] = 0.f;
  } else {
#pragma unroll
    for (int ii = 0; ii < XEQ_HB_MTW; ++ii) {
      const int i = XEQ_HB_WGS * ii + wg;
      if (i >= p.n_mt) break;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int h = 64 * i + 16 * w + gq + 8 * ((q >> 1) & 1);
        const int f = 8 * (q >> 2) + 2 * cq + (q & 1);
        if (f < p.kf && h < p.h) part[(int64_t)f * p.h + h] = acc[ii][q];
      }
    }
  }
  sp.mark(0);
  if (STAMP && (tid & 127) == 0)
    sp.write(stamps + ((int64_t)blockIdx.x * (XEQ_HB_WGS + 1) + wg) * XEQ_STAMPS);
}

template <bool STAMP>
__global__ void __launch_bounds__(XEQ_HB_THREADS, 1) message_bwd_hopper_kernel(XEQ_HB_PARAMS) {
  xeq_hb_body<false, STAMP>(XEQ_HB_ARGS);
}

__global__ void __launch_bounds__(XEQ_HB_THREADS, 1) bwd_stream_floor_tile_kernel(XEQ_HB_PARAMS) {
  xeq_hb_body<true, false>(XEQ_HB_ARGS);
}

// Launch the Hopper tile pass (``FLOOR``: the stream floor's) with its
// layout, the stamps of the phase probe when ``stamps`` is given (not for
// the floor).
template <bool FLOOR>
static int launch_bwd_hopper(const void* x, const void* ef, const void* wf, const void* g,
                             const void* slot_src, const void* slot_dst, const void* src_pos,
                             const void* lane_ycol, const void* gate_lane0,
                             const void* gate_dim, const void* seg, void* rows, void* d_ef,
                             void* dwf_part, const XeqHopperDims& p, int n_part,
                             long long* stamps, cudaStream_t s) {
  if (FLOOR && stamps) return (int)cudaErrorInvalidValue;
  auto kernel = FLOOR ? bwd_stream_floor_tile_kernel
                      : (stamps ? message_bwd_hopper_kernel<true> : message_bwd_hopper_kernel<false>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, XEQ_HB_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const int*)slot_src, (const int*)slot_dst, (const int*)src_pos, (const int*)lane_ycol,
      (const int*)gate_lane0, (const int*)gate_dim, (const int4*)seg, (xeq_bf16*)rows,
      (float*)d_ef, (float*)dwf_part, p, stamps);
  return (int)cudaGetLastError();
}
