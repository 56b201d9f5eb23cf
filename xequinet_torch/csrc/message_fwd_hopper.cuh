// The message forward's bf16 tile pass redesigned for Hopper: message_fwd.cu's
// tile pass at the widths of ops/fused_message.py::fwd_hopper_route (the
// flagship's: bf16, Kf <= 32, at most 9 m64 tiles of H in the pair-row
// order, at most 5 A tiles a warpgroup, runs of irreps of one l of even
// multiplicity, at most 8 runs).  On those widths it replaces the mma.sync
// tile pass of message_fwd.cu (one cp.async stage a tile behind a chain
// of three dependent loads, three block barriers a tile, fw as one n8
// mma.sync per warp and step, the destination sum walked slot by slot).
//
// Block: XEQ_HF_WGS = 3 consumer warpgroups and XEQ_HF_PW = 2 producer warps
// (448 threads, one block per SM, persistent: group g = block + i * grid
// of XEQ_HF_ROWS = 16 destination rows, whose slots are one run of the CSR
// list by destination, walked in tiles of 16 slots; a group with no slot
// still takes one tile, of padding).
//  * The producer warps stage the tiles (tile it by warp it % 2, so that
//    one warp's chain of dependent loads overlaps the other's copies) into
//    a ring of ``nst`` stages (4 at the flagship widths, 38.1 KB a stage)
//    with a full and an empty mbarrier each: lane t loads slot t's index,
//    source and destination and issues one cp.async.bulk copy of its x row
//    [gs | 0 | gv] (Hp + D rounded up to 8 columns: a bulk copy's issue
//    costs about as much as its bytes here; completion counted in bytes on
//    the full barrier), and writes its destination and its row of the
//    tile's one-hot [16 slots x 16 rows] (N-major core matrices: the
//    destination product's B); lane 16 + t loads the slot's 32
//    edge-feature columns before the wait for the stage and stores them
//    into wgmma's core-matrix layout (fw's B), and its harmonic columns
//    (Kw .. Kf) slot-contiguous, so that a consumer reads two slots' with
//    one load.  Bulk copies do not zero-fill: slots past the group's run
//    are not copied, their edge-feature columns and one-hot rows are
//    zeros, and the consumers give them zero messages.  The stage's flags
//    say whether the tile is its group's first and last, and end the walk.
//  * H's rows are in the pair-row order of message_bwd2_hopper.cuh
//    (ops/fused_message.py::pair_table): in a pair tile a thread's two
//    accumulator rows are an irrep u's state gate u and its harmonic gate
//    ni + u, in a scalar tile two node_dim columns.  Warpgroup wg owns the
//    m64 tiles wg, wg + 3, wg + 6 (zero rows of wf past H).  Per tile it
//    issues fw^T = wf_live^T . ef^T for its three m64 tiles (wgmma
//    m64n16k16, two k16 steps each, one commit group each) and takes them
//    in order as they complete: fo = rnd(gs fw) for the thread's two rows
//    and four slots in registers, then every message lane of irrep u,
//    rnd(gv fo[u] + ef[ycol] fo[ni + u]), or the scalar message fo[2 ni +
//    c], written as bf16 pairs of slots into the warpgroup's A tiles.
//  * The destination sum is a product, as in the TPU kernel
//    (pallas_message.py:256-259): out^T[cols, 16 rows] += msg^T[cols, 16
//    slots] . onehot[16 slots, 16 rows], one wgmma m64n16k16 per A tile
//    (A: the warpgroup's message rows, K-major; B: the stage's one-hot),
//    f32 accumulators in registers across the group (its first tile's
//    product sets them).  A warpgroup's A rows are the output columns it
//    forms, ascending (ops/fused_message.py::fwd_table), so it sums
//    exactly the rows it wrote: a warpgroup barrier orders them, never a
//    block barrier.  Rows with no slot come out zero; the padding columns
//    are A rows never written (zeros).  A tile's products are waited for
//    after the next tile's fw products are issued, then its stage is
//    released (one arrive a warp) and, when its group ends, each thread
//    stores its accumulators: 8 consecutive columns of a row per 8 lanes.
//  * ptxas serializes every wgmma of a kernel where a wgmma sits on a path
//    it takes for divergent or other instructions define its accumulators:
//    the warp index and the stage's flags come through a shuffle, the
//    m64 walk and the A tiles have lengths fixed by constants and kernel
//    parameters, and every accumulator is set by its first wgmma.
// No float atomics: each output element is one accumulator's sum, written
// once; results repeat bit for bit.
#pragma once

#include "hopper_ptx.cuh"

#define XEQ_HF_WGS 3                           // consumer warpgroups
#define XEQ_HF_PW 2                            // producer warps
#define XEQ_HF_THREADS (128 * XEQ_HF_WGS + 32 * XEQ_HF_PW)  // and the producer warps
#define XEQ_HF_CW (4 * XEQ_HF_WGS)             // consumer warps
#define XEQ_HF_MT 9                            // m64 tiles of H at most
#define XEQ_HF_MTW (XEQ_HF_MT / XEQ_HF_WGS)    // of them a warpgroup's
#define XEQ_HF_NA 5                            // A tiles (64 output columns) a warpgroup
#define XEQ_HF_MAXST 4                         // ring stages at most
#define XEQ_HF_ROWS 16                         // destination rows of a group

// ---------------------------------------------------------------------------
// Sizes and shared-memory layout, from the host
// ---------------------------------------------------------------------------
struct XeqHFDims {
  int n_out, n_groups, ni, nd, h, hp, d, dp, sdp, kw, kf, n_y;
  int n_pt;  // pair tiles (the first ones; then the scalar tiles)
  int n_mt;  // m64 tiles of H: n_pt + node_dim over 64, rounded up
  int na;    // A tiles a warpgroup walks
  int ht8, dt8;
  int xs_b, x_bytes;  // staged x row stride; bytes copied per slot: [gs | 0 | gv], Hp + D8
  int off_e, off_eh, off_oh, off_meta;    // within a stage
  int stage, nst;
  int n_tab;                              // ints of the table
  int off_wf, off_a, off_tab, off_bar, smem;
};

// The layout, ``nst`` as large as the shared memory allows (at most
// XEQ_HF_MAXST); false where the widths are not the pass's.
// ops/fused_message.py::_fwd_hopper_layout states the same sizes.
static bool fwd_hopper_dims(XeqHFDims& p, int n_out, int ni, int nd, int hp, int d, int dp,
                            int sdp, int kw, int kf, int n_pt, int na) {
  p.n_out = n_out; p.n_groups = (n_out + XEQ_HF_ROWS - 1) / XEQ_HF_ROWS;
  p.ni = ni; p.nd = nd; p.h = nd + 2 * ni; p.hp = hp; p.d = d; p.dp = dp; p.sdp = sdp;
  p.kw = kw; p.kf = kf; p.n_y = kf - kw; p.n_pt = n_pt; p.na = na;
  p.n_mt = n_pt + (nd + 63) / 64;
  p.ht8 = xeq_round_up(p.h, 8);
  p.dt8 = xeq_round_up(d, 8);
  p.x_bytes = (hp + p.dt8) * 2;
  p.xs_b = p.x_bytes + 16;
  p.off_e = XEQ_BT * p.xs_b;
  p.off_eh = p.off_e + 1024;
  p.off_oh = p.off_eh + XEQ_MAXY * XEQ_BT * 2;
  p.off_meta = p.off_oh + 512;
  p.stage = xeq_round_up(p.off_meta + 128, 128);
  p.n_tab = 64 * n_pt + (p.n_mt - n_pt) + XEQ_HF_WGS * na * 64;
  const int fixed = XEQ_HF_MT * 4096 + XEQ_HF_WGS * na * 2048 + xeq_round_up(p.n_tab * 4, 16) +
                    2 * XEQ_HF_MAXST * 8;
  p.nst = (XEQ_SMEM_MAX - fixed) / p.stage;
  if (p.nst > XEQ_HF_MAXST) p.nst = XEQ_HF_MAXST;
  p.off_wf = p.nst * p.stage;
  p.off_a = p.off_wf + XEQ_HF_MT * 4096;
  p.off_tab = p.off_a + XEQ_HF_WGS * na * 2048;
  p.off_bar = p.off_tab + xeq_round_up(p.n_tab * 4, 16);
  p.smem = p.off_bar + 2 * XEQ_HF_MAXST * 8;
  return kf <= XEQ_BT_KE && kw <= kf && p.n_y <= XEQ_MAXY && n_pt >= 1 && 32 * n_pt >= ni &&
         p.n_mt <= XEQ_HF_MT && na >= 1 && na <= XEQ_HF_NA && p.nst >= 2 && ni < 1024 &&
         d < 4096 && p.ht8 <= hp && p.dt8 <= dp && nd <= sdp && p.smem <= XEQ_SMEM_MAX;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t xeq_hf_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// A warpgroup's A tiles (the destination product's msg^T [64 rows x 16
// slots] each, K-major): row m of slot t at (t / 8) a_k + 16 m + 2 (t % 8),
// so that the rows of a thread's lanes are 16 bytes apart; ``ab``: the
// thread's first A row at its slot pair 2 cq (+ 8 j: a_k further).

// The message lanes of a pair tile's irrep for one thread: entry e (u, its
// first lane j0, DIM lanes from harmonic column y0) with fw^T's rows u and
// ni + u for its four slots tt = 2 cq + 8 j + {0, 1} (fr: the accumulator
// layout), written as pairs of slots into its DIM A rows (zero on slots
// that add nothing).
template <int DIM>
__device__ __forceinline__ void xeq_hf_pair(const float (&fr)[8], const unsigned char* st,
                                            const XeqHFDims& p, int e, int y0,
                                            const bool (&va)[4], unsigned char* ab, int a_k,
                                            int cq) {
  const int u = e & 1023, j0 = (e >> 10) & 4095, nu = p.ni + u;
  const xeq_bf16* eh = reinterpret_cast<const xeq_bf16*>(st + p.off_eh) + y0 * XEQ_BT;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int tt = 2 * cq + 8 * j;
    const xeq_bf16* xa = reinterpret_cast<const xeq_bf16*>(st + tt * p.xs_b);
    const xeq_bf16* xb = reinterpret_cast<const xeq_bf16*>(st + (tt + 1) * p.xs_b);
    const bool v0 = va[2 * j], v1 = va[2 * j + 1];
    // every load of the slot pair before the first store (the compiler
    // does not move loads of the stage past stores to the A tiles)
    const float gu0 = xeq_f(xa[u]), gu1 = xeq_f(xb[u]), gn0 = xeq_f(xa[nu]), gn1 = xeq_f(xb[nu]);
    __nv_bfloat162 ey[DIM];
    xeq_bf16 g0[DIM], g1[DIM];
#pragma unroll
    for (int m = 0; m < DIM; ++m) {
      ey[m] = *reinterpret_cast<const __nv_bfloat162*>(eh + m * XEQ_BT + tt);
      g0[m] = xa[p.hp + j0 + m];
      g1[m] = xb[p.hp + j0 + m];
    }
    // fo of both rows (an f32 product, one rounding), then the lanes
    const float2 fou = xeq_rnd2(gu0 * fr[4 * j], gu1 * fr[4 * j + 1]);
    const float2 fon = xeq_rnd2(gn0 * fr[4 * j + 2], gn1 * fr[4 * j + 3]);
#pragma unroll
    for (int m = 0; m < DIM; ++m) {
      const float2 y = __bfloat1622float2(ey[m]);
      const __nv_bfloat162 msg =
          __floats2bfloat162_rn(v0 ? xeq_f(g0[m]) * fou.x + y.x * fon.x : 0.f,
                                v1 ? xeq_f(g1[m]) * fou.y + y.y * fon.y : 0.f);
      *reinterpret_cast<uint32_t*>(ab + j * a_k + 16 * m) = xeq_hf_bits(msg);
    }
  }
}

// The scalar messages of a scalar tile for one thread: rows gq and gq + 8
// of warp w (node_dim columns c = c0 + 8 r, at 2 ni + c), fo = rnd(gs fw),
// into A rows 8 r after its first.
__device__ __forceinline__ void xeq_hf_scalar(const float (&fr)[8], const unsigned char* st,
                                              const XeqHFDims& p, int c0, const bool (&va)[4],
                                              unsigned char* ab, int a_k, int cq) {
  const int h = 2 * p.ni + c0;
  float gs[2][2][2];  // [r][j][slot]: every load before the first store
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const xeq_bf16* xa = reinterpret_cast<const xeq_bf16*>(st + (2 * cq + 8 * j) * p.xs_b);
    const xeq_bf16* xb = reinterpret_cast<const xeq_bf16*>(st + (2 * cq + 8 * j + 1) * p.xs_b);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      gs[r][j][0] = xeq_f(xa[h + 8 * r]);
      gs[r][j][1] = xeq_f(xb[h + 8 * r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (c0 + 8 * r >= p.nd) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat162 msg =
          __floats2bfloat162_rn(va[2 * j] ? gs[r][j][0] * fr[4 * j + 2 * r] : 0.f,
                                va[2 * j + 1] ? gs[r][j][1] * fr[4 * j + 2 * r + 1] : 0.f);
      *reinterpret_cast<uint32_t*>(ab + j * a_k + 128 * r) = xeq_hf_bits(msg);
    }
  }
}

#define XEQ_HF_PARAMS                                                                        \
  const xeq_bf16 *__restrict__ x, const xeq_bf16 *__restrict__ ef,                         \
      const xeq_bf16 *__restrict__ wf, const int *__restrict__ dst_ptr,                    \
      const int *__restrict__ dst_slots, const int *__restrict__ slot_src,                 \
      const int *__restrict__ slot_dst, const int *__restrict__ ftab,                      \
      float *__restrict__ out, const XeqHFDims p, long long *__restrict__ stamps
#define XEQ_HF_ARGS x, ef, wf, dst_ptr, dst_slots, slot_src, slot_dst, ftab, out, p, stamps

// The body of the pass.  STAMP: the phase probe's instance
// (xeq_fwd_phases): thread 0 of each consumer warpgroup and lane 0 of the
// producer add the clock64() cycles of their phases, written to
// stamps[(block * (XEQ_HF_WGS + 1) + role) * XEQ_STAMPS] (role: the
// consumer warpgroups 0 to XEQ_HF_WGS - 1, then the producer).
template <bool STAMP>
__device__ __forceinline__ void xeq_hf_body(XEQ_HF_PARAMS) {
  extern __shared__ __align__(128) unsigned char hf_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(hf_smem + p.off_bar);
  uint64_t* empty = full + XEQ_HF_MAXST;
  int* tab_s = reinterpret_cast<int*>(hf_smem + p.off_tab);
  unsigned char* wf_s = hf_smem + p.off_wf;
  // the warp index through a shuffle, so that the compiler knows it (and
  // every role and m64 tile derived from it) the same on the warp's lanes:
  // a wgmma on a path it takes for divergent is serialized
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  XeqStamps<STAMP> sp;

  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      xeq_mbar_init(full + s, 1);
      xeq_mbar_init(empty + s, XEQ_HF_CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < p.n_tab; i += XEQ_HF_THREADS) tab_s[i] = __ldg(ftab + i);
  // the A tiles start as zeros: the rows of padding columns stay so
  for (int i = tid; i < XEQ_HF_WGS * p.na * 2048 / 16; i += XEQ_HF_THREADS)
    reinterpret_cast<uint4*>(hf_smem + p.off_a)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  xeq_load_wf_pairs(wf_s, wf, tab_s, XEQ_HF_MT, p.n_mt, p.n_pt, p.ni, p.nd, p.kw, p.hp,
                    XEQ_HF_THREADS);
  xeq_fence_async();
  __syncthreads();
  sp.mark(0);

  if (warp >= XEQ_HF_CW) {
    // ---- the producer warps, tile it by warp it % XEQ_HF_PW: lane t (< 16)
    // slot t's indices, x row copy, destination and one-hot row; lane 16 + t
    // its edge-feature columns
    const int t = lane & 15, pw = warp - XEQ_HF_CW;
    int it = 0;
    for (int g = blockIdx.x;; g += gridDim.x) {
      const bool end = g >= p.n_groups;  // the walk's end: one tile of flags
      int r0 = 0, p0 = 0, p1 = 0;
      if (!end) {
        r0 = g * XEQ_HF_ROWS;
        p0 = __ldg(dst_ptr + r0);
        p1 = __ldg(dst_ptr + min(r0 + XEQ_HF_ROWS, p.n_out));
      }
      const int nt = end ? 1 : max(1, (p1 - p0 + XEQ_BT - 1) / XEQ_BT);
      for (int j = 0; j < nt; ++j, ++it) {
        if (it % XEQ_HF_PW != pw) continue;  // the other producer's tile
        const int n = end ? 0 : min(XEQ_BT, p1 - p0 - j * XEQ_BT);
        const bool ok = t < n;
        int k = 0, src = 0, dl = -1;
        if (ok) {
          k = __ldg(dst_slots + p0 + j * XEQ_BT + t);
          src = __ldg(slot_src + k);
          dl = __ldg(slot_dst + k) - r0;
        }
        uint4 ev[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ev[q] = make_uint4(0u, 0u, 0u, 0u);
          if (lane >= 16 && ok)
            ev[q] = __ldg(reinterpret_cast<const uint4*>(ef + (int64_t)k * XEQ_FPACK) + q);
        }
        const unsigned n_ok = __popc(__ballot_sync(0xffffffffu, ok) & 0xffffu);
        sp.mark(2);
        const int s = it % p.nst;
        xeq_mbar_wait(empty + s, ((it / p.nst) & 1) ^ 1);
        sp.mark(1);
        unsigned char* st = hf_smem + s * p.stage;
        int* meta = reinterpret_cast<int*>(st + p.off_meta);
        if (lane < 16) {
          meta[t] = dl;
          // slot t's one-hot row: 1 at its destination, in the N-major core
          // matrices of rows 0-7 and 8-15
          uint32_t oh[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            oh[q] = dl >= 0 && ((dl & 7) >> 1) == (q & 3) && (dl >> 3) == (q >> 2)
                        ? ((dl & 1) ? 0x3F800000u : 0x3F80u)
                        : 0u;
          unsigned char* ohr = st + p.off_oh + (t >> 3) * 256 + (t & 7) * 16;
          *reinterpret_cast<uint4*>(ohr) = make_uint4(oh[0], oh[1], oh[2], oh[3]);
          *reinterpret_cast<uint4*>(ohr + 128) = make_uint4(oh[4], oh[5], oh[6], oh[7]);
          if (t == 0) {
            meta[XEQ_BT] = (j == 0 ? 1 : 0) | (j == nt - 1 ? 2 : 0) | (end ? 4 : 0);
            meta[XEQ_BT + 1] = r0;
          }
        } else {
          const int ro = (t >> 3) * 512 + (t & 7) * 16;
#pragma unroll
          for (int q = 0; q < 4; ++q) *reinterpret_cast<uint4*>(st + p.off_e + ro + q * 128) = ev[q];
          // the harmonic columns, slot-contiguous (read back: their place in
          // the registers depends on Kw)
          for (int y = 0; y < p.n_y; ++y)
            reinterpret_cast<xeq_bf16*>(st + p.off_eh)[y * XEQ_BT + t] =
                *reinterpret_cast<const xeq_bf16*>(st + p.off_e + xeq_hb_ef_off(t, p.kw + y));
        }
        xeq_fence_async();  // the columns and the one-hot reach the async proxy (wgmma)
        __syncwarp();
        if (lane == 0) xeq_mbar_arrive_tx(full + s, n_ok * p.x_bytes);
        __syncwarp();
        sp.mark(3);
        if (ok && lane < 16)
          xeq_bulk_g2s(st + t * p.xs_b, x + (int64_t)src * (p.hp + p.dp), p.x_bytes, full + s);
        sp.mark(4);
      }
      if (end) break;
    }
    sp.mark(7);
    if (STAMP && lane == 0 && pw == 0)
      sp.write(stamps + ((int64_t)blockIdx.x * (XEQ_HF_WGS + 1) + XEQ_HF_WGS) * XEQ_STAMPS);
    return;
  }

  // ---- consumer warpgroup wg: warp w, fragment row group gq, column pair
  // cq; the thread's slots 2 cq + 8 j + {0, 1}
  const int wg = warp >> 2, w = warp & 3, gq = lane >> 2, cq = lane & 3, wt = tid & 127;
  unsigned char* a_s = hf_smem + p.off_a + wg * p.na * 2048;
  const int a_k = p.na * 1024;  // bytes between the A tiles' two K halves (slots 0-7, 8-15)
  const int* col_s = tab_s + 64 * p.n_pt + (p.n_mt - p.n_pt) + wg * p.na * 64;
  const int ocols = p.sdp + p.dp;
  // per m64 tile of the warpgroup, what this thread forms (the same on
  // every tile): a pair tile's entry e (-1: a padding row pair), the
  // warp's l and harmonic block (lwy: l | y0 << 4, the same on the warp's
  // lanes, so that the compiler takes the branch on l for uniform) and e's
  // A row; a scalar tile's first node_dim column and its A row
  int e_r[XEQ_HF_MTW], lwy_r[XEQ_HF_MTW], pos_r[XEQ_HF_MTW];
#pragma unroll
  for (int ii = 0; ii < XEQ_HF_MTW; ++ii) {
    const int i = XEQ_HF_WGS * ii + wg;
    e_r[ii] = lwy_r[ii] = pos_r[ii] = -1;
    if (i < p.n_pt) {
      e_r[ii] = tab_s[32 * i + 8 * w + gq];
      pos_r[ii] = tab_s[32 * p.n_pt + 32 * i + 8 * w + gq];
      int ew = -1;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        const int eo = __shfl_sync(0xffffffffu, e_r[ii], 4 * o);
        if (ew < 0) ew = eo;
      }
      lwy_r[ii] = ew < 0 ? -1 : ((ew >> 22) & 3) | ((ew >> 24) & 15) << 4;
    } else if (i < p.n_mt) {
      e_r[ii] = 64 * (i - p.n_pt) + 16 * w + gq;
      pos_r[ii] = tab_s[64 * p.n_pt + i - p.n_pt] + 16 * w + gq;
    }
  }
  // out^T of the group's 16 rows over the warpgroup's A tiles, f32: set by
  // the group's first tile's products (no instruction but a wgmma defines
  // a wgmma's accumulators, or the compiler serializes them)
  float acc[XEQ_HF_NA][8];
  // the group's rows, each element once: 8 consecutive columns of a row
  // per 8 lanes
  auto store_rows = [&](int r0) {
#pragma unroll
    for (int a = 0; a < XEQ_HF_NA; ++a) {
      if (a >= p.na) break;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int col = col_s[64 * a + 16 * w + gq + 8 * rr];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float v = acc[a][4 * (q >> 1) + 2 * rr + (q & 1)];
          const int row = r0 + 8 * (q >> 1) + 2 * cq + (q & 1);
          if (col >= 0 && row < p.n_out) out[(int64_t)row * ocols + col] = v;
        }
      }
    }
  };
  // the previous tile's destination products are waited for under the
  // next tile's fw products: its stage, its group's end and first row
  int prev_s = -1, prev_last = 0, prev_r0 = 0;

  int it = 0;
  for (;; ++it) {
    const int s = it % p.nst;
    xeq_mbar_wait(full + s, (it / p.nst) & 1);
    sp.mark(1);
    const unsigned char* st = hf_smem + s * p.stage;
    const int* meta = reinterpret_cast<const int*>(st + p.off_meta);
    const int flags = __shfl_sync(0xffffffffu, meta[XEQ_BT], 0);
    if (flags & 4) break;
    const int r0 = meta[XEQ_BT + 1];
    bool va[4];  // the thread's slots add something
#pragma unroll
    for (int q = 0; q < 4; ++q) va[q] = meta[2 * cq + (q & 1) + 8 * (q >> 1)] >= 0;

    // fw^T of the warpgroup's three m64 tiles, one commit group each
    const uint64_t e_k = xeq_desc(st + p.off_e, 128, 512);
    float fr[XEQ_HF_MTW][8];
    xeq_wg_fence();
#pragma unroll
    for (int ii = 0; ii < XEQ_HF_MTW; ++ii) {
      const unsigned char* wa = wf_s + (XEQ_HF_WGS * ii + wg) * 4096;
      xeq_wg_regs(fr[ii]);
      xeq_wgmma_n16<1, 0>(fr[ii], xeq_desc(wa, 128, 512), e_k, 0);
      xeq_wgmma_n16<1, 0>(fr[ii], xeq_desc(wa + 256, 128, 512), e_k + (256 >> 4));
      xeq_wg_commit();
    }
    sp.mark(2);
    // the previous tile's products (committed before these three) have
    // completed: its stage is released, its group's rows stored
    xeq_wg_wait_n<XEQ_HF_MTW>();
#pragma unroll
    for (int a = 0; a < XEQ_HF_NA; ++a) xeq_wg_regs(acc[a]);
    if (it > 0) {
      __syncwarp();
      if (lane == 0) xeq_mbar_arrive(empty + prev_s);
    }
    if (prev_last) store_rows(prev_r0);
    sp.mark(6);
#pragma unroll
    for (int ii = 0; ii < XEQ_HF_MTW; ++ii) {
      if (ii == 0) xeq_wg_wait_n<XEQ_HF_MTW - 1>();
      else if (ii == 1) xeq_wg_wait_n<XEQ_HF_MTW - 2>();
      else xeq_wg_wait();
      xeq_wg_regs(fr[ii]);
      sp.mark(2);
      const int i = XEQ_HF_WGS * ii + wg;  // the m64 tile (the same on the warpgroup's warps)
      if (i < p.n_pt) {
        // the warp's 8 irreps share one l and harmonic block (the table's
        // groups; entries of -1 pad a group)
        const int e = e_r[ii], l = lwy_r[ii] & 15, y0 = lwy_r[ii] >> 4;
        unsigned char* ab = a_s + pos_r[ii] * 16 + 4 * cq;
        if (e >= 0) {  // then the warp's l is e's
          if (l == 0)
            xeq_hf_pair<1>(fr[ii], st, p, e, y0, va, ab, a_k, cq);
          else if (l == 1)
            xeq_hf_pair<3>(fr[ii], st, p, e, y0, va, ab, a_k, cq);
          else
            xeq_hf_pair<5>(fr[ii], st, p, e, y0, va, ab, a_k, cq);
        }
      } else if (i < p.n_mt) {
        xeq_hf_scalar(fr[ii], st, p, e_r[ii], va, a_s + pos_r[ii] * 16 + 4 * cq, a_k, cq);
      }
      sp.mark(3);
    }
    xeq_fence_async();
    xeq_bar_sync(1 + wg, 128);  // the warpgroup's message rows are whole
    sp.mark(4);

    // out^T += msg^T . onehot over the warpgroup's A tiles (K-major: 8-row
    // core matrices 128 bytes apart, the K halves a_k apart); the group's
    // first tile sets the accumulators; waited for under the next tile's
    // fw products
    const uint64_t b_oh = xeq_desc(st + p.off_oh, 256, 128);
    const int add = (flags & 1) ? 0 : 1;
    xeq_wg_fence();
#pragma unroll
    for (int a = 0; a < XEQ_HF_NA; ++a)
      if (a < p.na) xeq_wgmma_n16<0, 1>(acc[a], xeq_desc(a_s + a * 1024, a_k, 128), b_oh, add);
    xeq_wg_commit();
    prev_s = s;
    prev_last = flags & 2;
    prev_r0 = r0;
    sp.mark(5);
  }
  // the last tile's products and rows
  xeq_wg_wait();
#pragma unroll
  for (int a = 0; a < XEQ_HF_NA; ++a) xeq_wg_regs(acc[a]);
  if (it > 0) {
    __syncwarp();
    if (lane == 0) xeq_mbar_arrive(empty + prev_s);
  }
  if (prev_last) store_rows(prev_r0);
  sp.mark(0);
  if (STAMP && wt == 0)
    sp.write(stamps + ((int64_t)blockIdx.x * (XEQ_HF_WGS + 1) + wg) * XEQ_STAMPS);
}

template <bool STAMP>
__global__ void __launch_bounds__(XEQ_HF_THREADS, 1) message_fwd_hopper_kernel(XEQ_HF_PARAMS) {
  xeq_hf_body<STAMP>(XEQ_HF_ARGS);
}

// Launch the pass with its layout on ``n_part`` blocks (``stamps``: the
// phase probe's instance).
static int launch_fwd_hopper(const void* x, const void* ef, const void* wf, const void* dst_ptr,
                             const void* dst_slots, const void* slot_src, const void* slot_dst,
                             const void* ftab, void* out, const XeqHFDims& p, int n_part,
                             long long* stamps, cudaStream_t s) {
  auto kernel = stamps ? message_fwd_hopper_kernel<true> : message_fwd_hopper_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, XEQ_HF_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const int*)dst_ptr,
      (const int*)dst_slots, (const int*)slot_src, (const int*)slot_dst, (const int*)ftab,
      (float*)out, p, stamps);
  return (int)cudaGetLastError();
}
