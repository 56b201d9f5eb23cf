// The f32 instance of the message forward (message_fwd.cu) as a tile pass
// for the H100's FP32 pipes, at the widths of
// ops/fused_message.py::f32_route("message_fwd", ...) (Kw <= 24, Kf <= 32,
// at most XEQ_F32_CW consumer warps of f32_units).  It replaces the walk
// kernel there (message_fwd_kernel<float, false>): one thread per
// (destination row, output column) that recomputed each slot's 21-term
// filter once per column needing it (832 filter columns a slot where H =
// 576 are needed) and gathered single x elements from L2 a slot at a time,
// bound by the latency of those gathers (2.03 ms at the flagship batch
// against an FP32 bound of 0.069; NVIDIA H100 80GB HBM3, 700 W).  f32
// stays exact f32: no TF32, no tensor cores, no rounding step (the TPU
// kernel runs f32 at Precision.HIGHEST).
//
// What bounds it: the filter products fw = ef . wf on the FP32 pipes, once
// per slot and column of H (2 Kw H FLOP a slot), and the issue of the
// per-slot steps around them.  The design is the f32 backwards' units and
// ring (message_f32_tile.cuh) on the list by destination:
//  * One block per SM: XEQ_F32_CW consumer warps at most and XEQ_FF_PW
//    producer warps.  Block b walks a contiguous range of the CSR list by
//    destination (plan["dst_ptr"], plan["dst_slots"]), cut at row boundaries
//    by a binary search of dst_ptr (xeq_ff_row_at), a row weighing as one
//    slot, so that the blocks' shares of slots and rows differ by at most
//    one row's and each output row of its range [R_b, R_{b+1}) is written
//    by it alone, once.  The rows of the range with no slot are written as
//    zeros, a run of them as one contiguous store of float4s spread over
//    the consumer threads, as are a row's padding columns (node_dim ..
//    SDp, SDp + D .. SDp + Dp).  (Cut by slots alone, the last block took
//    the flagship batch's 4,168 trailing padding rows, which more than
//    doubled the call's time.)
//  * The producer warps take the range's tiles of XEQ_F32_BT consecutive
//    positions in turn and stage each into a ring of ``nst`` stages with a
//    full and an empty mbarrier: lane t issues one cp.async.bulk of slot
//    t's source row [gs | 0 | gv] (Hp + D rounded up to 8 floats, the
//    padding included: one copy a row, since consecutive slots of the list
//    by destination rarely share a source) and one of its 32 edge-feature
//    columns, and writes its destination row.
//  * Consumer thread i owns a unit of ops/fused_message.py::f32_units: an
//    irrep u (its state gate u, its harmonic gate ni + u and its 2l + 1
//    lanes) or two scalar columns 2 ni + c, 2 ni + c + 1.  It keeps its two
//    columns of wf's live rows in registers for the whole block and, per
//    pair of slots (their loads and products interleaved), forms fw at its
//    two columns over each slot's edge-feature row (broadcast from shared
//    memory, 4 columns a load, two partial sums a column), fo = x fw, and
//    its messages:
//    gv[j] fo[u] + ef[ycol(j)] fo[ni + u] on an irrep's lanes, fo[2ni + c]
//    and fo[2ni + c + 1] on a scalar pair, added into its accumulators in
//    list order.
//    When the destination changes it writes its columns of the finished row
//    (a warp's lanes of one l are contiguous in the row).
//  * No sum crosses threads, so each consumer warp releases a stage once it
//    has read it (one arrival a warp): no barrier among the consumers.
// Each output element is summed by one thread in list order and written
// once: no float atomics, no scratch; the result repeats bit for bit.
#pragma once

#include "message_f32_tile.cuh"

#define XEQ_FF_PW 2     // producer warps, taking the tiles in turn
#define XEQ_FF_THREADS (32 * (XEQ_F32_CW + XEQ_FF_PW))
#define XEQ_FF_MAXST 6  // ring stages at most
static_assert(XEQ_F32_KW % 4 == 0, "wf's rows in registers, 4 a load of the edge features");

// ---------------------------------------------------------------------------
// Sizes and shared-memory layout, from the host
// ---------------------------------------------------------------------------
struct XeqFF32Dims {
  int n_out, ni, nd, h, hp, d, dp, sdp, kw, kf;
  int n_cw;     // consumer warps (units / 32)
  int dt8;      // D rounded up to 8
  int xs;       // a staged x row (floats): [gs | 0 | gv], Hp + D rounded up to 8
  int x_bytes;  // its bytes, one bulk copy
  int off_e, off_dst, stage;  // within a stage (bytes); its size
  int nst;                    // ring stages
  int off_bar, smem;
};

// The layout, ``nst`` as large as the shared memory allows (at most
// XEQ_FF_MAXST); false where the widths are not the pass's.
// ops/fused_message.py::_f32_layout("message_fwd", ...) states the same
// sizes.
static bool fwd_f32_dims(XeqFF32Dims& p, int n_out, int ni, int nd, int hp, int d, int dp,
                         int sdp, int kw, int kf, int n_cw) {
  p.n_out = n_out; p.ni = ni; p.nd = nd; p.h = nd + 2 * ni; p.hp = hp; p.d = d; p.dp = dp;
  p.sdp = sdp; p.kw = kw; p.kf = kf; p.n_cw = n_cw;
  p.dt8 = xeq_round_up(d, 8);
  p.xs = hp + p.dt8;
  p.x_bytes = p.xs * 4;
  p.off_e = XEQ_F32_BT * p.x_bytes;
  p.off_dst = p.off_e + XEQ_F32_BT * XEQ_F32_KF * 4;
  p.stage = xeq_round_up(p.off_dst + XEQ_F32_BT * 4, 128);
  const int fixed = 2 * XEQ_FF_MAXST * 8 + 16;
  p.nst = (XEQ_SMEM_MAX - fixed) / p.stage;
  if (p.nst > XEQ_FF_MAXST) p.nst = XEQ_FF_MAXST;
  p.off_bar = p.nst * p.stage;
  p.smem = p.off_bar + fixed;
  return kw <= XEQ_F32_KW && kf <= XEQ_F32_KF && kw <= kf && kf - kw <= XEQ_MAXY &&
         n_cw >= 1 && n_cw <= XEQ_F32_CW && p.nst >= 2 && p.smem <= XEQ_SMEM_MAX &&
         p.h <= hp && p.dt8 <= dp && nd <= sdp;
}

// The block ranges of the list by destination: the first row r of [0, n]
// with ptr[r] + r >= pos.  A row weighs as one slot, so that a run of rows
// without a slot (a batch's padding rows at its end: 4,168 of the flagship
// batch's 24,576) is shared among blocks rather than left to the last one.
__device__ __forceinline__ int xeq_ff_row_at(const int* __restrict__ ptr, int n, long long pos) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)__ldg(ptr + mid) + mid >= pos) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

struct XeqFF32Args {
  const float *x, *ef, *wf;
  const int *dst_ptr, *dst_slots, *slot_src, *slot_dst;
  const int4* units;
  float* out;
  long long* stamps;
};

// ---------------------------------------------------------------------------
// The pass.  STAMP: the phase probe's instance: lane 0 of each consumer warp
// and of the first producer warp add the clock64() cycles of their phases,
// written to stamps[(block * (n_cw + 1) + role) * XEQ_STAMPS] (role: the
// consumer warp, then n_cw the producer; fused_message.PHASES["f32_fwd"]
// and ["producer_f32"]).
// ---------------------------------------------------------------------------
template <bool STAMP>
__global__ void __launch_bounds__(XEQ_FF_THREADS, 1)
message_fwd_f32_kernel(const XeqFF32Args a, const XeqFF32Dims p) {
  extern __shared__ __align__(128) unsigned char ff_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ff_smem + p.off_bar);
  uint64_t* empty = full + XEQ_FF_MAXST;
  int* range = reinterpret_cast<int*>(empty + XEQ_FF_MAXST);  // the block's rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_ct = 32 * p.n_cw, grid = gridDim.x, b = blockIdx.x;
  XeqStamps<STAMP> sp;

  if (tid == 0) {
    for (int s = 0; s < p.nst; ++s) {
      xeq_mbar_init(full + s, 1);
      xeq_mbar_init(empty + s, p.n_cw);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const long long total = (long long)__ldg(a.dst_ptr + p.n_out) + p.n_out;
    range[0] = xeq_ff_row_at(a.dst_ptr, p.n_out, (long long)b * total / grid);
    range[1] = b + 1 == grid ? p.n_out
                             : xeq_ff_row_at(a.dst_ptr, p.n_out, (long long)(b + 1) * total / grid);
  }
  __syncthreads();
  const int r0 = range[0], r1 = range[1];
  const int P0 = __ldg(a.dst_ptr + r0), P1 = __ldg(a.dst_ptr + r1);
  const int n_tiles = (P1 - P0 + XEQ_F32_BT - 1) / XEQ_F32_BT;
  sp.mark(0);

  if (warp >= p.n_cw) {
    // ---- producer warp pw stages tiles pw, pw + XEQ_FF_PW, ...: lane t <
    // XEQ_F32_BT slot t of a tile
    const int pw = warp - p.n_cw, xw = p.hp + p.dp;
    for (int it = pw; it < n_tiles; it += XEQ_FF_PW) {
      const int s = it % p.nst, q = P0 + it * XEQ_F32_BT + lane;
      const bool ok = lane < XEQ_F32_BT && q < P1;
      int k = 0, src = 0, dst = -1;
      if (ok) {
        k = __ldg(a.dst_slots + q);
        src = __ldg(a.slot_src + k);
        dst = __ldg(a.slot_dst + k);
      }
      const uint32_t bytes =
          __reduce_add_sync(0xffffffffu, ok ? p.x_bytes + XEQ_F32_KF * 4 : 0);
      sp.mark(2);
      xeq_mbar_wait(empty + s, ((it / p.nst) & 1) ^ 1);
      sp.mark(1);
      unsigned char* st = ff_smem + s * p.stage;
      if (lane < XEQ_F32_BT) reinterpret_cast<int*>(st + p.off_dst)[lane] = dst;
      __syncwarp();
      if (lane == 0) xeq_mbar_arrive_tx(full + s, bytes);
      __syncwarp();
      if (ok) {
        xeq_bulk_g2s(st + lane * p.x_bytes, a.x + (int64_t)src * xw, p.x_bytes, full + s);
        xeq_bulk_g2s(st + p.off_e + lane * XEQ_F32_KF * 4, a.ef + (int64_t)k * XEQ_FPACK,
                     XEQ_F32_KF * 4, full + s);
      }
      sp.mark(3);
    }
    sp.mark(7);
    if (STAMP && pw == 0 && lane == 0)
      sp.write(a.stamps + ((int64_t)b * (p.n_cw + 1) + p.n_cw) * XEQ_STAMPS);
    return;
  }

  // ---- consumer thread tid: its unit (c0, c1: its columns of H, -1 where
  // none; j0, dim, yc: an irrep's first lane, lanes and harmonic column -
  // Kw, dim 0 in a scalar warp; dim and yc are the warp's, padding lanes
  // too)
  const int4 un = __ldg(a.units + tid);
  const int c0 = un.x, c1 = un.y, j0 = un.z, dim = un.w & 0xff, yc = un.w >> 8;
  const int wdim = __shfl_sync(0xffffffffu, dim, 0);  // the same in the whole warp
  const int ldim = wdim > 0 && c0 >= 0 ? dim : 0;     // the lanes this thread sums
  const int ni2 = 2 * p.ni, ocols = p.sdp + p.dp;
  float w0[XEQ_F32_KW], w1[XEQ_F32_KW];
#pragma unroll
  for (int f = 0; f < XEQ_F32_KW; ++f) {
    w0[f] = c0 >= 0 && f < p.kw ? __ldg(a.wf + (int64_t)f * p.hp + c0) : 0.f;
    w1[f] = c1 >= 0 && f < p.kw ? __ldg(a.wf + (int64_t)f * p.hp + c1) : 0.f;
  }
  sp.mark(0);
  // the open row's sums: an irrep's lanes, or a scalar pair's two columns
  float acc[XEQ_MAXM];
#pragma unroll
  for (int m = 0; m < XEQ_MAXM; ++m) acc[m] = 0.f;
  const int n_pad = (p.sdp - p.nd) + (p.dp - p.d);  // a row's padding columns
  // write row r of out: the thread's columns of the open row's sums (an
  // irrep's lanes SDp + j0 .., or a scalar pair's columns; a warp's lanes
  // of one l are contiguous in the row), the padding columns by the first
  // threads in turn
  const int col0 = wdim == 0 ? c0 - ni2 : p.sdp + j0;
  const int n_col = wdim == 0 ? (c0 >= 0) + (c1 >= 0) : ldim;
  auto put_row = [&](int r) {
    float* row = a.out + (int64_t)r * ocols;
#pragma unroll
    for (int m = 0; m < XEQ_MAXM; ++m)
      if (m < n_col) row[col0 + m] = acc[m];
    for (int c = tid; c < n_pad; c += n_ct)
      row[c < p.sdp - p.nd ? p.nd + c : p.nd + p.d + c] = 0.f;
  };
  // rows [ra, rb) of out as zeros, one contiguous run of float4s, each
  // written by one consumer thread
  auto zero_rows = [&](int ra, int rb) {
    float4* z = reinterpret_cast<float4*>(a.out + (int64_t)ra * ocols);
    const int64_t n4 = (int64_t)(rb - ra) * (ocols / 4);
    for (int64_t i = tid; i < n4; i += n_ct) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  };
  // slot t's messages into the open row, in list order: a new destination
  // first writes the open row and the rows of the range before it with no
  // slot
  int cur = -1, next = r0;
  auto add = [&](int dst, const float (&msg)[XEQ_MAXM]) {
    if (dst != cur) {  // the same in every consumer thread
      if (cur >= 0) put_row(cur);
      zero_rows(next, dst);
      cur = dst;
      next = dst + 1;
#pragma unroll
      for (int m = 0; m < XEQ_MAXM; ++m) acc[m] = 0.f;
    }
#pragma unroll
    for (int m = 0; m < XEQ_MAXM; ++m) acc[m] += msg[m];
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % p.nst, nt = min(XEQ_F32_BT, P1 - P0 - it * XEQ_F32_BT);
    xeq_mbar_wait(full + s, (it / p.nst) & 1);
    sp.mark(1);
    const unsigned char* st = ff_smem + s * p.stage;
    // two slots at a time (t and t + 1), so that the loads and products of
    // one overlap the other's; a second slot past the tile's end (its
    // stage rows hold old values) is formed and dropped
    for (int t = 0; t < nt; t += 2) {
      const int2 dd = *reinterpret_cast<const int2*>(st + p.off_dst + 4 * t);
      // the operands: the thread's columns of the source rows, an irrep's
      // lanes of gv and of the harmonic columns, the edge-feature rows
      float x0[2], x1[2], xv[2][XEQ_MAXM], ey[2][XEQ_MAXM];
      float4 e[2][XEQ_F32_KW / 4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* xr = reinterpret_cast<const float*>(st) + (t + i) * p.xs;
        const float* er = reinterpret_cast<const float*>(st + p.off_e) + (t + i) * XEQ_F32_KF;
        x0[i] = c0 >= 0 ? xr[c0] : 0.f;
        x1[i] = c1 >= 0 ? xr[c1] : 0.f;
#pragma unroll
        for (int m = 0; m < XEQ_MAXM; ++m) {
          xv[i][m] = m < ldim ? xr[p.hp + j0 + m] : 0.f;
          ey[i][m] = m < ldim ? er[p.kw + yc + m] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < XEQ_F32_KW / 4; ++q) e[i][q] = reinterpret_cast<const float4*>(er)[q];
      }
      sp.mark(2);
      // the filter at both columns over each edge-feature row, two partial
      // sums each (rows >= Kw of w are zero), and fo
      float fo0[2], fo1[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float f0a = 0.f, f0b = 0.f, f1a = 0.f, f1b = 0.f;
#pragma unroll
        for (int q = 0; q < XEQ_F32_KW / 4; ++q) {
          f0a += e[i][q].x * w0[4 * q];
          f1a += e[i][q].x * w1[4 * q];
          f0b += e[i][q].y * w0[4 * q + 1];
          f1b += e[i][q].y * w1[4 * q + 1];
          f0a += e[i][q].z * w0[4 * q + 2];
          f1a += e[i][q].z * w1[4 * q + 2];
          f0b += e[i][q].w * w0[4 * q + 3];
          f1b += e[i][q].w * w1[4 * q + 3];
        }
        fo0[i] = x0[i] * (f0a + f0b);
        fo1[i] = x1[i] * (f1a + f1b);
      }
      sp.mark(3);
      // the messages: an irrep's lanes gv fo[u] + ef[ycol] fo[ni + u] (m <
      // ldim), or a scalar pair's fo[2ni + c], fo[2ni + c + 1] (m = 0, 1)
      float msg[2][XEQ_MAXM];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int m = 0; m < XEQ_MAXM; ++m)
          msg[i][m] = wdim == 0 ? (m == 0 ? fo0[i] : m == 1 ? fo1[i] : 0.f)
                                : xv[i][m] * fo0[i] + ey[i][m] * fo1[i];
      sp.mark(4);
      add(dd.x, msg[0]);
      if (t + 1 < nt) add(dd.y, msg[1]);
      sp.mark(5);
    }
    __syncwarp();
    if (lane == 0) xeq_mbar_arrive(empty + s);  // the warp has read the stage
    sp.mark(6);
  }
  if (cur >= 0) put_row(cur);
  zero_rows(next, r1);
  sp.mark(5);
  if (STAMP && lane == 0) sp.write(a.stamps + ((int64_t)b * (p.n_cw + 1) + warp) * XEQ_STAMPS);
}

// Launch the pass (``stamps``: the phase probe's instance) with its layout
// on ``n_part`` blocks, n_cw consumer warps and the producer warps.
static int launch_fwd_f32(const void* x, const void* ef, const void* wf, const void* dst_ptr,
                          const void* dst_slots, const void* slot_src, const void* slot_dst,
                          const void* units, void* out, int n_out, int ni, int nd, int hp, int d,
                          int dp, int sdp, int kw, int kf, int n_cw, int n_part,
                          long long* stamps, cudaStream_t s) {
  XeqFF32Dims p;
  if (units == nullptr || n_part < 1 ||
      !fwd_f32_dims(p, n_out, ni, nd, hp, d, dp, sdp, kw, kf, n_cw))
    return (int)cudaErrorInvalidValue;
  const XeqFF32Args a = {(const float*)x, (const float*)ef, (const float*)wf,
                         (const int*)dst_ptr, (const int*)dst_slots, (const int*)slot_src,
                         (const int*)slot_dst, (const int4*)units, (float*)out, stamps};
  auto kernel = stamps ? message_fwd_f32_kernel<true> : message_fwd_f32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, 32 * (p.n_cw + XEQ_FF_PW), p.smem, s>>>(a, p);
  return (int)cudaGetLastError();
}
