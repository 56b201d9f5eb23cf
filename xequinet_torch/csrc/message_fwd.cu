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
// Bound on the H100: the useful work is ~27 kFLOP and ~4 kB of gathered
// rows per slot, so the function is memory bound (104.5 MB at the
// flagship batch in bf16: 0.031 ms at 3.35 TB/s).  The first version (1.451
// ms per launch in bf16) gave one thread each (destination row, output
// column), recomputed each slot's 21-term filter once per column that
// needed it on the FP32 pipes and gathered single x elements through L1 /
// L2: bound by latency and issue rate.
//
// The bf16 instance (the flagship's), message_fwd_tile_kernel: a block
// of 320 threads owns 16 consecutive destination rows, so its slots are
// one contiguous run of the CSR list by destination (dst_ptr /
// dst_slots), in row order.  It walks that run in tiles of 16 slots:
//  * the tile's x rows (live H + D columns) and first 32 edge-feature
//    columns are staged with cp.async (16-byte chunks);
//  * fw = ef[:, :32] @ wf[:32, :H] runs on the tensor cores (mma.sync
//    m16n8k16, bf16 operands, f32 accumulators; wf's live rows are held in
//    shared memory, rows >= Kw zero), and fo = rnd(gs * fw) is written in
//    place of gs;
//  * each thread owns two adjacent output columns for the whole block
//    (their gate and harmonic column read once) and adds the tile's
//    messages, rnd(gv fo[gate] + ef[ycol] fo[ni + gate]) or fo[2ni + c],
//    into its accumulators in slot order, writing a row when the
//    destination changes.
// Every output element is summed by one thread in slot order and written
// once: no atomics, and the result repeats from run to run.  73 KB of
// shared memory a block, three blocks per SM, so one block's copies
// overlap the others' compute.
// The f32 instance keeps the first version's kernel, message_fwd_kernel
// (FP32 FMAs, no TF32 in this port): one thread per (destination row,
// output column), a block of 8 rows and a 128-column tile, slots staged
// XEQ_STAGE at a time, the filter recomputed per column in registers.
//
#include "message_tile.cuh"

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

// ---------------------------------------------------------------------------
// bf16 instance: the slot-tile kernel
// ---------------------------------------------------------------------------
#define XEQ_FT_THREADS 320
#define XEQ_FT_WARPS (XEQ_FT_THREADS / 32)
#define XEQ_FT_NP 2     // output column pairs a thread owns: SDp + Dp <= 4 * 320
#define XEQ_FT_ROWS 16  // destination rows a block owns

// Sizes and shared-memory offsets (bytes) of the tile kernel, from the host.
struct XeqFwdDims {
  int n_out, ni, h, hp, d, dp, sdp, nd, kw;
  int hs;     // H rounded up to 16: the N of fw
  int ht8;    // H rounded up to 8: the gs part of a staged x row
  int dt8;    // D rounded up to 8: its gv part
  int xs_st;  // staged x row: [gs (ht8) | gv (dt8)] + 8
  int w_st;   // wf_s row: hs rounded up to 64, + 8
  int off_e, off_dst, off_wf, smem;
};

__global__ void __launch_bounds__(XEQ_FT_THREADS, 3)
message_fwd_tile_kernel(const xeq_bf16* __restrict__ x, const xeq_bf16* __restrict__ ef,
                        const xeq_bf16* __restrict__ wf, const int* __restrict__ dst_ptr,
                        const int* __restrict__ dst_slots, const int* __restrict__ slot_src,
                        const int* __restrict__ slot_dst, const int* __restrict__ lane_gate,
                        const int* __restrict__ lane_ycol, float* __restrict__ out,
                        const XeqFwdDims p) {
  extern __shared__ __align__(16) unsigned char fwd_smem[];
  xeq_bf16* x_s = (xeq_bf16*)fwd_smem;                     // [BT][xs_st]; fo in place of gs
  const xeq_bf16* e_s = (const xeq_bf16*)(fwd_smem + p.off_e);  // [BT][EST]
  int* dst_s = (int*)(fwd_smem + p.off_dst);               // [BT]
  xeq_bf16* wf_s = (xeq_bf16*)(fwd_smem + p.off_wf);       // [32][w_st] live rows of wf
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;  // mma fragment: row group, column pair
  const int ni2 = 2 * p.ni, n8 = p.hs >> 3, ocols = p.sdp + p.dp, xw = p.hp + p.dp;

  xeq_load_wf(wf_s, p.w_st, wf, p.kw, p.h, p.hp, p.hs, XEQ_FT_THREADS);
  // this thread's output column pairs c, c+1: a scalar message (fo column
  // 2ni + c, kind 1), two vector lanes (their gates and harmonic columns,
  // kind 2) or padding (kind 0)
  int col[XEQ_FT_NP], kind[XEQ_FT_NP], ga[XEQ_FT_NP][2], ya[XEQ_FT_NP][2];
#pragma unroll
  for (int i = 0; i < XEQ_FT_NP; ++i) {
    const int c = 2 * (tid + i * XEQ_FT_THREADS);
    col[i] = c;
    kind[i] = 0;
    ga[i][0] = ga[i][1] = ya[i][0] = ya[i][1] = 0;
    if (c < p.sdp) {
      if (c < p.nd) kind[i] = 1;
    } else if (c < ocols && c - p.sdp < p.d) {
      kind[i] = 2;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = c - p.sdp + q;
        if (j < p.d) {
          ga[i][q] = __ldg(lane_gate + j);
          ya[i][q] = __ldg(lane_ycol + j) - p.kw;
        }
      }
    }
  }
  float2 acc[XEQ_FT_NP];
#pragma unroll
  for (int i = 0; i < XEQ_FT_NP; ++i) acc[i] = make_float2(0.f, 0.f);
  // acc to row r (zero on the pairs with no column), one float2 store each
  auto put = [&](int r) {
#pragma unroll
    for (int i = 0; i < XEQ_FT_NP; ++i)
      if (col[i] < ocols) *reinterpret_cast<float2*>(out + (int64_t)r * ocols + col[i]) = acc[i];
  };

  const int r0 = blockIdx.x * XEQ_FT_ROWS;
  const int r1 = min(r0 + XEQ_FT_ROWS, p.n_out);
  const int p1 = __ldg(dst_ptr + r1);
  int cur = r0;
  for (int base = __ldg(dst_ptr + r0); base < p1; base += XEQ_BT) {
    const int n = min(XEQ_BT, p1 - base);
    // stage the tile: slot t by warp t % XEQ_FT_WARPS; zeros past the run
    for (int t = warp; t < XEQ_BT; t += XEQ_FT_WARPS) {
      const bool ok = t < n;
      int k = 0, src = 0, dst = -1;
      if (ok) {
        k = __ldg(dst_slots + base + t);
        src = __ldg(slot_src + k);
        dst = __ldg(slot_dst + k);
      }
      const XeqSeg sg[2] = {
          {x_s + t * p.xs_st, x + (int64_t)src * xw, p.ht8, p.hp, (p.ht8 + p.dt8) >> 3},
          {(xeq_bf16*)e_s + t * XEQ_BT_EST, ef + (int64_t)k * XEQ_FPACK, XEQ_BT_KE, 0,
           XEQ_BT_KE / 8}};
      xeq_stage_segs(sg, ok);
      if (lane == 0) dst_s[t] = dst;
    }
    xeq_cp_commit();
    xeq_cp_wait_all();
    __syncthreads();

    // fw on the tensor cores, one n8 column tile per warp at a time, and
    // fo = rnd(gs * fw) in place of gs
    {
      uint32_t a[2][4];
      xeq_frag_a(a, e_s, XEQ_BT_EST);
      for (int nt = warp; nt < n8; nt += XEQ_FT_WARPS) {
        const int n = nt * 8 + gq;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const xeq_bf16* w0 = wf_s + (ks * 16 + 2 * cq) * p.w_st + n;
          xeq_mma(c, a[ks], xeq_pack(w0[0], w0[p.w_st]),
                  xeq_pack(w0[8 * p.w_st], w0[9 * p.w_st]));
        }
        const int h0 = nt * 8 + 2 * cq;
        if (h0 >= p.h) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          xeq_bf16* xr = x_s + (gq + 8 * half) * p.xs_st + h0;
          const float2 gs = xeq_f2(xr);
          // odd H: column H is padding
          xeq_st2(xr, gs.x * c[2 * half], h0 + 1 < p.h ? gs.y * c[2 * half + 1] : 0.f);
        }
      }
    }
    __syncthreads();

    // the tile's messages added by destination, in slot order
    for (int q = 0; q < n; ++q) {
      const int i = dst_s[q];
      if (i != cur) {  // the same for every thread of the block
        put(cur);
#pragma unroll
        for (int ip = 0; ip < XEQ_FT_NP; ++ip) acc[ip] = make_float2(0.f, 0.f);
        for (int r = cur + 1; r < i; ++r) put(r);
        cur = i;
      }
      const xeq_bf16* xr = x_s + q * p.xs_st;
      const xeq_bf16* er = e_s + q * XEQ_BT_EST + p.kw;
#pragma unroll
      for (int ip = 0; ip < XEQ_FT_NP; ++ip) {
        if (kind[ip] == 1) {
          const float2 fo = xeq_f2(xr + ni2 + col[ip]);
          acc[ip].x += fo.x;
          if (col[ip] + 1 < p.nd) acc[ip].y += fo.y;
        } else if (kind[ip] == 2) {
          const int j = col[ip] - p.sdp;
          const float2 gv = xeq_f2(xr + p.ht8 + j);
          acc[ip].x += xeq_rnd<true>(gv.x * xeq_f(xr[ga[ip][0]]) +
                                     xeq_f(er[ya[ip][0]]) * xeq_f(xr[p.ni + ga[ip][0]]));
          if (j + 1 < p.d)
            acc[ip].y += xeq_rnd<true>(gv.y * xeq_f(xr[ga[ip][1]]) +
                                       xeq_f(er[ya[ip][1]]) * xeq_f(xr[p.ni + ga[ip][1]]));
        }
      }
    }
    __syncthreads();  // the stage is read before the next tile's copies
  }
  put(cur);
#pragma unroll
  for (int ip = 0; ip < XEQ_FT_NP; ++ip) acc[ip] = make_float2(0.f, 0.f);
  for (int r = cur + 1; r < r1; ++r) put(r);
}

static int launch_fwd_tiles(const void* x, const void* ef, const void* wf, const void* dst_ptr,
                            const void* dst_slots, const void* slot_src, const void* slot_dst,
                            const void* lane_gate, const void* lane_ycol, void* out, int n_out,
                            int ni, int nd, int hp, int d, int dp, int sdp, int kw, int kf,
                            cudaStream_t s) {
  XeqFwdDims p;
  p.n_out = n_out; p.ni = ni; p.h = nd + 2 * ni; p.hp = hp; p.d = d; p.dp = dp; p.sdp = sdp;
  p.nd = nd; p.kw = kw;
  p.hs = xeq_round_up(p.h, 16);
  p.ht8 = xeq_round_up(p.h, 8);
  p.dt8 = xeq_round_up(d, 8);
  p.xs_st = p.ht8 + p.dt8 + 8;
  p.w_st = xeq_round_up(p.hs, 64) + 8;
  p.off_e = XEQ_BT * p.xs_st * 2;
  p.off_dst = p.off_e + XEQ_BT * XEQ_BT_EST * 2;
  p.off_wf = xeq_round_up(p.off_dst + XEQ_BT * 4, 16);
  p.smem = p.off_wf + XEQ_BT_KE * p.w_st * 2;
  if (kf > XEQ_BT_KE || kf - kw > XEQ_MAXY || p.ht8 > hp || p.dt8 > dp || nd > sdp ||
      sdp + dp > 4 * XEQ_FT_THREADS || p.smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      message_fwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  message_fwd_tile_kernel<<<(n_out + XEQ_FT_ROWS - 1) / XEQ_FT_ROWS, XEQ_FT_THREADS, p.smem,
                            s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const int*)dst_ptr,
      (const int*)dst_slots, (const int*)slot_src, (const int*)slot_dst, (const int*)lane_gate,
      (const int*)lane_ycol, (float*)out, p);
  return (int)cudaGetLastError();
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
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_fwd_tiles(x, ef, wf, dst_ptr, dst_slots, slot_src, slot_dst, lane_gate,
                            lane_ycol, out, n_out, ni, nd, hp, d, dp, sdp, kw, kf, s);
  const int rows_per_block = 8;
  dim3 grid((n_out + rows_per_block - 1) / rows_per_block, (sdp + dp) / 128);
  message_fwd_kernel<float, false><<<grid, 128, 0, s>>>(
      (const float*)x, (const float*)ef, (const float*)wf, (const int*)dst_ptr,
      (const int*)dst_slots, (const int*)slot_src, (const int*)slot_dst, (const int*)lane_gate,
      (const int*)lane_ycol, (float*)out, n_out, rows_per_block, ni, nd, hp, d, dp, sdp, kw, kf);
  return (int)cudaGetLastError();
}
