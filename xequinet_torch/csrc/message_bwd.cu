// First-order backward of one XPaiNN message block on Hopper: the VJP of
// message_fwd.cu w.r.t. (x_cat, edge_feat, wf_aug) for a cotangent g on
// the aggregate.  This is what forces (-dE/dpos) run through.
//
// Replaces: xequinet_tpu/ops/pallas_message.py::_bwd_kernel (:331),
// launched by _mega_bwd_call (:458-557).
//
// Per slot k (destination i, source s), with gm = g[i], gms_s = gm[:SDp],
// gms_v = gm[SDp:] and the forward recomputed (fw = ef[k] @ wf, fo):
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
// Bound on the H100: the function reads x, ef, g and writes dx, d_ef and
// d_wf once, 186.5 MB at the flagship batch in bf16 (0.056 ms at 3.35
// TB/s); its three filter contractions are ~110 kFLOP per slot, 0.02 ms
// on the bf16 tensor cores.  Memory bound.  The first version (5.585 ms
// per launch in bf16) ran the contractions on the FP32 pipes out of
// shared memory, one 168 KB block per SM, and its dx walk recomputed the
// filter and the gate sums of every slot.
//
// The bf16 instances are two passes and the reduction.  The tile pass is
// chosen by shape (ops/fused_message.py: hopper_route, then tile_route):
//  * at the flagship widths (bf16, Kf <= 32, H <= 576, runs of irreps of
//    one l of even multiplicity) the Hopper tile pass,
//    message_bwd_hopper_kernel (message_bwd_hopper.cuh, its notes there): a
//    producer warp stages whole rows with cp.async.bulk into a ring of
//    stages completed on mbarriers, three consumer warpgroups split H
//    between them and run the three contractions as wgmma from shared
//    memory with H on M, the elementwise steps multiply bf16x2 pairs, and
//    each slot's scratch row leaves as two bulk stores; no barrier of the
//    whole block runs per tile.  On the flagship batch its tile pass takes
//    0.65 ms where this file's pass took 0.95 (NVIDIA H100 80GB HBM3, 700
//    W; xequinet_torch/tools/bwd_compare.py); its stream floor (the same
//    streams, a near-empty body) takes 0.29 ms, and the rest is its
//    elementwise steps (C, A and B in that order) and the waits between
//    them (xequinet_torch/tools/bwd_stream_floor.py splits it by phase);
//  * elsewhere message_bwd_tile_kernel below, which the Hopper pass
//    replaced at those widths: persistent blocks of 512 threads, one per
//    SM, walk tiles of XEQ_BT = 16 consecutive slots (tile = block + i *
//    grid, so all SMs work on neighbouring slots and the x / g rows they
//    gather stay in L2).  The next tile's x rows (live H + D columns), g
//    rows and edge-feature columns (Kf rounded up to 32) are staged with cp.async
//    (16-byte chunks, zero-filled for padding slots) while the current
//    one is computed: two stages, 198 KB of shared memory with the live
//    rows of wf and the index maps at the flagship widths; the slot
//    indices are loaded one tile ahead of the copies.  The three filter
//    contractions run on the tensor cores (mma.sync m16n8k16, bf16
//    operands, f32 accumulators; a bf16 product is exact in f32, so only
//    the order of the sums moves):
//      fw   = ef[:, :32] @ wf[:32, :H]        (rows >= Kw of wf are zero)
//      d_ef[:, :Kw] = dfw @ wf^T              (K = H, split in 4 quarters
//                                              summed in a fixed order)
//      d_wf partial += ef^T @ dfw             (kept in registers across
//                                              all of the block's tiles)
//    The elementwise steps take one warp per slot (the dfo gate sums; dgv
//    with the harmonic d_ef columns as per-lane sums of drsh and a
//    butterfly) or follow the mma fragments (dfw, dgs, fo, in pairs).
//    Each valid slot's [dgs | dgv] row (bf16: both are rounded to bf16 in
//    the TPU kernel, so the scratch loses nothing) goes to a scratch array
//    at the slot's position in the CSR list by source (plan["src_pos"]).
//    The copies are hidden behind the compute; what bounds the pass is its
//    elementwise steps (16 warps per SM, one block: the staging takes the
//    shared memory; by phase, C 30%, B 22%, A 18%, the waits and block
//    barriers 14%, the products 12%).
//  * message_bwd_dx_rows_kernel: one warp per source row sums its slots'
//    scratch rows in list order (contiguous, 16-byte loads) and writes each
//    dx element once, near the card's memory rate (xeq_rows_sum; it and
//    the staging and mma helpers are in message_tile.cuh, shared with
//    message_bwd2.cu and message_fwd.cu).  This replaces the TPU
//    kernel's per-block window tiles and their overlap-add (:541-546): the
//    scatter by src becomes a contiguous gather by src, and nothing is
//    recomputed.
//  * xeq_dwf_reduce_kernel (message_common.cuh): the per-block d_wf
//    partials summed in block order.
// Wider shapes (instance WIDE: Kf > 32 or H > 768): fw runs over 32-row
// K slices of wf and d_ef's filter columns over 32-column tiles; the Kf x
// H d_wf partial no longer fits a block's registers (147k floats at Kf =
// 128, H = 1152), so each slot's bf16 dfw row (rounded to bf16 in the TPU
// kernel too) goes to a scratch and xeq_dwf_pass (message_tile.cuh) forms
// the per-block partials on the tensor cores.  Where two stages and wf's
// live rows do not fit (Kf = 128: wf takes 149 KB; H = 1152: a stage is
// 109 KB), wf's fragments are read from L2, and at H = 1152 one stage is
// staged while the tile's rows are read (as message_bwd2.cu does).
// The f32 operands at the widths of ops/fused_message.py::f32_route (the
// flagship's: Kw <= 24, Kf <= 32, at most 9 consumer warps of units) take
// the f32 tile pass, message_bwd_f32_kernel (message_f32_tile.cuh, its
// notes there; no TF32 in this port): a producer warp's bulk copies into a
// ring of 8-slot stages, consumer threads each owning an irrep or two
// scalar columns with their columns of wf and of the d_wf partial in
// registers, the filter formed once per slot and column on the FP32
// pipes, each block walking a contiguous range of the list by source so
// that dx is summed in registers (no scratch), d_ef's columns summed over
// H by recursive halving and a fixed warp order; then
// xeq_dwf_reduce_kernel.  On the flagship batch it replaced walk kernels
// that took 6.04 ms (slot pass 4.04, dx walk 1.96; NVIDIA H100 80GB HBM3,
// 700 W; xequinet_torch/tools/bwd_compare.py --dtype float32).
// The walk kernels, the first version's FP32 kernels, take the other f32
// widths and any bf16 shape the tile pass cannot hold:
// message_bwd_dx_kernel, one thread per (source row, x column)
// walking the CSR list by source and recomputing each slot's contribution
// (the filter's first 32 rows in registers, the rest in 32-row slices),
// and message_bwd_slot_kernel, one block per (contiguous slot range,
// column chunk) with the d_ef rows' partials and a d_wf partial in shared
// memory (the whole width in one chunk at the flagship's; chunks of 128
// columns, summed by xeq_def_reduce_kernel, where it does not fit).
//
// No float atomics anywhere, so results repeat bit for bit.  Padding slots
// (dst2 == BN) and slots past the covered chunk range (slot_dst < 0 in
// the wrapper's plan) add nothing and get zero d_ef rows (:547-552).
// Contracts from the packing (pallas_message.py:151-171 and
// xpainn.py:282-295): wf_aug rows >= Kw = num_basis+1 are zero and
// edge_feat columns >= Kf = Kw + nY are zero, so d_ef and d_wf are zero
// outside the live columns / rows.
//
// Rounding in bf16 mode mirrors _bwd_kernel (:411-433): fo, dgv, drsh,
// dgs and dfw are rounded to bf16; sums are f32.
#include "message_bwd_hopper.cuh"
#include "message_f32_tile.cuh"

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
          const float fw = xeq_filter_full(e, w, wf, hp, wcol, kw);
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

// One block per (contiguous slot range, column chunk of hc filter columns;
// hc = H in one chunk when the shared memory fits, see xeq_walk_chunks):
// per 16 slots the chunk's dfw columns, the d_wf partial of the chunk, and
// the d_ef rows' partial sums over the chunk.  With one chunk the d_ef rows
// are written whole; with several, each chunk writes its partial row
// (f < kf) to def_part [n_hc, n_slots, kf] and xeq_def_reduce_kernel sums
// them in chunk order.  The harmonic terms of d_ef come with chunk 0.
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
                        float* __restrict__ d_ef, float* __restrict__ def_part,
                        float* __restrict__ dwf_part,
                        int n_slots, int slots_per_block, int ni, int h_dim,
                        int hp, int dp, int sdp, int kw, int kf, int hc) {
  extern __shared__ float smem[];
  float* fo_s = smem;                      // [TS][ni]   edge-gate filter_out
  float* dfw_s = fo_s + XEQ_TS * ni;       // [TS][hc]
  float* ef_s = dfw_s + XEQ_TS * hc;       // [TS][Kf]
  float* dwf_s = ef_s + XEQ_TS * kf;       // [Kf][hc]  this block's partial
  float* wf_s = dwf_s + kf * hc;           // [Kw][hc]  live rows of wf
  __shared__ int src_s[XEQ_TS], dst_s[XEQ_TS];

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
    wf_s[f * hn + hh] = xeq_ld(wf, (int64_t)f * hp + c0 + hh);
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
    // A1 (chunk 0): edge-gate filter_out fo[ni + u] of each slot of the
    // step, XEQ_ILP items per thread at a time so their loads overlap
    for (int i0 = tid; first && i0 < XEQ_TS * ni; i0 += XEQ_ILP * nthr) {
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
          for (int f = 0; f < kw; ++f) fw += ef_s[t * kf + f] * xeq_ld(wf, (int64_t)f * hp + h);
          v[c] = xeq_rnd<BF16>(xeq_ld(x, (int64_t)src_s[t] * xs + h) * fw);
        }
      }
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        if (i < XEQ_TS * ni) fo_s[i] = v[c];
      }
    }
    // A2: dfw = rnd(dfo * x) at the chunk's hidden columns, XEQ_ILP items
    // per thread at a time
    for (int i0 = tid; i0 < XEQ_TS * hn; i0 += XEQ_ILP * nthr) {
      float v[XEQ_ILP];
#pragma unroll
      for (int c = 0; c < XEQ_ILP; ++c) {
        const int i = i0 + c * nthr;
        v[c] = 0.f;
        if (i >= XEQ_TS * hn) continue;
        const int t = i / hn, h = c0 + i - t * hn;
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
        if (i < XEQ_TS * hn) dfw_s[i] = v[c];
      }
    }
    __syncthreads();
    // A3: d_wf partial, element (f, h) owned by one thread, slots in order
    for (int i = tid; i < kf * hn; i += nthr) {
      const int f = i / hn, hh = i - f * hn;
      float acc = dwf_s[i];
#pragma unroll
      for (int t = 0; t < XEQ_TS; ++t) acc += ef_s[t * kf + f] * dfw_s[t * hn + hh];
      dwf_s[i] = acc;
    }
    // B: d_ef rows (or their chunk partials), one warp per slot
    for (int t = warp; t < XEQ_TS; t += nthr / 32) {
      const int k = base + t;
      if (k >= k1) continue;
      float* row = chunked ? def_part + ((int64_t)blockIdx.y * n_slots + k) * kf
                           : d_ef + (int64_t)k * XEQ_FPACK;
      const int width = chunked ? kf : XEQ_FPACK;
      if (dst_s[t] < 0) {
        for (int f = lane; f < width; f += 32) row[f] = 0.f;
        continue;
      }
      for (int f = 0; f < kw; ++f) {
        float acc = 0.f;
        for (int hh = lane; hh < hn; hh += 32)
          acc += dfw_s[t * hn + hh] * wf_s[f * hn + hh];
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) row[f] = acc;
      }
      const T* gr = g + (int64_t)dst_s[t] * gs;
      for (int y = 0; y < n_y; ++y) {
        float acc = 0.f;
        for (int q = ylane_ptr[y] + lane; first && q < ylane_ptr[y + 1]; q += 32) {
          const int j = ylane_idx[q];
          acc += xeq_rnd<BF16>(fo_s[t * ni + lane_gate[j]] * xeq_ld(gr, sdp + j));
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
static size_t bwd_slot_smem(int ni, int hc, int kw, int kf) {
  return sizeof(float) * ((size_t)XEQ_TS * ni + (size_t)XEQ_TS * hc + (size_t)XEQ_TS * kf +
                          (size_t)kf * hc + (size_t)kw * hc);
}

template <typename T, bool BF16>
static int launch_bwd(const void* x, const void* ef, const void* wf,
                      const void* g, const void* src_ptr,
                      const void* src_slots, const void* slot_src,
                      const void* slot_dst, const void* lane_gate,
                      const void* lane_ycol, const void* gate_lane0,
                      const void* gate_dim, const void* ylane_ptr,
                      const void* ylane_idx, void* def_part, void* dx, void* d_ef,
                      void* dwf_part, void* dwf, int n_rows, int n_slots,
                      int n_part, int ni, int h_dim, int hp, int d, int dp,
                      int sdp, int kw, int kf, int n_hc, cudaStream_t s) {
  if (n_hc != xeq_walk_chunks(bwd_slot_smem(ni, h_dim, kw, kf), h_dim) ||
      (n_hc > 1 && def_part == nullptr))
    return (int)cudaErrorInvalidValue;
  const int hc = n_hc == 1 ? h_dim : XEQ_WALK_HC;
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
  const size_t smem = bwd_slot_smem(ni, hc, kw, kf);
  cudaError_t err = cudaFuncSetAttribute(
      message_bwd_slot_kernel<T, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per = ((n_slots + n_part - 1) / n_part + XEQ_TS - 1) / XEQ_TS * XEQ_TS;
  message_bwd_slot_kernel<T, BF16><<<dim3(n_part, n_hc), XEQ_SLOT_THREADS, smem, s>>>(
      (const T*)x, (const T*)ef, (const T*)wf, (const T*)g,
      (const int*)slot_src, (const int*)slot_dst, (const int*)lane_gate,
      (const int*)lane_ycol, (const int*)gate_lane0, (const int*)gate_dim,
      (const int*)ylane_ptr, (const int*)ylane_idx, (float*)d_ef, (float*)def_part,
      (float*)dwf_part, n_slots, per, ni, h_dim, hp, dp, sdp, kw, kf, hc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_hc > 1 && n_slots > 0) {
    const int64_t n = (int64_t)n_slots * XEQ_FPACK;
    xeq_def_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        (const float*)def_part, (float*)d_ef, n_hc, n_slots, kf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)dwf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 instance: the slot-tile pass on the tensor cores (its layout,
// bwd_tile_dims, its staging, xeq_tile_load, and the dx pass are in
// message_tile.cuh, shared with bwd_stream_floor.cu)
// ---------------------------------------------------------------------------
// WF_SMEM: wf's live rows copied to shared memory (their fragment loads are
// then shared-memory loads); else read from L2.  WIDE: Kf > 32 or H > 768,
// so fw runs over 32-row K slices and each slot's dfw row goes to the d_wf
// pass instead of a partial in registers (compiled only where needed: the
// other instance keeps the flagship's registers).
// STAMP: the instance of the phase probe (xeq_bwd_phases, on no model
// path): thread 0 adds the clock64() cycles of each phase of its block,
// written to stamps[block][XEQ_STAMPS] (prologue, the wait for a tile and
// the block barrier, A, B, C, D, E, epilogue).
template <bool WF_SMEM, bool WIDE, bool STAMP = false>
__global__ void __launch_bounds__(XEQ_BT_THREADS, 1)
message_bwd_tile_kernel(const xeq_bf16* __restrict__ x, const xeq_bf16* __restrict__ ef,
                        const xeq_bf16* __restrict__ wf, const xeq_bf16* __restrict__ g,
                        const int* __restrict__ slot_src, const int* __restrict__ slot_dst,
                        const int* __restrict__ src_pos, const int* __restrict__ lane_gate,
                        const int* __restrict__ lane_ycol,
                        const int* __restrict__ gate_lane0,
                        const int* __restrict__ gate_dim, xeq_bf16* __restrict__ rows,
                        xeq_bf16* __restrict__ dfw_rows, float* __restrict__ d_ef,
                        float* __restrict__ dwf_part, const XeqTileDims p,
                        long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  XeqStamps<STAMP> sp;
  xeq_bf16* wf_s = (xeq_bf16*)(tile_smem + p.off_wf);    // [kwp][w_st] live rows of wf
  xeq_bf16* dfw_s = (xeq_bf16*)(tile_smem + p.off_dfw);  // [BT][w_st]
  float* dfo_s = (float*)(tile_smem + p.off_dfo);        // [BT][dfo_st]; then d_ef quarters
  int* lane_tab = (int*)(tile_smem + p.off_tab);         // [dt8]: gate | harmonic col << 16
  int* gate_tab = lane_tab + p.dt8;                      // [ni]: first lane | lanes << 16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;  // mma fragment: row group, column pair
  const int ni2 = 2 * p.ni, n8 = p.hs >> 3, n_y = p.kf - p.kw;
  // not WIDE (Kf <= 32): the staged edge-feature stride and K width as
  // constants
  const int est = WIDE ? p.est : XEQ_BT_KE + 8, kwp = WIDE ? p.kwp : XEQ_BT_KE;
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

  // the slot indices go one tile ahead of the copies, so that issuing a
  // tile's copies never waits on a load; with two stages the next tile's
  // copies are issued as this tile starts, with one once its rows are read
  const int grid = gridDim.x;
  if ((int)blockIdx.x < n_tiles)
    xeq_tile_load(
        tile_smem, est, blockIdx.x * XEQ_BT,
        xeq_slot_idx(blockIdx.x, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr), p,
        x, g, ef);
  xeq_cp_commit();
  XeqSlotIdx ahead =
      xeq_slot_idx(blockIdx.x + grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr);
  sp.mark(0);
  for (int it = 0;; ++it) {
    const int tl = blockIdx.x + it * grid;
    if (tl >= n_tiles) break;
    unsigned char* st = tile_smem + (it & (p.nst - 1)) * p.stage;
    xeq_cp_wait_all();
    __syncthreads();  // this tile has landed; the other stage is free
    if (p.nst == 2) {
      if (tl + grid < n_tiles)
        xeq_tile_load(tile_smem + ((it + 1) & 1) * p.stage, est, (tl + grid) * XEQ_BT, ahead, p, x, g,
                      ef);
      xeq_cp_commit();
      ahead =
          xeq_slot_idx(tl + 2 * grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr);
    }
    sp.mark(1);
    xeq_bf16* x_s = (xeq_bf16*)st;
    const xeq_bf16* g_s = (const xeq_bf16*)(st + p.off_g);
    const xeq_bf16* e_s = (const xeq_bf16*)(st + p.off_e);
    const int* pos_s = (const int*)(st + p.off_pos);
    const int k_w = tl * XEQ_BT + warp;  // the slot of this warp in phases A, C, E

    // A: the gate sums of dfo, one warp per slot, a lane per irrep
    {
      const xeq_bf16* xv = x_s + warp * p.xs_st + p.ht8;
      const xeq_bf16* gv = g_s + warp * p.gs_st + p.sd8;
      const xeq_bf16* er = e_s + warp * est + p.kw;
      float* dr = dfo_s + warp * p.dfo_st;
      for (int u = lane; u < p.ni; u += 32) {
        const int tab = gate_tab[u], l0 = tab & 0xffff, m1 = tab >> 16;
        float sv = 0.f, sr = 0.f;
#pragma unroll
        for (int m = 0; m < XEQ_MAXM; ++m) {
          if (m < m1) {
            const int j = l0 + m;
            const float gm = xeq_f(gv[j]);
            sv += xeq_rnd<true>(xeq_f(xv[j]) * gm);
            sr += xeq_rnd<true>(xeq_f(er[lane_tab[j] >> 16]) * gm);
          }
        }
        dr[u] = sv;
        dr[p.ni + u] = sr;
      }
    }
    __syncthreads();
    sp.mark(2);

    // B: fw on the tensor cores, one n8 column tile per warp at a time (K
    // in 32-row slices of wf, the first slice's A fragments held); per
    // element dfw (to dfw_s), dgs (to the scratch row) and, in the gate
    // columns, fo (in place of gs, which nothing reads after this)
    {
      uint32_t a[2][4];
      xeq_frag_a(a, e_s, est);
      for (int nt = warp; nt < n8; nt += XEQ_BT_WARPS) {
        const int n = nt * 8 + gq;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        uint32_t b0, b1;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          xeq_wf_b(b0, b1, wfp, wst, ks * 16, n);
          xeq_mma(c, a[ks], b0, b1);
        }
        if constexpr (WIDE) {
          for (int k0 = XEQ_BT_KE; k0 < kwp; k0 += XEQ_BT_KE) {
            uint32_t a2[2][4];
            xeq_frag_a(a2, e_s + k0, est);
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              xeq_wf_b(b0, b1, wfp, wst, k0 + ks * 16, n);
              xeq_mma(c, a2[ks], b0, b1);
            }
          }
        }
        const int h0 = nt * 8 + 2 * cq;  // even, as 2 ni is: a pair lies on
                                         // one side of the gate columns
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int t = gq + 8 * half;
          xeq_bf16* xr = x_s + t * p.xs_st + h0;
          const float2 fw = make_float2(c[2 * half], c[2 * half + 1]);
          float2 dfw = make_float2(0.f, 0.f), dgs = dfw;
          if (h0 < p.h) {
            const float2 gs = xeq_f2(xr);
            const float2 dfo = h0 < ni2
                                   ? *reinterpret_cast<const float2*>(dfo_s + t * p.dfo_st + h0)
                                   : xeq_f2(g_s + t * p.gs_st + h0 - ni2);
            dfw = make_float2(dfo.x * gs.x, dfo.y * gs.y);
            dgs = make_float2(dfo.x * fw.x, dfo.y * fw.y);
            if (h0 + 1 >= p.h) dfw.y = dgs.y = 0.f;  // odd H: column H is padding
            if (h0 < ni2) xeq_st2(xr, gs.x * fw.x, gs.y * fw.y);
          }
          xeq_st2(dfw_s + t * p.w_st + h0, dfw.x, dfw.y);
          const int pos = pos_s[t];
          if (pos >= 0 && h0 < p.ht8) xeq_st2(rows + (int64_t)pos * p.rs + h0, dgs.x, dgs.y);
        }
      }
    }
    __syncthreads();
    sp.mark(3);

    // C: one warp per slot, lane pairs: dgv to the scratch row, and drsh
    // summed into the harmonic d_ef columns (per lane in lane order, then a
    // butterfly over the warp)
    {
      const xeq_bf16* xr = x_s + warp * p.xs_st;
      const xeq_bf16* gv = g_s + warp * p.gs_st + p.sd8;
      const int pos = pos_s[warp];
      float hy[XEQ_MAXY];
#pragma unroll
      for (int y = 0; y < XEQ_MAXY; ++y) hy[y] = 0.f;
      for (int j0 = 2 * lane; j0 < p.dt8; j0 += 64) {
        float dgv[2] = {0.f, 0.f};
        const float2 gm = xeq_f2(gv + j0);
        const int2 tab = *reinterpret_cast<const int2*>(lane_tab + j0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (j0 + q < p.d) {
            const int tq = q ? tab.y : tab.x, u = tq & 0xffff, y = tq >> 16;
            const float gq2 = q ? gm.y : gm.x;
            dgv[q] = xeq_f(xr[u]) * gq2;
            const float r = xeq_rnd<true>(xeq_f(xr[p.ni + u]) * gq2);
#pragma unroll
            for (int yy = 0; yy < XEQ_MAXY; ++yy) hy[yy] += yy == y ? r : 0.f;
          }
        }
        if (pos >= 0) xeq_st2(rows + (int64_t)pos * p.rs + p.ht8 + j0, dgv[0], dgv[1]);
      }
      const float mine = xeq_harmonic_sums(hy);
      if (k_w < p.n_slots && lane < n_y) d_ef[(int64_t)k_w * XEQ_FPACK + p.kw + lane] = mine;
      // the slot's dfw row, for the d_wf pass (every slot of the tile: zero
      // where it adds nothing)
      if constexpr (WIDE)
        xeq_copy_row(dfw_rows + (int64_t)k_w * p.hs, dfw_s + warp * p.w_st, p.hs >> 3);
    }
    sp.mark(4);

    // D1: d_ef[:, f < kwp] = dfw @ wf^T on the tensor cores; warp w takes
    // the column tiles w % 4 (+ 4 j) and K quarter w / 4, its partials to
    // shared memory
    xeq_def_quarters(dfw_s, p.w_st, wfp, wst, p.hs, kwp, dfo_s);
    // D2: the block's d_wf partial += ef^T @ dfw on the tensor cores, in
    // the warp's own column tiles (rows f of two m16 tiles)
    if constexpr (!WIDE) {
      uint32_t a[2][4];
      xeq_frag_at(a, e_s, est);
#pragma unroll
      for (int i = 0; i < XEQ_BT_NTW; ++i) {
        const int nt = warp + i * XEQ_BT_WARPS;
        if (nt < n8) {
          const xeq_bf16* d0 = dfw_s + 2 * cq * p.w_st + nt * 8 + gq;
          const uint32_t b0 = xeq_pack(d0[0], d0[p.w_st]);
          const uint32_t b1 = xeq_pack(d0[8 * p.w_st], d0[9 * p.w_st]);
          xeq_mma(acc[i][0], a[0], b0, b1);
          xeq_mma(acc[i][1], a[1], b0, b1);
        }
      }
    }
    __syncthreads();
    if (p.nst == 1) {  // the stage is read: the next tile's copies may land
      if (tl + grid < n_tiles) xeq_tile_load(tile_smem, est, (tl + grid) * XEQ_BT, ahead, p, x, g, ef);
      xeq_cp_commit();
      ahead =
          xeq_slot_idx(tl + 2 * grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr);
    }
    sp.mark(5);

    // E: the filter columns of the warp's d_ef row (the four quarters in
    // order) and zeros past Kf; dfo_s is free once the next tile's first
    // barrier has passed
    if (k_w < p.n_slots)
      xeq_def_row(dfo_s, warp, d_ef + (int64_t)k_w * XEQ_FPACK, p.kw, p.kf, kwp);
    sp.mark(6);
  }

  if constexpr (!WIDE)
    xeq_dwf_part_write(acc, dwf_part + (int64_t)blockIdx.x * p.kf * p.h, p.kf, p.h, n8);
  sp.mark(7);
  if (threadIdx.x == 0) sp.write(stamps + (int64_t)blockIdx.x * XEQ_STAMPS);
}

static int launch_bwd_tiles(const void* x, const void* ef, const void* wf, const void* g,
                            const void* src_ptr, const void* slot_src, const void* slot_dst,
                            const void* src_pos, const void* lane_gate,
                            const void* lane_ycol, const void* gate_lane0,
                            const void* gate_dim, void* rows, void* dfw_rows, void* dx,
                            void* d_ef, void* dwf_part, void* dwf, int n_rows, int n_slots,
                            int n_part, int ni, int h_dim, int hp, int d, int dp, int sdp,
                            int kw, int kf, cudaStream_t s) {
  XeqTileDims p;
  if (!bwd_tile_dims(p, n_slots, ni, h_dim, hp, d, dp, sdp, kw, kf) ||
      (!p.dwf_regs && dfw_rows == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = p.wf_smem ? (p.dwf_regs ? message_bwd_tile_kernel<true, false>
                                        : message_bwd_tile_kernel<true, true>)
                          : (p.dwf_regs ? message_bwd_tile_kernel<false, false>
                                        : message_bwd_tile_kernel<false, true>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, XEQ_BT_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const int*)slot_src, (const int*)slot_dst, (const int*)src_pos,
      (const int*)lane_gate, (const int*)lane_ycol, (const int*)gate_lane0,
      (const int*)gate_dim, (xeq_bf16*)rows, (xeq_bf16*)dfw_rows, (float*)d_ef,
      (float*)dwf_part, p, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    message_bwd_dx_rows_kernel<<<(n_rows + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows, (const int*)src_ptr, (float*)dx, n_rows, p.ht8, p.dt8, hp,
        hp + dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!p.dwf_regs)
    return xeq_dwf_pass((const xeq_bf16*)ef, (const xeq_bf16*)dfw_rows, nullptr, nullptr,
                        (float*)dwf_part, (float*)dwf, n_slots, n_part,
                        p.hs, kf, h_dim, hp, s);
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)dwf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

// The Hopper tile pass (message_bwd_hopper.cuh), the dx pass and the d_wf
// reduction.
static int launch_bwd_hopper_route(const void* x, const void* ef, const void* wf, const void* g,
                                   const void* src_ptr, const void* slot_src,
                                   const void* slot_dst, const void* src_pos,
                                   const void* lane_ycol, const void* gate_lane0,
                                   const void* gate_dim, const void* seg, void* rows, void* dx,
                                   void* d_ef, void* dwf_part, void* dwf, int n_rows,
                                   int n_slots, int n_part, int ni, int h_dim, int hp, int d,
                                   int dp, int sdp, int kw, int kf, int n_seg, cudaStream_t s) {
  XeqHopperDims p;
  if (!bwd_hopper_dims(p, n_slots, ni, h_dim, hp, d, dp, sdp, kw, kf, n_seg))
    return (int)cudaErrorInvalidValue;
  int err = launch_bwd_hopper<false>(x, ef, wf, g, slot_src, slot_dst, src_pos, lane_ycol,
                                     gate_lane0, gate_dim, seg, rows, d_ef, dwf_part, p, n_part,
                                     nullptr, s);
  if (err != cudaSuccess) return err;
  if (n_rows > 0) {
    message_bwd_dx_rows_kernel<<<(n_rows + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows, (const int*)src_ptr, (float*)dx, n_rows, p.ht8, p.dt8, hp,
        hp + dp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)dwf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

// The f32 tile pass (message_f32_tile.cuh) and the d_wf reduction.  STAMP:
// the phase probe's instance (xeq_bwd_f32_phases).
template <bool STAMP>
__global__ void __launch_bounds__(XEQ_F32_THREADS, 1)
message_bwd_f32_kernel(const XeqF32Args a, const XeqF32Dims p) {
  xeq_f32_body<false, STAMP>(a, p);
}

template <bool STAMP>
static int launch_bwd_f32_route(const void* x, const void* ef, const void* wf, const void* g,
                                const void* src_ptr, const void* src_slots, const void* slot_src,
                                const void* slot_dst, const void* units, void* dx, void* d_ef,
                                void* dwf_part, void* dwf, int n_rows, int n_slots, int n_part,
                                int ni, int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                                int n_cw, long long* stamps, cudaStream_t s) {
  XeqF32Dims p;
  if (units == nullptr || (STAMP && stamps == nullptr) ||
      !f32_tile_dims(p, false, n_slots, n_rows, ni, h_dim - 2 * ni, h_dim, hp, d, dp, sdp, kw,
                     kf, n_cw))
    return (int)cudaErrorInvalidValue;
  const XeqF32Args a = {(const float*)x, (const float*)ef, (const float*)wf, (const float*)g,
                        nullptr, nullptr, (const int*)src_ptr, (const int*)src_slots,
                        (const int*)slot_src, (const int*)slot_dst, nullptr,
                        (const int4*)units, (float*)dx, (float*)d_ef, (float*)dwf_part,
                        nullptr, stamps};
  const int err = xeq_f32_launch(message_bwd_f32_kernel<STAMP>, a, p, n_part, s);
  if (err != cudaSuccess) return err;
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)dwf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

#define XEQ_BWD_WALK_ARGS                                                                    \
  x, ef, wf, g, src_ptr, src_slots, slot_src, slot_dst, lane_gate, lane_ycol, gate_lane0,    \
      gate_dim, ylane_ptr, ylane_idx, def_part, dx, d_ef, dwf_part, dwf, n_rows, n_slots,    \
      n_part, ni, h_dim, hp, d, dp, sdp, kw, kf, n_hc, s

// tiles, chosen by the wrapper by shape: 3 (f32 only), the f32 tile pass
// (message_f32_tile.cuh; seg: its unit table, one int4 per consumer thread,
// n_seg its consumer warps); 2 (bf16), the Hopper tile pass
// (message_bwd_hopper.cuh; seg: its irrep segments [n_seg] as (u0, j0, mul,
// l | (ycol - kw) << 8)); 1 (bf16), the tile pass above where a layout of
// it fits (dfw_rows: its scratch when d_wf leaves the registers); 0, the
// walk kernels in the operands' dtype, over n_hc column chunks (def_part:
// their d_ef partials when n_hc > 1).
extern "C" int xeq_message_bwd(const void* x, const void* ef, const void* wf,
                               const void* g, const void* src_ptr,
                               const void* src_slots, const void* slot_src,
                               const void* slot_dst, const void* src_pos,
                               const void* lane_gate, const void* lane_ycol,
                               const void* gate_lane0, const void* gate_dim,
                               const void* ylane_ptr, const void* ylane_idx, const void* seg,
                               void* rows, void* dfw_rows, void* def_part, void* dx,
                               void* d_ef, void* dwf_part, void* dwf, int n_rows, int n_slots,
                               int n_part, int ni, int h_dim, int hp, int d, int dp, int sdp,
                               int kw, int kf, int n_seg, int bf16, int tiles, int n_hc,
                               void* stream) {
  if (kw > kf || kf > XEQ_FPACK || (hp + dp) % 128 != 0 || n_part < 1 ||
      ((tiles == 1 || tiles == 2) && !bf16) || (tiles == 3 && bf16) || tiles < 0 || tiles > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (tiles == 3)
    return launch_bwd_f32_route<false>(x, ef, wf, g, src_ptr, src_slots, slot_src, slot_dst, seg,
                                       dx, d_ef, dwf_part, dwf, n_rows, n_slots, n_part, ni,
                                       h_dim, hp, d, dp, sdp, kw, kf, n_seg, nullptr, s);
  if (tiles == 2)
    return launch_bwd_hopper_route(x, ef, wf, g, src_ptr, slot_src, slot_dst, src_pos,
                                   lane_ycol, gate_lane0, gate_dim, seg, rows, dx, d_ef,
                                   dwf_part, dwf, n_rows, n_slots, n_part, ni, h_dim, hp, d, dp,
                                   sdp, kw, kf, n_seg, s);
  if (tiles)
    return launch_bwd_tiles(x, ef, wf, g, src_ptr, slot_src, slot_dst, src_pos, lane_gate,
                            lane_ycol, gate_lane0, gate_dim, rows, dfw_rows, dx, d_ef,
                            dwf_part, dwf, n_rows, n_slots, n_part, ni, h_dim, hp, d, dp, sdp,
                            kw, kf, s);
  if (bf16) return launch_bwd<__nv_bfloat16, true>(XEQ_BWD_WALK_ARGS);
  return launch_bwd<float, false>(XEQ_BWD_WALK_ARGS);
}

// The phase probe (xequinet_torch/tools/bwd_stream_floor.py; on no model
// path): one launch of a tile pass alone, with clock64() stamps per phase
// in stamps: which = 0, the sm_80-style tile kernel's flagship instance
// (wf's live rows in shared memory, d_wf in registers; [n_part][8]);
// which = 1, the Hopper tile pass ([n_part][XEQ_HB_WGS + 1][8]: the
// consumer warpgroups 0 to XEQ_HB_WGS - 1, then the producer).  Its outputs are the pass's: d_ef, the scratch rows and
// the d_wf partials.
extern "C" int xeq_bwd_phases(const void* x, const void* ef, const void* wf, const void* g,
                              const void* slot_src, const void* slot_dst, const void* src_pos,
                              const void* lane_gate, const void* lane_ycol,
                              const void* gate_lane0, const void* gate_dim, const void* seg,
                              void* rows, void* d_ef, void* dwf_part, int n_slots, int n_part,
                              int ni, int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                              int n_seg, int which, void* stamps, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_part < 1 || stamps == nullptr) return (int)cudaErrorInvalidValue;
  if (which == 1) {
    XeqHopperDims p;
    if (!bwd_hopper_dims(p, n_slots, ni, h_dim, hp, d, dp, sdp, kw, kf, n_seg))
      return (int)cudaErrorInvalidValue;
    return launch_bwd_hopper<false>(x, ef, wf, g, slot_src, slot_dst, src_pos, lane_ycol,
                                    gate_lane0, gate_dim, seg, rows, d_ef, dwf_part, p, n_part,
                                    (long long*)stamps, s);
  }
  XeqTileDims p;
  if (which != 0 || !bwd_tile_dims(p, n_slots, ni, h_dim, hp, d, dp, sdp, kw, kf) ||
      !p.wf_smem || !p.dwf_regs)
    return (int)cudaErrorInvalidValue;
  auto kernel = message_bwd_tile_kernel<true, false, true>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_part, XEQ_BT_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const int*)slot_src, (const int*)slot_dst, (const int*)src_pos, (const int*)lane_gate,
      (const int*)lane_ycol, (const int*)gate_lane0, (const int*)gate_dim, (xeq_bf16*)rows,
      nullptr, (float*)d_ef, (float*)dwf_part, p, (long long*)stamps);
  return (int)cudaGetLastError();
}

// The f32 tile pass's phase probe (xequinet_torch/tools/bwd_compare.py
// --dtype float32 --phases; on no model path): the f32 route of
// xeq_message_bwd (tiles = 3) with the stamped instance of its tile pass,
// clock64() cycles per phase in stamps [n_part][2][8] (the consumers, then
// the producer).  Its outputs are the route's.
extern "C" int xeq_bwd_f32_phases(const void* x, const void* ef, const void* wf, const void* g,
                                  const void* src_ptr, const void* src_slots,
                                  const void* slot_src, const void* slot_dst, const void* units,
                                  void* dx, void* d_ef, void* dwf_part, void* dwf, int n_rows,
                                  int n_slots, int n_part, int ni, int h_dim, int hp, int d,
                                  int dp, int sdp, int kw, int kf, int n_cw, void* stamps,
                                  void* stream) {
  if (n_part < 1 || kw > kf || (hp + dp) % 128 != 0) return (int)cudaErrorInvalidValue;
  return launch_bwd_f32_route<true>(x, ef, wf, g, src_ptr, src_slots, slot_src, slot_dst, units,
                                    dx, d_ef, dwf_part, dwf, n_rows, n_slots, n_part, ni, h_dim,
                                    hp, d, dp, sdp, kw, kf, n_cw, (long long*)stamps,
                                    (cudaStream_t)stream);
}
