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
// The bf16 instance (the flagship's) is two passes and the reduction:
//  * message_bwd_tile_kernel: persistent blocks of 512 threads, one per
//    SM, walk tiles of XEQ_BT = 16 consecutive slots (tile = block + i *
//    grid, so all SMs work on neighbouring slots and the x / g rows they
//    gather stay in L2).  The next tile's x rows (live H + D columns), g
//    rows and edge-feature columns (Kf <= 32) are staged with cp.async
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
//    The copies are hidden behind the compute; what bounds the pass now
//    is instruction issue in its elementwise steps (16 warps per SM, one
//    block: the staging takes the shared memory).
//  * message_bwd_dx_rows_kernel: one warp per source row sums its slots'
//    scratch rows in list order (contiguous, 16-byte loads) and writes each
//    dx element once, near the card's memory rate.  This replaces the TPU
//    kernel's per-block window tiles and their overlap-add (:541-546): the
//    scatter by src becomes a contiguous gather by src, and nothing is
//    recomputed.
//  * xeq_dwf_reduce_kernel (message_common.cuh): the per-block d_wf
//    partials summed in block order.
// The f32 instance keeps the first version's FP32 kernels (no TF32 in
// this port): message_bwd_dx_kernel, one thread per (source row, x
// column) walking the CSR list by source and recomputing each slot's
// contribution, and message_bwd_slot_kernel, one block per contiguous slot
// range with the d_ef rows and a d_wf partial in shared memory.
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

// ---------------------------------------------------------------------------
// bf16 instance: the slot-tile pass on the tensor cores and the dx pass
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 xeq_bf16;

#define XEQ_BT 16            // slots per tile (the M of the mma tiles)
#define XEQ_BT_THREADS 512
#define XEQ_BT_WARPS 16
#define XEQ_BT_KE 32         // edge-feature columns staged: Kf <= 32
#define XEQ_BT_EST 40        // their row stride (bf16): conflict-free fragments
#define XEQ_BT_NTW 6         // d_wf n8 tiles a warp keeps: H <= 16 * 8 * 6
#define XEQ_DX_CPL 5         // 16-byte chunks a lane sums per column group
static_assert(XEQ_BT == XEQ_BT_WARPS, "one warp per slot of a tile");

// Sizes and shared-memory offsets (bytes) of the tile pass, from the host.
struct XeqTileDims {
  int n_slots, ni, h, hp, d, dp, sdp, kw, kf;
  int hs;      // H rounded up to 16: the N of fw, the K of d_ef
  int ht8;     // H rounded up to 8: the dgs part of a scratch row
  int dt8;     // D rounded up to 8: the dgv part
  int sd8;     // node_dim = H - 2 ni rounded up to 8: the live scalar g columns
  int rs;      // scratch row: ht8 + dt8
  int xs_st;   // staged x row: [gs (ht8) | gv (dt8)] + 8
  int gs_st;   // staged g row: [gms_s (sd8) | gms_v (dt8)] + 8
  int w_st;    // wf_s / dfw_s row: hs rounded up to 64, + 8
  int dfo_st;  // dfo_s row (f32): 2 ni + 8
  int off_g, off_e, off_pos, stage;  // within a stage; stage size
  int off_wf, off_dfw, off_dfo, off_tab, smem;
};

__device__ __forceinline__ void xeq_cp16(void* to, const void* from, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(to);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(from),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ uint32_t xeq_ld2(const xeq_bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t xeq_pack(xeq_bf16 lo, xeq_bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float xeq_f(xeq_bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ xeq_bf16 xeq_b(float v) { return __float2bfloat16_rn(v); }

// c += a (16x16, row) @ b (16x8, col): bf16 operands, f32 accumulators.
__device__ __forceinline__ void xeq_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The slot of this warp in tile ``tile``: its destination row (-1 when it
// adds nothing or lies past n_slots), source row and scratch row.
struct XeqSlotIdx {
  int dst, src, pos;
};

__device__ __forceinline__ XeqSlotIdx xeq_slot_idx(int tile, int n_tiles, int n_slots,
                                                   const int* __restrict__ slot_src,
                                                   const int* __restrict__ slot_dst,
                                                   const int* __restrict__ src_pos) {
  const int k = tile * XEQ_BT + (threadIdx.x >> 5);
  if (tile >= n_tiles || k >= n_slots) return {-1, 0, -1};
  return {__ldg(slot_dst + k), __ldg(slot_src + k), __ldg(src_pos + k)};
}

// Issue the cp.async copies of one tile (slots k0 .. k0+XEQ_BT-1, one warp
// per slot, its indices in ``ix``) into a stage: each slot's x row (gs and
// gv columns), g row (gms_s and gms_v columns) and first 32 edge-feature
// columns, zero-filled for padding slots, slots past the covered range and
// slots past n_slots; and its scratch row (position in the CSR list by
// source, -1 for slots that add nothing).
__device__ __forceinline__ void xeq_tile_load(unsigned char* st, int k0, XeqSlotIdx ix,
                                              const XeqTileDims& p,
                                              const xeq_bf16* __restrict__ x,
                                              const xeq_bf16* __restrict__ g,
                                              const xeq_bf16* __restrict__ ef) {
  const int lane = threadIdx.x & 31, t = threadIdx.x >> 5;
  const bool ok = ix.dst >= 0;
  const xeq_bf16* xr = x + (int64_t)(ok ? ix.src : 0) * (p.hp + p.dp);
  const xeq_bf16* gr = g + (int64_t)(ok ? ix.dst : 0) * (p.sdp + p.dp);
  const xeq_bf16* er = ef + (int64_t)(ok ? k0 + t : 0) * XEQ_FPACK;
  xeq_bf16* x_s = (xeq_bf16*)st + t * p.xs_st;
  xeq_bf16* g_s = (xeq_bf16*)(st + p.off_g) + t * p.gs_st;
  xeq_bf16* e_s = (xeq_bf16*)(st + p.off_e) + t * XEQ_BT_EST;
  const int cx = p.rs >> 3, cg = (p.sd8 + p.dt8) >> 3;
  for (int r = lane; r < cx + cg + XEQ_BT_KE / 8; r += 32) {
    if (r < cx) {
      const int c = r * 8;
      xeq_cp16(x_s + c, xr + (c < p.ht8 ? c : p.hp + c - p.ht8), ok);
    } else if (r < cx + cg) {
      const int c = (r - cx) * 8;
      xeq_cp16(g_s + c, gr + (c < p.sd8 ? c : p.sdp + c - p.sd8), ok);
    } else {
      const int c = (r - cx - cg) * 8;
      xeq_cp16(e_s + c, er + c, ok);
    }
  }
  if (lane == 0) ((int*)(st + p.off_pos))[t] = ok ? ix.pos : -1;
}

#define XEQ_MAXY 9  // harmonic columns: 2l + 1 for l <= 2

__global__ void __launch_bounds__(XEQ_BT_THREADS, 1)
message_bwd_tile_kernel(const xeq_bf16* __restrict__ x, const xeq_bf16* __restrict__ ef,
                        const xeq_bf16* __restrict__ wf, const xeq_bf16* __restrict__ g,
                        const int* __restrict__ slot_src, const int* __restrict__ slot_dst,
                        const int* __restrict__ src_pos, const int* __restrict__ lane_gate,
                        const int* __restrict__ lane_ycol,
                        const int* __restrict__ gate_lane0,
                        const int* __restrict__ gate_dim, xeq_bf16* __restrict__ rows,
                        float* __restrict__ d_ef, float* __restrict__ dwf_part,
                        const XeqTileDims p) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  xeq_bf16* wf_s = (xeq_bf16*)(tile_smem + p.off_wf);    // [32][w_st] live rows of wf
  xeq_bf16* dfw_s = (xeq_bf16*)(tile_smem + p.off_dfw);  // [BT][w_st]
  float* dfo_s = (float*)(tile_smem + p.off_dfo);        // [BT][dfo_st]; then d_ef quarters
  int* lane_tab = (int*)(tile_smem + p.off_tab);         // [dt8]: gate | harmonic col << 16
  int* gate_tab = lane_tab + p.dt8;                      // [ni]: first lane | lanes << 16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, cq = lane & 3;  // mma fragment: row group, column pair
  const int ni2 = 2 * p.ni, n8 = p.hs >> 3, n_y = p.kf - p.kw;
  const int n_tiles = (p.n_slots + XEQ_BT - 1) / XEQ_BT;

  for (int i = tid; i < XEQ_BT_KE * p.hs; i += XEQ_BT_THREADS) {
    const int f = i / p.hs, h = i - f * p.hs;
    wf_s[f * p.w_st + h] = (f < p.kw && h < p.h) ? wf[(int64_t)f * p.hp + h] : xeq_b(0.f);
  }
  for (int j = tid; j < p.dt8; j += XEQ_BT_THREADS)
    lane_tab[j] = j < p.d ? __ldg(lane_gate + j) | ((__ldg(lane_ycol + j) - p.kw) << 16) : 0;
  for (int u = tid; u < p.ni; u += XEQ_BT_THREADS)
    gate_tab[u] = __ldg(gate_lane0 + u) | (__ldg(gate_dim + u) << 16);
  float acc[XEQ_BT_NTW][2][4];
#pragma unroll
  for (int i = 0; i < XEQ_BT_NTW; ++i)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][m][q] = 0.f;

  // the slot indices go one tile ahead of the copies, so that issuing a
  // tile's copies never waits on a load
  const int grid = gridDim.x;
  if ((int)blockIdx.x < n_tiles)
    xeq_tile_load(tile_smem, blockIdx.x * XEQ_BT,
                  xeq_slot_idx(blockIdx.x, n_tiles, p.n_slots, slot_src, slot_dst, src_pos), p,
                  x, g, ef);
  asm volatile("cp.async.commit_group;\n" ::);
  XeqSlotIdx ahead =
      xeq_slot_idx(blockIdx.x + grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos);
  for (int it = 0;; ++it) {
    const int tl = blockIdx.x + it * grid;
    if (tl >= n_tiles) break;
    unsigned char* st = tile_smem + (it & 1) * p.stage;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // this tile has landed; the other stage is free
    if (tl + grid < n_tiles)
      xeq_tile_load(tile_smem + ((it + 1) & 1) * p.stage, (tl + grid) * XEQ_BT, ahead, p, x, g,
                    ef);
    asm volatile("cp.async.commit_group;\n" ::);
    ahead = xeq_slot_idx(tl + 2 * grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos);
    xeq_bf16* x_s = (xeq_bf16*)st;
    const xeq_bf16* g_s = (const xeq_bf16*)(st + p.off_g);
    const xeq_bf16* e_s = (const xeq_bf16*)(st + p.off_e);
    const int* pos_s = (const int*)(st + p.off_pos);
    const int k_w = tl * XEQ_BT + warp;  // the slot of this warp in phases A, C, E

    // A: the gate sums of dfo, one warp per slot, a lane per irrep
    {
      const xeq_bf16* xv = x_s + warp * p.xs_st + p.ht8;
      const xeq_bf16* gv = g_s + warp * p.gs_st + p.sd8;
      const xeq_bf16* er = e_s + warp * XEQ_BT_EST + p.kw;
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

    // B: fw on the tensor cores, one n8 column tile per warp at a time;
    // per element dfw (to dfw_s), dgs (to the scratch row) and, in the gate
    // columns, fo (in place of gs, which nothing reads after this)
    {
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const xeq_bf16* e0 = e_s + gq * XEQ_BT_EST + ks * 16 + 2 * cq;
        a[ks][0] = xeq_ld2(e0);
        a[ks][1] = xeq_ld2(e0 + 8 * XEQ_BT_EST);
        a[ks][2] = xeq_ld2(e0 + 8);
        a[ks][3] = xeq_ld2(e0 + 8 * XEQ_BT_EST + 8);
      }
      for (int nt = warp; nt < n8; nt += XEQ_BT_WARPS) {
        const int n = nt * 8 + gq;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const xeq_bf16* w0 = wf_s + (ks * 16 + 2 * cq) * p.w_st + n;
          xeq_mma(c, a[ks], xeq_pack(w0[0], w0[p.w_st]),
                  xeq_pack(w0[8 * p.w_st], w0[9 * p.w_st]));
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
            const float2 gs = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr));
            const float2 dfo =
                h0 < ni2 ? *reinterpret_cast<const float2*>(dfo_s + t * p.dfo_st + h0)
                         : __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                               g_s + t * p.gs_st + h0 - ni2));
            dfw = make_float2(dfo.x * gs.x, dfo.y * gs.y);
            dgs = make_float2(dfo.x * fw.x, dfo.y * fw.y);
            if (h0 + 1 >= p.h) dfw.y = dgs.y = 0.f;  // odd H: column H is padding
            if (h0 < ni2)
              *reinterpret_cast<__nv_bfloat162*>(xr) = __floats2bfloat162_rn(gs.x * fw.x,
                                                                             gs.y * fw.y);
          }
          *reinterpret_cast<__nv_bfloat162*>(dfw_s + t * p.w_st + h0) =
              __floats2bfloat162_rn(dfw.x, dfw.y);
          const int pos = pos_s[t];
          if (pos >= 0 && h0 < p.ht8)
            *reinterpret_cast<__nv_bfloat162*>(rows + (int64_t)pos * p.rs + h0) =
                __floats2bfloat162_rn(dgs.x, dgs.y);
        }
      }
    }
    __syncthreads();

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
        const float2 gm = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gv + j0));
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
        if (pos >= 0)
          *reinterpret_cast<__nv_bfloat162*>(rows + (int64_t)pos * p.rs + p.ht8 + j0) =
              __floats2bfloat162_rn(dgv[0], dgv[1]);
      }
      float mine = 0.f;
#pragma unroll
      for (int y = 0; y < XEQ_MAXY; ++y) {
        for (int o = 16; o > 0; o >>= 1) hy[y] += __shfl_xor_sync(0xffffffffu, hy[y], o);
        if (lane == y) mine = hy[y];
      }
      if (k_w < p.n_slots && lane < n_y) d_ef[(int64_t)k_w * XEQ_FPACK + p.kw + lane] = mine;
    }

    // D1: d_ef[:, f < 32] = dfw @ wf^T on the tensor cores; warp w takes
    // column tile w % 4 and K quarter w / 4, its partial to shared memory
    {
      const int f0 = (warp & 3) * 8, kq = warp >> 2, ksn = p.hs >> 4;
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = kq * ksn / 4; ks < (kq + 1) * ksn / 4; ++ks) {
        const xeq_bf16* d0 = dfw_s + gq * p.w_st + ks * 16 + 2 * cq;
        const uint32_t a[4] = {xeq_ld2(d0), xeq_ld2(d0 + 8 * p.w_st), xeq_ld2(d0 + 8),
                               xeq_ld2(d0 + 8 * p.w_st + 8)};
        const xeq_bf16* w0 = wf_s + (f0 + gq) * p.w_st + ks * 16 + 2 * cq;
        xeq_mma(c, a, xeq_ld2(w0), xeq_ld2(w0 + 8));
      }
      float* red = dfo_s + kq * XEQ_BT * 32;
      red[gq * 32 + f0 + 2 * cq] = c[0];
      red[gq * 32 + f0 + 2 * cq + 1] = c[1];
      red[(gq + 8) * 32 + f0 + 2 * cq] = c[2];
      red[(gq + 8) * 32 + f0 + 2 * cq + 1] = c[3];
    }
    // D2: the block's d_wf partial += ef^T @ dfw on the tensor cores, in
    // the warp's own column tiles (rows f of two m16 tiles)
    {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const xeq_bf16* e0 = e_s + 2 * cq * XEQ_BT_EST + 16 * mt + gq;
        a[mt][0] = xeq_pack(e0[0], e0[XEQ_BT_EST]);
        a[mt][1] = xeq_pack(e0[8], e0[XEQ_BT_EST + 8]);
        a[mt][2] = xeq_pack(e0[8 * XEQ_BT_EST], e0[9 * XEQ_BT_EST]);
        a[mt][3] = xeq_pack(e0[8 * XEQ_BT_EST + 8], e0[9 * XEQ_BT_EST + 8]);
      }
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

    // E: the filter columns of the warp's d_ef row (the four quarters in
    // order) and zeros past Kf; dfo_s is free once the next tile's first
    // barrier has passed
    if (k_w < p.n_slots) {
      for (int f = lane; f < XEQ_FPACK; f += 32) {
        if (f >= p.kw && f < p.kf) continue;
        float v = 0.f;
        if (f < p.kw) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v += dfo_s[(q * XEQ_BT + warp) * 32 + f];
        }
        d_ef[(int64_t)k_w * XEQ_FPACK + f] = v;
      }
    }
  }

  float* part = dwf_part + (int64_t)blockIdx.x * p.kf * p.h;
#pragma unroll
  for (int i = 0; i < XEQ_BT_NTW; ++i) {
    const int nt = warp + i * XEQ_BT_WARPS;
    if (nt >= n8) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = 16 * mt + gq + 8 * (q >> 1), h = nt * 8 + 2 * cq + (q & 1);
        if (f < p.kf && h < p.h) part[(int64_t)f * p.h + h] = acc[i][mt][q];
      }
  }
}

// dx [n_rows, Hp+Dp] f32: one warp per source row sums the scratch rows
// of its slots (src_ptr[r] .. src_ptr[r+1]-1, contiguous, in list order),
// XEQ_DX_CPL 16-byte chunks per lane, two slots' loads in flight; scratch
// column c goes to dx column c (< ht8) or Hp + c - ht8, the rest is zero.
__global__ void __launch_bounds__(256)
message_bwd_dx_rows_kernel(const xeq_bf16* __restrict__ rows, const int* __restrict__ src_ptr,
                           float* __restrict__ dx, int n_rows, int rs, int ht8, int dt8,
                           int hp, int xw) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int p0 = __ldg(src_ptr + r), p1 = __ldg(src_ptr + r + 1);
  const int nch = rs >> 3;
  float* out = dx + (int64_t)r * xw;
  for (int cg0 = 0; cg0 < nch; cg0 += 32 * XEQ_DX_CPL) {
    float acc[XEQ_DX_CPL][8];
#pragma unroll
    for (int i = 0; i < XEQ_DX_CPL; ++i)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
    for (int p = p0; p < p1; p += 2) {
      uint4 v[2][XEQ_DX_CPL];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int i = 0; i < XEQ_DX_CPL; ++i) {
          const int c = cg0 + lane + 32 * i;
          v[u][i] = (p + u < p1 && c < nch)
                        ? __ldcs(reinterpret_cast<const uint4*>(rows + (int64_t)(p + u) * rs) + c)
                        : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (p + u >= p1) break;
#pragma unroll
        for (int i = 0; i < XEQ_DX_CPL; ++i) {
          const uint32_t w[4] = {v[u][i].x, v[u][i].y, v[u][i].z, v[u][i].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[i][2 * e] += __uint_as_float(w[e] << 16);
            acc[i][2 * e + 1] += __uint_as_float(w[e] & 0xffff0000u);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < XEQ_DX_CPL; ++i) {
      const int c = cg0 + lane + 32 * i;
      if (c >= nch) continue;
      const int col = c * 8, dc = col < ht8 ? col : hp + col - ht8;
      float4* o = reinterpret_cast<float4*>(out + dc);
      o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = ht8 + 4 * lane; c < hp; c += 128) *reinterpret_cast<float4*>(out + c) = z;
  for (int c = hp + dt8 + 4 * lane; c < xw; c += 128) *reinterpret_cast<float4*>(out + c) = z;
}

static int round_up(int v, int m) { return (v + m - 1) / m * m; }

static int launch_bwd_tiles(const void* x, const void* ef, const void* wf, const void* g,
                            const void* src_ptr, const void* slot_src, const void* slot_dst,
                            const void* src_pos, const void* lane_gate,
                            const void* lane_ycol, const void* gate_lane0,
                            const void* gate_dim, const void* ylane_ptr,
                            const void* ylane_idx, void* rows, void* dx, void* d_ef,
                            void* dwf_part, void* dwf, int n_rows, int n_slots, int n_part,
                            int ni, int h_dim, int hp, int d, int dp, int sdp, int kw,
                            int kf, cudaStream_t s) {
  XeqTileDims p;
  p.n_slots = n_slots; p.ni = ni; p.h = h_dim; p.hp = hp; p.d = d; p.dp = dp;
  p.sdp = sdp; p.kw = kw; p.kf = kf;
  p.hs = round_up(h_dim, 16);
  p.ht8 = round_up(h_dim, 8);
  p.dt8 = round_up(d, 8);
  p.sd8 = round_up(h_dim - 2 * ni, 8);
  p.rs = p.ht8 + p.dt8;
  p.xs_st = p.rs + 8;
  p.gs_st = p.sd8 + p.dt8 + 8;
  p.w_st = round_up(p.hs, 64) + 8;
  p.dfo_st = 2 * ni + 8;
  p.off_g = XEQ_BT * p.xs_st * 2;
  p.off_e = p.off_g + XEQ_BT * p.gs_st * 2;
  p.off_pos = p.off_e + XEQ_BT * XEQ_BT_EST * 2;
  p.stage = round_up(p.off_pos + XEQ_BT * 4, 16);
  p.off_wf = 2 * p.stage;
  p.off_dfw = p.off_wf + XEQ_BT_KE * p.w_st * 2;
  p.off_dfo = p.off_dfw + XEQ_BT * p.w_st * 2;
  const int dfo_bytes = XEQ_BT * p.dfo_st * 4;
  p.off_tab = p.off_dfo + (dfo_bytes > 4 * XEQ_BT * 32 * 4 ? dfo_bytes : 4 * XEQ_BT * 32 * 4);
  p.smem = p.off_tab + round_up((p.dt8 + ni) * 4, 16);
  if (kf - kw > XEQ_MAXY || d >= 65536 || kf > XEQ_BT_KE || p.hs > 16 * 8 * XEQ_BT_NTW || p.sd8 > p.ht8 || p.ht8 > hp ||
      p.dt8 > dp || p.smem > 232448)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      message_bwd_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  message_bwd_tile_kernel<<<n_part, XEQ_BT_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const int*)slot_src, (const int*)slot_dst, (const int*)src_pos,
      (const int*)lane_gate, (const int*)lane_ycol, (const int*)gate_lane0,
      (const int*)gate_dim, (xeq_bf16*)rows, (float*)d_ef, (float*)dwf_part, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    message_bwd_dx_rows_kernel<<<(n_rows + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows, (const int*)src_ptr, (float*)dx, n_rows, p.rs, p.ht8, p.dt8,
        hp, hp + dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)dwf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}

extern "C" int xeq_message_bwd(const void* x, const void* ef, const void* wf,
                               const void* g, const void* src_ptr,
                               const void* src_slots, const void* slot_src,
                               const void* slot_dst, const void* src_pos,
                               const void* lane_gate, const void* lane_ycol,
                               const void* gate_lane0, const void* gate_dim,
                               const void* ylane_ptr, const void* ylane_idx,
                               void* rows, void* dx, void* d_ef, void* dwf_part,
                               void* dwf, int n_rows, int n_slots, int n_part, int ni,
                               int h_dim, int hp, int d, int dp, int sdp, int kw, int kf,
                               int bf16, void* stream) {
  if (kw > XEQ_MAXK || kf > XEQ_FPACK || (hp + dp) % 128 != 0 || n_part < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_bwd_tiles(x, ef, wf, g, src_ptr, slot_src, slot_dst, src_pos, lane_gate,
                            lane_ycol, gate_lane0, gate_dim, ylane_ptr, ylane_idx, rows, dx,
                            d_ef, dwf_part, dwf, n_rows, n_slots, n_part, ni, h_dim, hp, d,
                            dp, sdp, kw, kf, s);
  return launch_bwd<float, false>(
      x, ef, wf, g, src_ptr, src_slots, slot_src, slot_dst, lane_gate,
      lane_ycol, gate_lane0, gate_dim, ylane_ptr, ylane_idx, dx, d_ef,
      dwf_part, dwf, n_rows, n_slots, n_part, ni, h_dim, hp, d, dp, sdp, kw,
      kf, s);
}
