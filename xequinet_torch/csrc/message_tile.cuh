// Shared pieces of the bf16 slot-tile kernels (message_fwd.cu,
// message_bwd.cu, message_bwd2.cu, and the Hopper pass of
// message_bwd_hopper.cuh).  Which kernel still uses which:
//  * cp.async staging (xeq_cp_commit / xeq_cp_wait_all, XeqSeg and
//    xeq_stage_segs), mma.sync m16n8k16 products with bf16 operands and
//    f32 accumulators (xeq_mma, xeq_frag_a, xeq_wf_b, xeq_load_wf) and
//    xeq_st2: message_fwd.cu, message_bwd2.cu and message_bwd.cu's mma.sync
//    tile pass (the widths the Hopper pass does not take);
//  * the slot indices of a tile (xeq_slot_idx), the transposed fragments
//    (xeq_frag_at), the d_wf partial in registers (xeq_dwf_part_write), the
//    d_ef quarters and rows (xeq_def_quarters, xeq_def_row), xeq_copy_row,
//    xeq_harmonic_sums, the filter-weight gradient pass over per-slot rows
//    (xeq_dwf_pass): message_bwd2.cu and message_bwd.cu's mma.sync pass;
//  * the pass that sums per-slot scratch rows along a CSR list
//    (xeq_rows_sum): message_bwd2.cu, and message_bwd.cu's dx pass
//    (message_bwd_dx_rows_kernel), which both tile passes of message_bwd.cu
//    and the stream floor (bwd_stream_floor.cu) run;
//  * the mma.sync pass's layout and staging (XeqTileDims, bwd_tile_dims,
//    xeq_tile_load): message_bwd.cu only;
//  * the conversions (xeq_f, xeq_f2, xeq_b, xeq_pack, xeq_round_up) and the
//    phase stamps (XeqStamps): every one of them.
#pragma once

#include "message_common.cuh"

typedef __nv_bfloat16 xeq_bf16;

#define XEQ_BT 16            // slots per tile (the M of the mma tiles)
#define XEQ_BT_THREADS 512   // the backward passes: one warp per slot of a tile
#define XEQ_BT_WARPS 16
#define XEQ_BT_KE 32         // edge-feature columns per K slice
#define XEQ_BT_NTW 6         // filter-weight n8 tiles a warp keeps in registers:
                             // d_wf in registers for H <= 16 * 8 * 6, Kf <= 32
#define XEQ_DX_CPL 5         // 16-byte chunks a lane sums per column group
#define XEQ_MAXY 9           // harmonic columns: 2l + 1 for l <= 2
static_assert(XEQ_BT == XEQ_BT_WARPS, "one warp per slot of a tile");

__host__ __device__ inline int xeq_round_up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ void xeq_cp16(void* to, const void* from, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(to);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(from),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void xeq_cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void xeq_cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ uint32_t xeq_ld2(const xeq_bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t xeq_pack(xeq_bf16 lo, xeq_bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float xeq_f(xeq_bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ xeq_bf16 xeq_b(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float2 xeq_f2(const xeq_bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void xeq_st2(xeq_bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// c += a (16x16, row) @ b (16x8, col): bf16 operands, f32 accumulators.
__device__ __forceinline__ void xeq_mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments (two k16 steps) of a 16 x 32 bf16 tile of row stride
// ``st`` in shared memory: rows are the slots of a tile.
__device__ __forceinline__ void xeq_frag_a(uint32_t (&a)[2][4], const xeq_bf16* m, int st) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const xeq_bf16* p = m + gq * st + ks * 16 + 2 * cq;
    a[ks][0] = xeq_ld2(p);
    a[ks][1] = xeq_ld2(p + 8 * st);
    a[ks][2] = xeq_ld2(p + 8);
    a[ks][3] = xeq_ld2(p + 8 * st + 8);
  }
}

// The A fragments of the transpose of the same 16 x 32 tile (rows are
// its 32 columns, two m16 tiles; K is the 16 slots).
__device__ __forceinline__ void xeq_frag_at(uint32_t (&a)[2][4], const xeq_bf16* m, int st) {
  const int lane = threadIdx.x & 31, gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const xeq_bf16* p = m + 2 * cq * st + 16 * mt + gq;
    a[mt][0] = xeq_pack(p[0], p[st]);
    a[mt][1] = xeq_pack(p[8], p[st + 8]);
    a[mt][2] = xeq_pack(p[8 * st], p[9 * st]);
    a[mt][3] = xeq_pack(p[8 * st + 8], p[9 * st + 8]);
  }
}

// Phase stamps of the probe instances (xeq_bwd_phases in message_bwd.cu,
// launched by xequinet_torch/tools/bwd_stream_floor.py only): mark(k) adds
// the clock64() cycles since the previous mark to phase k (a constant, so
// the sums stay in registers); nothing without ON.
#define XEQ_STAMPS 8
__device__ __forceinline__ long long xeq_clock() {
#ifdef __CUDA_ARCH__
  return clock64();
#else
  return 0;
#endif
}
template <bool ON>
struct XeqStamps {
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void write(long long*) const {}
};
template <>
struct XeqStamps<true> {
  long long t[XEQ_STAMPS], last;
  __device__ __forceinline__ XeqStamps() : last(xeq_clock()) {
#pragma unroll
    for (int i = 0; i < XEQ_STAMPS; ++i) t[i] = 0;
  }
  __device__ __forceinline__ void mark(int k) {
    const long long now = xeq_clock();
    t[k] += now - last;
    last = now;
  }
  __device__ __forceinline__ void write(long long* out) const {
#pragma unroll
    for (int i = 0; i < XEQ_STAMPS; ++i) out[i] = t[i];
  }
};

// The slot of this warp in tile ``tile``: its destination row (-1 when it
// adds nothing or lies past n_slots), source row, and its rows in the
// scratch arrays ordered by source (pos) and by destination (pos2; -1
// without dst_pos).
struct XeqSlotIdx {
  int dst, src, pos, pos2;
};

__device__ __forceinline__ XeqSlotIdx xeq_slot_idx(int tile, int n_tiles, int n_slots,
                                                   const int* __restrict__ slot_src,
                                                   const int* __restrict__ slot_dst,
                                                   const int* __restrict__ src_pos,
                                                   const int* __restrict__ dst_pos) {
  const int k = tile * XEQ_BT + (threadIdx.x >> 5);
  if (tile >= n_tiles || k >= n_slots) return {-1, 0, -1, -1};
  return {__ldg(slot_dst + k), __ldg(slot_src + k), __ldg(src_pos + k),
          dst_pos ? __ldg(dst_pos + k) : -1};
}

// wf_s [kwp][w_st] (bf16) = the live rows of wf [128, hp]: rows f < kw and
// columns h < h, zero elsewhere up to kwp rows and hs columns; by the
// block's nthr threads.
__device__ __forceinline__ void xeq_load_wf(xeq_bf16* wf_s, int w_st,
                                            const xeq_bf16* __restrict__ wf, int kw, int h,
                                            int hp, int hs, int kwp, int nthr) {
  for (int i = threadIdx.x; i < kwp * hs; i += nthr) {
    const int f = i / hs, c = i - f * hs;
    wf_s[f * w_st + c] = (f < kw && c < h) ? wf[(int64_t)f * hp + c] : xeq_b(0.f);
  }
}

// The B fragments (k16 step at row k, n8 column n = tile column + gq) of
// the filter weight wf, row-major with row stride wst: the block's copy of
// its live rows in shared memory (xeq_load_wf), or wf itself in global
// memory (rows >= Kw zero by the packing contract) when the copy does not
// fit beside the stages.
__device__ __forceinline__ void xeq_wf_b(uint32_t& b0, uint32_t& b1, const xeq_bf16* wfp,
                                         int wst, int k, int n) {
  const int cq = threadIdx.x & 3;
  const xeq_bf16* w0 = wfp + (k + 2 * cq) * wst + n;  // < 128 * hp: 32-bit offsets
  b0 = xeq_pack(w0[0], w0[wst]);
  b1 = xeq_pack(w0[8 * wst], w0[9 * wst]);
}

// The block's filter-weight partial part [kf, h] (f32) from the
// accumulators of the warp's n8 column tiles nt = warp + 16 i (rows f of
// two m16 tiles), as the backward passes keep them.
__device__ __forceinline__ void xeq_dwf_part_write(const float (&acc)[XEQ_BT_NTW][2][4],
                                                   float* part, int kf, int h, int n8) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, cq = lane & 3;
#pragma unroll
  for (int i = 0; i < XEQ_BT_NTW; ++i) {
    const int nt = warp + i * XEQ_BT_WARPS;
    if (nt >= n8) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = 16 * mt + gq + 8 * (q >> 1), c = nt * 8 + 2 * cq + (q & 1);
        if (f < kf && c < h) part[(int64_t)f * h + c] = acc[i][mt][q];
      }
  }
}

// d_ef[:, f < kwp] = dfw @ wf^T for the 16 slots of a tile on the tensor
// cores (dfw_s [16][w_st] bf16, K = hs; wf at wfp, row stride wst, rows f
// < kwp): warp w of the 16 takes the column tiles (w % 4) + 4 j, j < kwp /
// 32, and K quarter w / 4, and writes its partials to red [4][16][kwp]
// (f32), summed by xeq_def_row in a fixed order.
__device__ __forceinline__ void xeq_def_quarters(const xeq_bf16* dfw_s, int w_st,
                                                 const xeq_bf16* wfp, int wst, int hs, int kwp,
                                                 float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, cq = lane & 3;
  const int kq = warp >> 2, ksn = hs >> 4;
  red += kq * XEQ_BT * kwp;
  for (int f0 = (warp & 3) * 8; f0 < kwp; f0 += 32) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    for (int ks = kq * ksn / 4; ks < (kq + 1) * ksn / 4; ++ks) {
      const xeq_bf16* d0 = dfw_s + gq * w_st + ks * 16 + 2 * cq;
      const uint32_t a[4] = {xeq_ld2(d0), xeq_ld2(d0 + 8 * w_st), xeq_ld2(d0 + 8),
                             xeq_ld2(d0 + 8 * w_st + 8)};
      const xeq_bf16* w0 = wfp + (f0 + gq) * wst + ks * 16 + 2 * cq;
      xeq_mma(c, a, xeq_ld2(w0), xeq_ld2(w0 + 8));
    }
    red[gq * kwp + f0 + 2 * cq] = c[0];
    red[gq * kwp + f0 + 2 * cq + 1] = c[1];
    red[(gq + 8) * kwp + f0 + 2 * cq] = c[2];
    red[(gq + 8) * kwp + f0 + 2 * cq + 1] = c[3];
  }
}

// The d_ef row of slot t of the tile by its warp: the filter columns f <
// kw (the four quarters of red in order) and zeros past kf; the harmonic
// columns kw <= f < kf are written by the pass that sums them.
__device__ __forceinline__ void xeq_def_row(const float* red, int t, float* row, int kw,
                                            int kf, int kwp) {
  for (int f = threadIdx.x & 31; f < XEQ_FPACK; f += 32) {
    if (f >= kw && f < kf) continue;
    float v = 0.f;
    if (f < kw) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v += red[(q * XEQ_BT + t) * kwp + f];
    }
    row[f] = v;
  }
}

// Copy n16 16-byte chunks from shared to global memory by the lanes of one
// warp (a slot's bf16 row to a scratch row).
__device__ __forceinline__ void xeq_copy_row(xeq_bf16* __restrict__ to, const xeq_bf16* from,
                                             int n16) {
  for (int c = threadIdx.x & 31; c < n16; c += 32)
    reinterpret_cast<uint4*>(to)[c] = reinterpret_cast<const uint4*>(from)[c];
}

// The sum over a warp of each of the XEQ_MAXY per-lane harmonic sums hy:
// lane y gets column y's.
__device__ __forceinline__ float xeq_harmonic_sums(float (&hy)[XEQ_MAXY]) {
  const int lane = threadIdx.x & 31;
  float mine = 0.f;
#pragma unroll
  for (int y = 0; y < XEQ_MAXY; ++y) {
    for (int o = 16; o > 0; o >>= 1) hy[y] += __shfl_xor_sync(0xffffffffu, hy[y], o);
    if (lane == y) mine = hy[y];
  }
  return mine;
}

// One row to stage: the global row ``g`` read as [g[0:w1) | g[off2:off2 +
// 8n - w1)] (w1 a multiple of 8) into ``s``, n 16-byte chunks.
struct XeqSeg {
  xeq_bf16* s;
  const xeq_bf16* g;
  int w1, off2, n;
};

// Issue the cp.async copies of N rows of one slot by the lanes of one
// warp, the rows' chunks dealt out together; zero-filled when !ok.
template <int N>
__device__ __forceinline__ void xeq_stage_segs(const XeqSeg (&sg)[N], bool ok) {
  const int lane = threadIdx.x & 31;
  int total = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) total += sg[i].n;
  for (int r = lane; r < total; r += 32) {
    int q = r;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (q >= 0 && q < sg[i].n) {
        const int c = q * 8;
        xeq_cp16(sg[i].s + c, sg[i].g + (c < sg[i].w1 ? c : sg[i].off2 + c - sg[i].w1), ok);
      }
      q -= sg[i].n;
    }
  }
}

// out [n_rows, ow] f32: one warp per row r sums the bf16 scratch rows
// ptr[r] .. ptr[r+1]-1 (contiguous, in list order), XEQ_DX_CPL 16-byte
// chunks per lane, two rows' loads in flight.  Scratch column c < w1 goes
// to column c, w1 <= c < w1 + w2 to off2 + c - w1; the other columns are
// written zero, as is a row with no scratch row.  Each element is written
// once.  Launched with 256 threads, 8 rows per block.
__device__ __forceinline__ void xeq_rows_sum(const xeq_bf16* __restrict__ rows,
                                             const int* __restrict__ ptr, float* __restrict__ out,
                                             int n_rows, int w1, int w2, int off2, int ow) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= n_rows) return;
  const int rs = w1 + w2;
  const int p0 = __ldg(ptr + r), p1 = __ldg(ptr + r + 1);
  const int nch = rs >> 3;
  float* o_row = out + (int64_t)r * ow;
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
      const int col = c * 8, dc = col < w1 ? col : off2 + col - w1;
      float4* o = reinterpret_cast<float4*>(o_row + dc);
      o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = w1 + 4 * lane; c < off2; c += 128) *reinterpret_cast<float4*>(o_row + c) = z;
  for (int c = off2 + w2 + 4 * lane; c < ow; c += 128) *reinterpret_cast<float4*>(o_row + c) = z;
}

// The filter-weight gradient of a tile pass whose Kf x H partial does not
// fit a block's registers (Kf > 32 or H > 16 * 8 * XEQ_BT_NTW): the tile
// pass writes each slot's bf16 dfw row (and, in the second order, its dfwr
// row) to a scratch of ast columns per slot, and this pass sums, on the
// tensor cores, part[p] = sum over the slots k of range p of
// ef[k, :ke]^T (x) a[k] (+ ce[k, :ke]^T (x) b[k] when ce is given): a block
// takes one slot range of per slots (a multiple of 16) and 128 columns, all
// ke <= 128 rows in 32-row groups, 16 slots at a time, the next 16 slots'
// rows loaded into registers while the current ones are multiplied.
// part [n_part, kf, h] f32; summed by xeq_dwf_reduce_kernel in block order,
// so the result repeats bit for bit.
#define XEQ_DP_THREADS 256
#define XEQ_DP_COLS 128
#define XEQ_DP_EST 136  // shared row strides (bf16): ke columns + 8
#define XEQ_DP_RST 136  // XEQ_DP_COLS + 8

__global__ void __launch_bounds__(XEQ_DP_THREADS)
xeq_dwf_pass_kernel(const xeq_bf16* __restrict__ ef, const xeq_bf16* __restrict__ a,
                    const xeq_bf16* __restrict__ ce, const xeq_bf16* __restrict__ b,
                    float* __restrict__ part, int n_rows, int per, int ast, int ke, int kf,
                    int h) {
  __shared__ __align__(16) xeq_bf16 e_s[2][XEQ_BT * XEQ_DP_EST];
  __shared__ __align__(16) xeq_bf16 r_s[2][XEQ_BT * XEQ_DP_RST];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, cq = lane & 3;
  const int n_src = ce ? 2 : 1, c0 = blockIdx.y * XEQ_DP_COLS, ng = ke >> 5;
  const int k_lo = blockIdx.x * per, k_hi = min(k_lo + per, n_rows);
  // this thread's chunks of a 16-slot step: ef chunk (t, j) for tid < 16 *
  // ke / 8, row chunk (t, j) of the 16 x 16 chunks of the column tile
  const int et = tid / (ke >> 3), ej = tid - et * (ke >> 3);
  const int rt = tid >> 4, rj = tid & 15;
  const bool e_mine = tid < XEQ_BT * (ke >> 3);
  const xeq_bf16* es[2] = {ef, ce};
  const xeq_bf16* rs[2] = {a, b};
  uint4 ve[2], vr[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      ve[s] = vr[s] = z;
      if (s >= n_src) continue;
      if (e_mine && k0 + et < k_hi)
        ve[s] = __ldg(reinterpret_cast<const uint4*>(es[s] + (int64_t)(k0 + et) * XEQ_FPACK) + ej);
      const int col = c0 + rj * 8;
      if (k0 + rt < k_hi && col < ast)
        vr[s] = __ldcs(reinterpret_cast<const uint4*>(rs[s] + (int64_t)(k0 + rt) * ast + col));
    }
  };
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][m][q] = 0.f;
  if (k_lo < k_hi) fetch(k_lo);
  for (int k0 = k_lo; k0 < k_hi; k0 += XEQ_BT) {
    __syncthreads();  // the previous step's fragments are read
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s >= n_src) continue;
      if (e_mine) reinterpret_cast<uint4*>(e_s[s] + et * XEQ_DP_EST)[ej] = ve[s];
      reinterpret_cast<uint4*>(r_s[s] + rt * XEQ_DP_RST)[rj] = vr[s];
    }
    __syncthreads();
    if (k0 + XEQ_BT < k_hi) fetch(k0 + XEQ_BT);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (s >= n_src) continue;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int nt = warp + 8 * i;  // the n8 tile of the column tile
        const xeq_bf16* d0 = r_s[s] + 2 * cq * XEQ_DP_RST + nt * 8 + gq;
        const uint32_t b0 = xeq_pack(d0[0], d0[XEQ_DP_RST]);
        const uint32_t b1 = xeq_pack(d0[8 * XEQ_DP_RST], d0[9 * XEQ_DP_RST]);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          if (g >= ng) continue;
          uint32_t fa[2][4];
          xeq_frag_at(fa, e_s[s] + 32 * g, XEQ_DP_EST);
          xeq_mma(acc[i][2 * g], fa[0], b0, b1);
          xeq_mma(acc[i][2 * g + 1], fa[1], b0, b1);
        }
      }
    }
  }
  float* out = part + (int64_t)blockIdx.x * kf * h;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int f = 16 * m + gq + 8 * (q >> 1);
        const int c = c0 + (warp + 8 * i) * 8 + 2 * cq + (q & 1);
        if (f < kf && c < h) out[(int64_t)f * h + c] = acc[i][m][q];
      }
}

// Launch the d_wf pass and the reduction of its partials into dwf [128,
// hp] over n_part slot ranges of the first n_rows scratch rows (the
// slots; the scratch's rows past them, up to a whole tile, are zero and
// ef has none).
static int xeq_dwf_pass(const xeq_bf16* ef, const xeq_bf16* a, const xeq_bf16* ce,
                        const xeq_bf16* b, float* part, float* dwf, int n_rows, int n_part,
                        int ast, int kf, int h, int hp, cudaStream_t s) {
  const int ke = xeq_round_up(kf, XEQ_BT_KE);
  const int per = xeq_round_up((n_rows + n_part - 1) / n_part, XEQ_BT);
  // every block writes its partial, zero when its range is empty
  dim3 grid(n_part, (h + XEQ_DP_COLS - 1) / XEQ_DP_COLS);
  xeq_dwf_pass_kernel<<<grid, XEQ_DP_THREADS, 0, s>>>(ef, a, ce, b, part, n_rows, per, ast, ke,
                                                      kf, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(part, dwf, n_part, kf, h,
                                                                     hp);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The first-order backward's mma.sync tile pass (message_bwd.cu): its sizes
// and shared-memory layout and the staging of one tile; and the dx pass of
// both its tile passes, which the stream floor (bwd_stream_floor.cu) runs
// too.
// ---------------------------------------------------------------------------
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
  int ke;      // edge-feature columns staged: Kf rounded up to 32
  int est;     // their row stride (bf16): ke + 8, conflict-free fragments
  int kwp;     // rows of wf in the K slices of fw and the columns of d_ef: Kw to 32
  int wf_smem;   // wf's live rows copied to shared memory, else read from L2
  int nst;       // stages: 2 (the next tile's copies behind this one's compute) or 1
  int dwf_regs;  // the d_wf partial in registers (Kf <= 32, H <= 768), else
                 // dfw rows to a scratch and xeq_dwf_pass
  int off_g, off_e, off_pos, stage;  // within a stage; stage size
  int off_wf, off_dfw, off_dfo, off_tab, smem;
};

// Issue the cp.async copies of one tile (slots k0 .. k0+XEQ_BT-1, one warp
// per slot, its indices in ``ix``) into a stage: each slot's x row (gs and
// gv columns), g row (gms_s and gms_v columns) and its edge-feature
// columns, zero-filled for padding slots, slots past the covered range and
// slots past n_slots; and its scratch row (position in the CSR list by
// source, -1 for slots that add nothing).
__device__ __forceinline__ void xeq_tile_load(unsigned char* st, int est, int k0, XeqSlotIdx ix,
                                              const XeqTileDims& p,
                                              const xeq_bf16* __restrict__ x,
                                              const xeq_bf16* __restrict__ g,
                                              const xeq_bf16* __restrict__ ef) {
  const int t = threadIdx.x >> 5;
  const bool ok = ix.dst >= 0;
  const XeqSeg sg[3] = {
      {(xeq_bf16*)st + t * p.xs_st, x + (int64_t)(ok ? ix.src : 0) * (p.hp + p.dp), p.ht8,
       p.hp, p.rs >> 3},
      {(xeq_bf16*)(st + p.off_g) + t * p.gs_st, g + (int64_t)(ok ? ix.dst : 0) * (p.sdp + p.dp),
       p.sd8, p.sdp, (p.sd8 + p.dt8) >> 3},
      {(xeq_bf16*)(st + p.off_e) + t * est, ef + (int64_t)(ok ? k0 + t : 0) * XEQ_FPACK,
       est - 8, 0, (est - 8) / 8}};
  xeq_stage_segs(sg, ok);
  if ((threadIdx.x & 31) == 0) ((int*)(st + p.off_pos))[t] = ok ? ix.pos : -1;
}

// dx [n_rows, Hp+Dp] f32: the scratch rows summed by source (scratch
// column c goes to dx column c (< ht8) or Hp + c - ht8, the rest is zero).
__global__ void __launch_bounds__(256)
message_bwd_dx_rows_kernel(const xeq_bf16* __restrict__ rows, const int* __restrict__ src_ptr,
                           float* __restrict__ dx, int n_rows, int ht8, int dt8, int hp,
                           int xw) {
  xeq_rows_sum(rows, src_ptr, dx, n_rows, ht8, dt8, hp, xw);
}

// The tile pass's shared-memory layout: two stages and wf's live rows in
// shared memory where they fit, else wf from L2, else one stage; false
// when no layout fits (ops/fused_message.py::_tile_layouts states the
// most compact one).
static bool bwd_tile_dims(XeqTileDims& p, int n_slots, int ni, int h_dim, int hp, int d,
                          int dp, int sdp, int kw, int kf) {
  p.n_slots = n_slots; p.ni = ni; p.h = h_dim; p.hp = hp; p.d = d; p.dp = dp;
  p.sdp = sdp; p.kw = kw; p.kf = kf;
  p.hs = xeq_round_up(h_dim, 16);
  p.ht8 = xeq_round_up(h_dim, 8);
  p.dt8 = xeq_round_up(d, 8);
  p.sd8 = xeq_round_up(h_dim - 2 * ni, 8);
  p.rs = p.ht8 + p.dt8;
  p.xs_st = p.rs + 8;
  p.gs_st = p.sd8 + p.dt8 + 8;
  p.w_st = xeq_round_up(p.hs, 64) + 8;
  p.dfo_st = 2 * ni + 8;
  p.ke = xeq_round_up(kf, XEQ_BT_KE);
  p.est = p.ke + 8;
  p.kwp = xeq_round_up(kw, XEQ_BT_KE);
  p.dwf_regs = kf <= XEQ_BT_KE && p.hs <= 16 * 8 * XEQ_BT_NTW;
  p.off_g = XEQ_BT * p.xs_st * 2;
  p.off_e = p.off_g + XEQ_BT * p.gs_st * 2;
  p.off_pos = p.off_e + XEQ_BT * p.est * 2;
  p.stage = xeq_round_up(p.off_pos + XEQ_BT * 4, 16);
  const int dfo_bytes = XEQ_BT * p.dfo_st * 4, red_bytes = 4 * XEQ_BT * p.kwp * 4;
  const int rest = XEQ_BT * p.w_st * 2 + (dfo_bytes > red_bytes ? dfo_bytes : red_bytes) +
                   xeq_round_up((p.dt8 + ni) * 4, 16);
  const int wf_bytes = p.kwp * p.w_st * 2;
  const int layouts[3][2] = {{2, 1}, {2, 0}, {1, 0}};  // (stages, wf in shared memory)
  p.smem = XEQ_SMEM_MAX + 1;
  p.nst = 1;
  p.wf_smem = 0;
  for (const auto& l : layouts) {
    const int smem = l[0] * p.stage + l[1] * wf_bytes + rest;
    if (smem <= XEQ_SMEM_MAX) {
      p.nst = l[0];
      p.wf_smem = l[1];
      p.smem = smem;
      break;
    }
  }
  p.off_wf = p.nst * p.stage;
  p.off_dfw = p.off_wf + (p.wf_smem ? wf_bytes : 0);
  p.off_dfo = p.off_dfw + XEQ_BT * p.w_st * 2;
  p.off_tab = p.off_dfo + (dfo_bytes > red_bytes ? dfo_bytes : red_bytes);
  return kf - kw <= XEQ_MAXY && d < 65536 && p.sd8 <= p.ht8 && p.ht8 <= hp && p.dt8 <= dp &&
         p.smem <= XEQ_SMEM_MAX;
}
