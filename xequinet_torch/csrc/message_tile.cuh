// Shared pieces of the bf16 slot-tile kernels (message_fwd.cu,
// message_bwd.cu, message_bwd2.cu): cp.async staging of slot rows,
// mma.sync m16n8k16 products with bf16 operands and f32 accumulators, the
// slot indices of a tile, and the pass that sums per-slot scratch rows
// along a CSR list.
#pragma once

#include "message_common.cuh"

typedef __nv_bfloat16 xeq_bf16;

#define XEQ_BT 16            // slots per tile (the M of the mma tiles)
#define XEQ_BT_THREADS 512   // the backward passes: one warp per slot of a tile
#define XEQ_BT_WARPS 16
#define XEQ_BT_KE 32         // edge-feature columns staged: Kf <= 32
#define XEQ_BT_EST 40        // their row stride (bf16): conflict-free fragments
#define XEQ_BT_NTW 6         // filter-weight n8 tiles a warp keeps: H <= 16 * 8 * 6
#define XEQ_DX_CPL 5         // 16-byte chunks a lane sums per column group
#define XEQ_MAXY 9           // harmonic columns: 2l + 1 for l <= 2
static_assert(XEQ_BT == XEQ_BT_WARPS, "one warp per slot of a tile");

static inline int xeq_round_up(int v, int m) { return (v + m - 1) / m * m; }

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

// wf_s [32][w_st] (bf16) = the live rows of wf [128, hp]: rows f < kw and
// columns h < h, zero elsewhere up to hs columns; by the block's nthr
// threads.
__device__ __forceinline__ void xeq_load_wf(xeq_bf16* wf_s, int w_st,
                                            const xeq_bf16* __restrict__ wf, int kw, int h,
                                            int hp, int hs, int nthr) {
  for (int i = threadIdx.x; i < XEQ_BT_KE * hs; i += nthr) {
    const int f = i / hs, c = i - f * hs;
    wf_s[f * w_st + c] = (f < kw && c < h) ? wf[(int64_t)f * hp + c] : xeq_b(0.f);
  }
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

// d_ef[:, f < 32] = dfw @ wf^T for the 16 slots of a tile on the tensor
// cores (dfw_s [16][w_st] and wf_s [32][w_st] bf16, K = hs): warp w of
// the 16 takes column tile w % 4 and K quarter w / 4, and writes its
// partial to red [4][16][32] (f32), summed by xeq_def_row in a fixed order.
__device__ __forceinline__ void xeq_def_quarters(const xeq_bf16* dfw_s, const xeq_bf16* wf_s,
                                                 int w_st, int hs, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gq = lane >> 2, cq = lane & 3;
  const int f0 = (warp & 3) * 8, kq = warp >> 2, ksn = hs >> 4;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  for (int ks = kq * ksn / 4; ks < (kq + 1) * ksn / 4; ++ks) {
    const xeq_bf16* d0 = dfw_s + gq * w_st + ks * 16 + 2 * cq;
    const uint32_t a[4] = {xeq_ld2(d0), xeq_ld2(d0 + 8 * w_st), xeq_ld2(d0 + 8),
                           xeq_ld2(d0 + 8 * w_st + 8)};
    const xeq_bf16* w0 = wf_s + (f0 + gq) * w_st + ks * 16 + 2 * cq;
    xeq_mma(c, a, xeq_ld2(w0), xeq_ld2(w0 + 8));
  }
  red += kq * XEQ_BT * 32;
  red[gq * 32 + f0 + 2 * cq] = c[0];
  red[gq * 32 + f0 + 2 * cq + 1] = c[1];
  red[(gq + 8) * 32 + f0 + 2 * cq] = c[2];
  red[(gq + 8) * 32 + f0 + 2 * cq + 1] = c[3];
}

// The d_ef row of slot t of the tile by its warp: the filter columns f <
// kw (the four quarters of red in order) and zeros past kf; the harmonic
// columns kw <= f < kf are written by the pass that sums them.
__device__ __forceinline__ void xeq_def_row(const float* red, int t, float* row, int kw,
                                            int kf) {
  for (int f = threadIdx.x & 31; f < XEQ_FPACK; f += 32) {
    if (f >= kw && f < kf) continue;
    float v = 0.f;
    if (f < kw) {
#pragma unroll
      for (int q = 0; q < 4; ++q) v += red[(q * XEQ_BT + t) * 32 + f];
    }
    row[f] = v;
  }
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
