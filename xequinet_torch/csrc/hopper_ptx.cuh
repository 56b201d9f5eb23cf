// Hopper's asynchronous pieces in PTX and the layout helpers that the
// Hopper tile passes of the message kernels share: message_bwd_hopper.cuh
// (message_bwd.cu and bwd_stream_floor.cu), message_bwd2_hopper.cuh
// (message_bwd2.cu) and message_fwd_hopper.cuh (message_fwd.cu).
// mbarriers (init, arrive, arrive with a byte count, a bounded wait), bulk
// copies global -> shared counted on an mbarrier and shared -> global in
// bulk groups, the async-proxy fence, named barriers, wgmma's fences,
// commit and waits, its no-swizzle shared-memory descriptors and the
// products the passes issue, a warp's sum of 32 per-lane values by
// recursive halving (the Hopper pass of message_bwd and the f32 tile passes
// of message_f32_tile.cuh), the core-matrix offset of a stage's
// edge-feature columns, and the pair-row order of H with wf's live rows in
// it (the second order's and the forward's passes).
#pragma once

#include "message_tile.cuh"

// ---------------------------------------------------------------------------
// Hopper's asynchronous pieces, in PTX
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t xeq_sa(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void xeq_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(xeq_sa(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void xeq_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(xeq_sa(bar)) : "memory");
}

__device__ __forceinline__ void xeq_mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(xeq_sa(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed;
// traps (the launch then fails) after 2^28 polls, so that a phase that
// never completes raises instead of hanging the card.
__device__ __forceinline__ void xeq_mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = xeq_sa(bar);
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (bulk copies, wgmma).
__device__ __forceinline__ void xeq_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void xeq_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, counted on ``bar``.
__device__ __forceinline__ void xeq_bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                             uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(xeq_sa(dst)),
      "l"(src), "r"(bytes), "r"(xeq_sa(bar))
      : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from shared to
// global memory, in the thread's bulk group; wait_read: until the thread's
// bulk copies have read their shared memory.
__device__ __forceinline__ void xeq_bulk_s2g(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(xeq_sa(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void xeq_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void xeq_bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void xeq_bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void xeq_wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void xeq_wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void xeq_wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Until at most N of the warpgroup's committed groups are pending (they
// complete in order).
template <int N>
__device__ __forceinline__ void xeq_wg_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void xeq_wg_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One step of xeq_halving_sum: the lanes with bit O keep the upper O of
// the 2 O values left, the others the lower, each adding its partner's.
template <int O>
__device__ __forceinline__ void xeq_halving_step(float (&v)[32]) {
  const bool up = threadIdx.x & O;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O], keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// 32 per-lane values summed over the warp by recursive halving (31
// shuffles, a fixed order): lane L ends with the sum of value L in v[0].
__device__ __forceinline__ void xeq_halving_sum(float (&v)[32]) {
  xeq_halving_step<16>(v);
  xeq_halving_step<8>(v);
  xeq_halving_step<4>(v);
  xeq_halving_step<2>(v);
  xeq_halving_step<1>(v);
}

// A shared-memory matrix descriptor, no swizzle: core matrices of 8 rows
// of 16 bytes; lbo = bytes between core matrices along K, sbo = along M
// or N.
__device__ __forceinline__ uint64_t xeq_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((xeq_sa(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d [64 x 16] += A [64 x 16] . B [16 x 16], both from shared memory (TA,
// TB: the operand is stored M- or N-major), f32 accumulators; acc = 0: d =
// A . B, whatever d held (no other instruction need define it first).
template <int TA, int TB>
__device__ __forceinline__ void xeq_wgmma_n16(float (&d)[8], uint64_t da, uint64_t db,
                                              int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d [64 x 32] += A [64 x 16] . B [16 x 32], both from shared memory (TA,
// TB as above); acc = 0 as above.
template <int TA, int TB>
__device__ __forceinline__ void xeq_wgmma_n32(float (&d)[16], uint64_t da, uint64_t db,
                                              int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// d [64 x 32] += A [64 x 16] . B [16 x 32], A from registers (the
// accumulator layout of a 64 x 16 tile, bf16 pairs), B from shared
// memory (TB as above); acc = 0 as above.
template <int TB>
__device__ __forceinline__ void xeq_wgmma_n32_rs(float (&d)[16], const uint32_t (&a)[4],
                                                 uint64_t db, int acc = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// Edge-feature column f of slot t of a stage (core-matrix layout: 16-byte
// rows (t, f/8) at (t/8) * 512 + (f/8) * 128 + (t%8) * 16).
__device__ __forceinline__ int xeq_hb_ef_off(int t, int f) {
  return (t >> 3) * 512 + (f >> 3) * 128 + (t & 7) * 16 + (f & 7) * 2;
}

// Two f32 values rounded to bf16, as f32.
__device__ __forceinline__ float2 xeq_rnd2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

__device__ __forceinline__ __nv_bfloat162 xeq_bf2(xeq_bf16 lo, xeq_bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return v;
}

// The column of H that row rho of m64 tile i stands for in the pair-row
// order (ops/fused_message.py::pair_table), or -1 (padding): in a pair tile
// the pair row q = 32 i + 8 (rho / 16) + rho % 8 of the table, its state
// gate u (rho % 16 < 8) or its harmonic gate ni + u; in a scalar tile the
// node_dim column 64 (i - n_pt) + rho, at 2 ni + c.
__device__ __forceinline__ int xeq_pair_col(int i, int rho, const int* tab, int n_pt, int ni,
                                            int nd) {
  if (i < n_pt) {
    const int e = tab[32 * i + 8 * (rho >> 4) + (rho & 7)];
    if (e < 0) return -1;
    return (e & 1023) + ((rho & 8) ? ni : 0);
  }
  const int c = 64 * (i - n_pt) + rho;
  return c < nd ? 2 * ni + c : -1;
}

// wf's live rows [Kw, H] (of wf [128, hp]) into n_tiles m64 tiles of H in the
// pair-row order, in wgmma's core-matrix layout (row hb * 8 + k of the
// tiles at hb * 512 + (f / 8) * 128 + (f % 8) * 16 + k * 2, 32 columns f):
// zero for f >= Kw, padding rows and tiles past n_mt.  By the block's
// ``threads`` threads, one item (8 rows hb, 8 columns f) each: the rows'
// columns of H looked up once, then all 64 loads issued before the stores.
__device__ __forceinline__ void xeq_load_wf_pairs(unsigned char* wf_s,
                                                  const xeq_bf16* __restrict__ wf,
                                                  const int* tab_s, int n_tiles, int n_mt,
                                                  int n_pt, int ni, int nd, int kw, int hp,
                                                  int threads) {
  for (int it = threadIdx.x; it < n_tiles * 8 * 4; it += threads) {
    const int hb = it >> 2, f0 = (it & 3) * 8, mt = hb >> 3;
    int col[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      col[k] = mt < n_mt ? xeq_pair_col(mt, (hb & 7) * 8 + k, tab_s, n_pt, ni, nd) : -1;
    __align__(16) xeq_bf16 e8[8][8];
#pragma unroll
    for (int ff = 0; ff < 8; ++ff)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        e8[ff][k] = f0 + ff < kw && col[k] >= 0 ? wf[(int64_t)(f0 + ff) * hp + col[k]]
                                                : xeq_b(0.f);
#pragma unroll
    for (int ff = 0; ff < 8; ++ff)
      *reinterpret_cast<uint4*>(wf_s + hb * 512 + (f0 >> 3) * 128 + ff * 16) =
          *reinterpret_cast<const uint4*>(e8[ff]);
  }
}
