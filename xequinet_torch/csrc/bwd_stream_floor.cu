// The stream floor of the first-order message backward on Hopper:
// message_bwd.cu's bf16 tile route with a near-empty body.  Its time is
// what moving the backward's operands and results costs, the floor that no
// change to the backward's arithmetic can go below; beside the tile pass's
// time it says whether the pass waits on its streams or on its body.
//
// Replaces: tools/bwd_stream_floor.py::floor_kernel (:73, launched by the
// pallas_call at :135), the TPU tool that launches _bwd_kernel's grid,
// scalar prefetch and block specs with a body that zeroes dx and d_wf,
// copies each block's x window in by DMA and writes d_ef = ef as f32 on
// the covered chunks.
//
// Here the streams are message_bwd's, not the TPU grid's:
//  * bwd_stream_floor_tile_kernel: message_bwd_tile_kernel's persistent
//    grid (one block of XEQ_BT_THREADS per SM), its walk over XEQ_BT-slot
//    tiles (tile = block + i * grid), its cp.async staging of each slot's
//    x row, g row and edge-feature columns (xeq_tile_load, the same
//    function) in two stages with the slot indices read one tile ahead,
//    its dynamic shared memory (bwd_tile_dims, the same layout) with wf's
//    live rows and the index tables loaded as it loads them.  Its stores:
//    each valid slot's scratch row at its src_pos (zeros, 16-byte stores),
//    each slot's d_ef row (the staged edge-feature columns as f32, read
//    back from shared memory so that every copy stays live; zero past
//    them, and zero on slots that add nothing, whose staging is
//    zero-filled) and the block's d_wf partial (zeros).
//  * message_bwd_dx_rows_kernel and xeq_dwf_reduce_kernel, the backward's
//    own passes (message_tile.cuh, message_common.cuh): dx = 0, the sums
//    of the zero scratch rows, and d_wf = 0.
//
// Bound on the H100: bytes alone.  As a function it reads the live x and
// g rows, the staged edge-feature columns and the slot indices once and
// writes dx, d_ef and d_wf once, about what message_bwd must move (0.056
// ms at 3.35 TB/s at the flagship batch); by design it also stages 3.4 KB
// per slot from L2 and writes and reads back a 2.1 KB scratch row per
// valid slot, as the tile pass does.  The tool
// xequinet_torch/tools/bwd_stream_floor.py prints both counts.
//
// Only the bf16 tile route with the d_wf partial in registers (Kf <= 32, H
// <= 768: the flagship's and the JAX tool's widths); the wrapper
// (ops/fused_message.py::bwd_stream_floor_cuda) refuses other shapes.
#include "message_tile.cuh"

__global__ void __launch_bounds__(XEQ_BT_THREADS, 1)
bwd_stream_floor_tile_kernel(const xeq_bf16* __restrict__ x, const xeq_bf16* __restrict__ ef,
                             const xeq_bf16* __restrict__ wf, const xeq_bf16* __restrict__ g,
                             const int* __restrict__ slot_src, const int* __restrict__ slot_dst,
                             const int* __restrict__ src_pos, const int* __restrict__ lane_gate,
                             const int* __restrict__ lane_ycol,
                             const int* __restrict__ gate_lane0,
                             const int* __restrict__ gate_dim, xeq_bf16* __restrict__ rows,
                             float* __restrict__ d_ef, float* __restrict__ dwf_part,
                             const XeqTileDims p) {
  extern __shared__ __align__(16) unsigned char tile_smem[];
  int* lane_tab = (int*)(tile_smem + p.off_tab);  // [dt8], as the tile pass fills it
  int* gate_tab = lane_tab + p.dt8;               // [ni]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int est = XEQ_BT_KE + 8;  // Kf <= 32: the tile pass's constant stride
  const int n_tiles = (p.n_slots + XEQ_BT - 1) / XEQ_BT;

  if (p.wf_smem)
    xeq_load_wf((xeq_bf16*)(tile_smem + p.off_wf), p.w_st, wf, p.kw, p.h, p.hp, p.hs,
                XEQ_BT_KE, XEQ_BT_THREADS);
  for (int j = tid; j < p.dt8; j += XEQ_BT_THREADS)
    lane_tab[j] = j < p.d ? __ldg(lane_gate + j) | ((__ldg(lane_ycol + j) - p.kw) << 16) : 0;
  for (int u = tid; u < p.ni; u += XEQ_BT_THREADS)
    gate_tab[u] = __ldg(gate_lane0 + u) | (__ldg(gate_dim + u) << 16);

  // the tile pass's walk and staging, step for step
  const int grid = gridDim.x;
  if ((int)blockIdx.x < n_tiles)
    xeq_tile_load(
        tile_smem, est, blockIdx.x * XEQ_BT,
        xeq_slot_idx(blockIdx.x, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr), p,
        x, g, ef);
  xeq_cp_commit();
  XeqSlotIdx ahead =
      xeq_slot_idx(blockIdx.x + grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr);
  for (int it = 0;; ++it) {
    const int tl = blockIdx.x + it * grid;
    if (tl >= n_tiles) break;
    unsigned char* st = tile_smem + (it & (p.nst - 1)) * p.stage;
    xeq_cp_wait_all();
    __syncthreads();  // this tile has landed; the other stage is free
    if (p.nst == 2) {
      if (tl + grid < n_tiles)
        xeq_tile_load(tile_smem + ((it + 1) & 1) * p.stage, est, (tl + grid) * XEQ_BT, ahead, p,
                      x, g, ef);
      xeq_cp_commit();
      ahead =
          xeq_slot_idx(tl + 2 * grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr);
    }
    const xeq_bf16* e_s = (const xeq_bf16*)(st + p.off_e) + warp * est;
    const int pos = ((const int*)(st + p.off_pos))[warp];
    const int k_w = tl * XEQ_BT + warp;  // the slot of this warp

    // the slot's scratch row: zeros, as many bytes as the tile pass writes
    if (pos >= 0) {
      uint4* r = reinterpret_cast<uint4*>(rows + (int64_t)pos * p.rs);
      for (int c = lane; c < (p.rs >> 3); c += 32) r[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    // the slot's d_ef row: lane l writes columns 4 l .. 4 l + 3 of the 128,
    // the staged ones (the first est - 8) from shared memory
    if (k_w < p.n_slots) {
      const int f = 4 * lane;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (f < est - 8) {
        const float2 a = xeq_f2(e_s + f), b = xeq_f2(e_s + f + 2);
        v = make_float4(a.x, a.y, b.x, b.y);
      }
      reinterpret_cast<float4*>(d_ef + (int64_t)k_w * XEQ_FPACK)[lane] = v;
    }
    if (p.nst == 1) {  // the stage is read: the next tile's copies may land
      __syncthreads();
      if (tl + grid < n_tiles)
        xeq_tile_load(tile_smem, est, (tl + grid) * XEQ_BT, ahead, p, x, g, ef);
      xeq_cp_commit();
      ahead =
          xeq_slot_idx(tl + 2 * grid, n_tiles, p.n_slots, slot_src, slot_dst, src_pos, nullptr);
    }
  }

  // the block's d_wf partial [kf, h]: zeros
  float* part = dwf_part + (int64_t)blockIdx.x * p.kf * p.h;
  for (int i = tid; i < p.kf * p.h; i += XEQ_BT_THREADS) part[i] = 0.f;
}

// dx [n_rows, Hp+Dp], d_ef [n_slots, 128] and d_wf [128, hp], f32, with
// message_bwd's operands, plan, maps, scratch (rows: its bf16 [dgs | dgv]
// rows) and per-block partials (dwf_part [n_part, kf, h]).
extern "C" int xeq_bwd_stream_floor(const void* x, const void* ef, const void* wf, const void* g,
                                    const void* src_ptr, const void* slot_src,
                                    const void* slot_dst, const void* src_pos,
                                    const void* lane_gate, const void* lane_ycol,
                                    const void* gate_lane0, const void* gate_dim, void* rows,
                                    void* dx, void* d_ef, void* dwf_part, void* dwf, int n_rows,
                                    int n_slots, int n_part, int ni, int h_dim, int hp, int d,
                                    int dp, int sdp, int kw, int kf, void* stream) {
  if (kw > kf || kf > XEQ_FPACK || (hp + dp) % 128 != 0 || n_part < 1)
    return (int)cudaErrorInvalidValue;
  XeqTileDims p;
  if (!bwd_tile_dims(p, n_slots, ni, h_dim, hp, d, dp, sdp, kw, kf) || !p.dwf_regs)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(bwd_stream_floor_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  bwd_stream_floor_tile_kernel<<<n_part, XEQ_BT_THREADS, p.smem, s>>>(
      (const xeq_bf16*)x, (const xeq_bf16*)ef, (const xeq_bf16*)wf, (const xeq_bf16*)g,
      (const int*)slot_src, (const int*)slot_dst, (const int*)src_pos, (const int*)lane_gate,
      (const int*)lane_ycol, (const int*)gate_lane0, (const int*)gate_dim, (xeq_bf16*)rows,
      (float*)d_ef, (float*)dwf_part, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_rows > 0) {
    message_bwd_dx_rows_kernel<<<(n_rows + 7) / 8, 256, 0, s>>>(
        (const xeq_bf16*)rows, (const int*)src_ptr, (float*)dx, n_rows, p.ht8, p.dt8, hp,
        hp + dp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  xeq_dwf_reduce_kernel<<<(XEQ_FPACK * hp + 255) / 256, 256, 0, s>>>(
      (const float*)dwf_part, (float*)dwf, n_part, kf, h_dim, hp);
  return (int)cudaGetLastError();
}
