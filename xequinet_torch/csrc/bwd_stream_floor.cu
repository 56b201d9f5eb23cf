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
// Here the streams are message_bwd's, not the TPU grid's: since the
// Hopper redesign of its tile pass, those of message_bwd_hopper_kernel:
// bwd_stream_floor_tile_kernel is the FLOOR instance of its body
// (xeq_hb_body in message_bwd_hopper.cuh, the same template):
//  * the same persistent grid (one block of XEQ_HB_THREADS per SM), walk
//    (tile = block + i * grid, warpgroup c taking the tiles c, c + 2, ...),
//    producer warp with its bulk copies of each valid slot's x row, g row
//    and edge-feature columns into the same ring of stages and mbarriers,
//    and the same dynamic shared memory (bwd_hopper_dims) with the index
//    tables loaded as it loads them;
//  * a near-empty body with the pass's stores: each valid slot's scratch
//    row at its src_pos (zeros, 16-byte stores), each slot's d_ef row (its
//    staged edge-feature columns as f32, read back from shared memory so
//    that every copy stays live; zero past them and on slots that add
//    nothing, whose staged columns the producer writes as zeros) and the
//    block's d_wf partial (zeros);
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
// Only the widths of the Hopper tile pass (the flagship's and the JAX
// tool's); the wrapper (ops/fused_message.py::bwd_stream_floor_cuda)
// refuses other shapes.
#include "message_bwd_hopper.cuh"

// dx [n_rows, Hp+Dp], d_ef [n_slots, 128] and d_wf [128, hp], f32, with
// message_bwd's operands, plan, maps, irrep segments, scratch (rows: its
// bf16 [dgs | dgv] rows) and per-block partials (dwf_part [n_part, kf, h]).
extern "C" int xeq_bwd_stream_floor(const void* x, const void* ef, const void* wf, const void* g,
                                    const void* src_ptr, const void* slot_src,
                                    const void* slot_dst, const void* src_pos,
                                    const void* lane_ycol, const void* gate_lane0,
                                    const void* gate_dim, const void* seg, void* rows, void* dx,
                                    void* d_ef, void* dwf_part, void* dwf, int n_rows,
                                    int n_slots, int n_part, int ni, int h_dim, int hp, int d,
                                    int dp, int sdp, int kw, int kf, int n_seg, void* stream) {
  if (kw > kf || kf > XEQ_FPACK || (hp + dp) % 128 != 0 || n_part < 1)
    return (int)cudaErrorInvalidValue;
  XeqHopperDims p;
  if (!bwd_hopper_dims(p, n_slots, ni, h_dim, hp, d, dp, sdp, kw, kf, n_seg))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_bwd_hopper<true>(x, ef, wf, g, slot_src, slot_dst, src_pos, lane_ycol,
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
