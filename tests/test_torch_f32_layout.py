"""The f32 tile passes of the message backwards on the CPU: the route they
take by shape (``fused_message.f32_route``), their consumer units
(``f32_units``), the Python mirror of their shared-memory layout
(``_f32_layout``, csrc/message_f32_tile.cuh's ``f32_tile_dims``) against
the 227 KB a block may take, the second order's f32 scratch, the walk
kernels' names in ``PASSES`` and ``bwd_compare.py --dtype float32``'s
arguments.  Nothing here needs a card or JAX; the passes themselves are
held against their plain versions in tests/test_torch_gpu.py."""

import re

import numpy as np
import pytest
import torch

from xequinet_torch.ops import fused_message as fm
from xequinet_torch.tools import bwd_compare as bc

FLAGSHIP = ("128x0e+64x1o+32x2e", 20, 128)
KERNELS = ("message_bwd", "message_bwd2")


@pytest.mark.parametrize("kernel", KERNELS)
def test_flagship_widths_take_the_f32_tile_pass(kernel):
    """FLAGSHIP_KW's widths (H = 576, Kw = 21, Kf = 30) in f32 take the f32
    tile pass; bf16 keeps the Hopper passes, which take no f32."""
    assert fm.f32_route(kernel, "float32", *FLAGSHIP)
    assert fm.f32_route(kernel, torch.float32, *FLAGSHIP)
    assert not fm.f32_route(kernel, "bfloat16", *FLAGSHIP)
    assert fm.hopper_route("bfloat16", *FLAGSHIP) and fm.hopper2_route("bfloat16", *FLAGSHIP)
    assert not fm.hopper_route("float32", *FLAGSHIP)
    assert not fm.tile_route(kernel, "float32", *FLAGSHIP)


@pytest.mark.parametrize("dims,why", [
    (("128x0e+64x1o+32x2e", 23, 128), "Kf = 33 > 32"),
    (("128x0e+64x1o+32x2e", 118, 128), "Kw = 119, Kf = 128"),
    (("256x0e+128x1o+64x2e", 23, 256), "H = 1152: 18 consumer warps"),
    (("128x0e+64x1o+32x2e", 20, 192), "H = 640: 10 consumer warps"),
], ids=("kf33", "kf128", "h1152", "h640"))
def test_refused_widths_keep_the_walk_kernels(dims, why):
    """Kf > 32, H > 768 and the widths whose units take more than F32_CW
    warps keep the walk kernels (no tile pass takes f32)."""
    for kernel in KERNELS:
        assert not fm.f32_route(kernel, "float32", *dims), why
        assert not fm.tile_route(kernel, "float32", *dims)


def test_cotangent_on_d_wf_keeps_the_walk_kernels():
    """The second order with cwf (on no model path) keeps its walk kernels;
    the first order has no such operand."""
    assert not fm.f32_route("message_bwd2", "float32", *FLAGSHIP, has_cwf=True)
    assert fm.f32_route("message_bwd2", "float32", *FLAGSHIP, has_cwf=False)


@pytest.mark.parametrize("dims,n_cw", [
    (FLAGSHIP, 9), (("16x0e+8x1o+4x2e", 8, 16), 4), (("120x0e+24x1o", 8, 16), 6),
    (("15x0e+8x1o+4x2e", 8, 16), 4), (("8x0e+4x1o+8x0e", 8, 16), 3),
], ids=("flagship", "small", "two_ls", "odd_run", "split_l0"))
def test_units_cover_every_column_and_lane_once(dims, n_cw):
    """Every column of H is some thread's c0 or c1 exactly once and every
    lane of D some irrep thread's exactly once; each warp holds one kind of
    unit (one l, or scalar pairs), padding lanes carry their warp's dim and
    harmonic column; the flagship needs 9 consumer warps."""
    tab, n = fm.f32_units(*dims)
    assert n == n_cw and tab.shape == (32 * n, 4)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    cols = np.concatenate([tab[:, 0], tab[:, 1]])
    cols = np.sort(cols[cols >= 0])
    assert np.array_equal(cols, np.arange(h))
    maps = fm.index_maps(dims[0], dims[1])
    lanes = [j for c0, c1, j0, w in tab.tolist() if j0 >= 0 for j in range(j0, j0 + (w & 255))]
    assert sorted(lanes) == list(range(d))
    for wp in tab.reshape(n, 32, 4):
        assert len({int(w) for w in wp[:, 3]}) == 1  # one dim and one yc a warp
        live = wp[wp[:, 0] >= 0]
        if wp[0, 3] & 255:  # an irrep warp: c0 = u, c1 = ni + u, its lanes and column
            assert np.array_equal(live[:, 1], live[:, 0] + ni)
            assert np.array_equal(live[:, 2], maps["gate_lane0"][live[:, 0]])
            assert np.array_equal(live[:, 3] & 255, maps["gate_dim"][live[:, 0]])
            assert np.array_equal((live[:, 3] >> 8) + kw, maps["lane_ycol"][live[:, 2]])
        else:  # a scalar warp
            assert (live[:, 0] >= 2 * ni).all() and (live[:, 2] == -1).all()


def test_shared_memory_reckoning_fits_a_block():
    """The flagship's f32 layouts against the 227 KB (232,448 bytes) a block
    may take: in the first order 8 slots a stage of x rows (576 + 480 f32),
    g rows (128 + 480), 32 edge-feature columns and 4 indices, 54,400 bytes,
    three stages; in the second order cx rows and cef columns too, 89,216
    bytes, two stages; beside them two reduction buffers (8 x 9 x 32 f32)
    and the barriers."""
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*FLAGSHIP)
    fixed = 2 * 8 * 9 * 32 * 4 + 2 * 4 * 8 + 16
    smem, nst, stage = fm._f32_layout("message_bwd", ni, 128, d, kw, kf)
    assert stage == 54400 == 128 * -(-(8 * 1056 * 4 + 8 * 608 * 4 + 8 * 32 * 4 + 128) // 128)
    assert nst == 3 and smem == 3 * stage + fixed == 181712 <= fm.SMEM_MAX
    smem, nst, stage = fm._f32_layout("message_bwd2", ni, 128, d, kw, kf)
    assert stage == 89216 == 128 * -(-(2 * 8 * 1056 * 4 + 8 * 608 * 4 + 2 * 8 * 32 * 4 + 128)
                                      // 128)
    assert nst == 2 and smem == 2 * stage + fixed == 196944 <= fm.SMEM_MAX
    assert fm.SMEM_MAX == 232448


@pytest.mark.parametrize("dims", [("16x0e+8x1o+4x2e", 8, 16), ("120x0e+24x1o", 8, 16)])
def test_small_widths_take_four_stages(dims):
    """Narrow widths fill the ring: four stages, the most the pass takes."""
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    for kernel in KERNELS:
        smem, nst, _ = fm._f32_layout(kernel, ni, dims[2], d, kw, kf)
        assert nst == fm.F32_MAXST and smem <= fm.SMEM_MAX


def test_second_order_f32_scratch_shape():
    """The f32 second order's only scratch: one [node_dim | D] f32 row per
    slot (each part rounded up to 8 columns), 185,344 x 608 f32 = 450.8 MB
    at the flagship batch; the bf16 passes' d2x scratch is not taken."""
    shape_x, shape_g = fm.bwd2_scratch_shapes(185344, 576, 128, 480)
    assert shape_g == (185344, 608) and shape_x == (185344, 1056)
    assert shape_g[0] * shape_g[1] * 4 == 450756608


def _pass_of(kernel, name):
    hits = [tag for tag, pat in fm.PASSES[kernel] if re.search(rf"\b{pat}\b", name)]
    assert len(hits) <= 1, hits
    return hits[0] if hits else None


def test_passes_name_the_walk_kernels_and_the_f32_passes():
    """PASSES names each launch of the f32 routes by torch.profiler's
    kernel name: the walk kernels' passes (templated names), the f32 tile
    passes as the tile pass, the f32 d2g pass as the d2g pass."""
    cases = {
        "message_bwd": {
            "void message_bwd_dx_kernel<float, false>(float const*)": "dx walk",
            "void message_bwd_slot_kernel<float, false>(float const*)": "slot pass",
            "xeq_def_reduce_kernel(float const*, float*, int, int, int)": "d_ef reduction",
            "xeq_dwf_reduce_kernel(float const*, float*, int, int, int, int)": "d_wf reduction",
            "void message_bwd_f32_kernel<false>(XeqF32Args, XeqF32Dims)": "tile pass",
            "message_bwd_dx_rows_kernel(__nv_bfloat16 const*)": "dx pass",
            "void message_bwd_hopper_kernel<false>(...)": "tile pass",
        },
        "message_bwd2": {
            "void message_bwd2_dg_kernel<float, false, false>(float const*)": "d2g walk",
            "void message_bwd2_dx_kernel<float, false, false>(float const*)": "d2x walk",
            "void message_bwd2_slot_kernel<float, false, true>(float const*)": "slot pass",
            "xeq_def_reduce_kernel(float const*, float*, int, int, int)": "d2ef reduction",
            "void message_bwd2_f32_kernel<false>(XeqF32Args, XeqF32Dims)": "tile pass",
            "message_bwd2_d2g_rows_f32_kernel(float const*, int const*)": "d2g pass",
            "message_bwd2_d2g_rows_kernel(__nv_bfloat16 const*)": "d2g pass",
            "message_bwd2_d2x_rows_kernel(__nv_bfloat16 const*)": "d2x pass",
        },
    }
    for kernel, names in cases.items():
        for name, tag in names.items():
            assert _pass_of(kernel, name) == tag, (kernel, name)


def test_phases_of_the_f32_passes():
    """The f32 probe's stamps name 8 phases a role, and the tool splits the
    f32 pass of both backwards by phase."""
    assert len(fm.PHASES["f32"]) == 8 and len(fm.PHASES["producer_f32"]) == 8
    assert bc.PHASE_PASSES["message_bwd"]["f32"] == ("message_bwd_f32_kernel", "f32",
                                                     "producer_f32")
    assert bc.PHASE_PASSES["message_bwd2"]["f32"][0] == "message_bwd2_f32_kernel"
    with pytest.raises(ValueError):
        fm.f32_phase_stamps("gather_scatter_v2")


def test_bwd_compare_takes_dtype_float32():
    """``bwd_compare.py PARENT --dtype float32 [--kernel message_bwd2]``
    parses; the operands of a batch are cast to f32 with the compute dtype
    set to it; digests tell bits apart and the error is relative to the
    parent's largest magnitude."""
    ap = bc.build_parser()
    a = ap.parse_args(["_archive/parent", "--dtype", "float32", "--kernel", "message_bwd2"])
    assert a.dtype == "float32" and a.kernel == "message_bwd2" and a.trees == ["_archive/parent"]
    assert ap.parse_args(["p"]).dtype == "bfloat16"
    a = ap.parse_args(["p", "--dtype", "float32", "--phases", "f32"])
    assert a.phases == ["f32"]
    with pytest.raises(SystemExit):
        ap.parse_args(["p", "--dtype", "float16"])
    x = torch.ones(3, 2, dtype=torch.bfloat16)
    out = bc.as_dtype((x, x, None, "irreps", 20, "bfloat16"), "float32")
    assert out[0].dtype == torch.float32 and out[2] is None and out[3:] == ("irreps", 20,
                                                                           "float32")
    a, b = (torch.ones(4), torch.zeros(2)), (torch.ones(4), torch.zeros(2))
    assert bc.digest(a) == bc.digest(b) and bc.rel_err(a, b) == 0.0
    c = (torch.ones(4) * (1 + 2 ** -20), torch.zeros(2))
    assert bc.digest(c) != bc.digest(a) and bc.rel_err(c, a) == pytest.approx(2 ** -20, rel=1e-3)
