"""The first-order message backward's choice between its tile passes on the
CPU: ``hopper_route`` (the Hopper tile pass of csrc/message_bwd_hopper.cuh)
against ``tile_route`` (the mma.sync tile pass of csrc/message_bwd.cu), the
Python mirror of the Hopper pass's shared-memory layout, its irrep
segments, and the profiler names of ``PASSES``.  Nothing here needs a card
or JAX; the kernels themselves are held against their plain versions in
tests/test_torch_gpu.py."""

import re

import numpy as np
import pytest

from xequinet_torch.ops import fused_message as fm

FLAGSHIP = ("128x0e+64x1o+32x2e", 20, 128)
# the widths past the first tile passes' limits: Kf = 33, Kf = 128, H = 1152
WIDE = [("128x0e+64x1o+32x2e", 23, 128), ("128x0e+64x1o+32x2e", 118, 128),
        ("256x0e+128x1o+64x2e", 23, 256)]
# widths that the Hopper pass refuses and the mma.sync pass takes with d_wf
# in registers: H = 640 (node_dim 192) and a run of odd multiplicity
MMA_SYNC = [("128x0e+64x1o+32x2e", 20, 192), ("15x0e+8x1o+4x2e", 8, 16)]


def _layout(irreps, nb, nd):
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(irreps, nb, nd)
    return fm._hopper_layout(ni, nd, d, kw, kf)


def test_flagship_widths_take_the_hopper_tile_pass():
    """FLAGSHIP_KW's widths (H = 576, Kf = 30) in bf16 take the Hopper pass,
    with two 16-slot stages: 16 x rows of (576 + 480) * 2 + 16 bytes, 16 g
    rows of (128 + 480) * 2 + 16, 1 KB of edge-feature columns and 64 bytes
    of positions (54,912 with its rounding), beside wf's 36,864 bytes and
    the dfo tile's 16 x 452 f32."""
    assert fm.hopper_route("bfloat16", *FLAGSHIP)
    assert fm.tile_route("message_bwd", "bfloat16", *FLAGSHIP)
    assert not fm.hopper_route("float32", *FLAGSHIP)
    smem, nst, stage = _layout(*FLAGSHIP)
    assert stage == 54912 == 128 * -(-(16 * 2128 + 16 * 1232 + 1024 + 64) // 128)
    assert nst == 2 and smem == (2 * stage + 9 * 4096 + 3 * 2 * 2048 + 2 * 2 * 4096
                                 + 16 * 452 * 4 + 16 * 584 * 2 + 64 + 896 + 128)
    assert smem <= fm.SMEM_MAX


@pytest.mark.parametrize("dims", WIDE, ids=("kf33", "kf128", "h1152"))
def test_wide_widths_keep_the_mma_sync_tile_pass(dims):
    """Kf > 32 or H > 576: the mma.sync tile pass, whose most compact layout
    fits a block."""
    assert not fm.hopper_route("bfloat16", *dims)
    assert fm.tile_route("message_bwd", "bfloat16", *dims)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    assert min(fm._tile_layouts("message_bwd", ni, dims[2], d, kw, kf)) <= fm.SMEM_MAX
    assert not fm._dwf_regs("message_bwd", ni, dims[2], d, kw, kf)  # the WIDE instance


@pytest.mark.parametrize("dims", MMA_SYNC, ids=("h640", "odd_run"))
def test_refused_widths_keep_the_mma_sync_pass_with_dwf_in_registers(dims):
    """H = 640 or an odd run: the Hopper pass refuses them, the mma.sync
    pass keeps its d_wf partial in registers (no dfw rows, no d_wf pass),
    the instance that tests/test_torch_gpu.py and chip_smoke.py's H=640
    shape hold against the plain VJP."""
    assert not fm.hopper_route("bfloat16", *dims)
    assert fm.tile_route("message_bwd", "bfloat16", *dims)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    assert fm._dwf_regs("message_bwd", ni, dims[2], d, kw, kf)
    assert fm._dfw_scratch(True, "message_bwd", 64, ni, dims[2], d, kw, kf, "cpu").numel() == 0


def test_route_rules_by_shape():
    """The Hopper pass's rules: H at most 576 (nine m64 tiles of d_wf
    accumulators), every run of one l of even multiplicity (its lane
    pairs); elsewhere the tile pass takes the shape."""
    cases = {
        ("16x0e+8x1o+4x2e", 8, 16): True,
        ("120x0e+24x1o", 8, 16): True,
        ("64x0e+32x1o+16x2e", 20, 320): True,  # H = 544
        ("64x0e+32x1o+16x2e", 20, 512): False,  # H = 736
        ("15x0e+8x1o", 8, 16): False,  # an odd run
        ("16x0e+8x1o+5x0e", 8, 16): False,  # a second l = 0 run of 5
    }
    for dims, want in cases.items():
        assert fm.hopper_route("bfloat16", *dims) == want, dims
        assert fm.tile_route("message_bwd", "bfloat16", *dims), dims
        if want:
            assert _layout(*dims)[0] <= fm.SMEM_MAX


def test_irrep_segments():
    """Runs of one l: (first irrep, first lane, irreps, l | (first harmonic
    column - Kw) << 8), merged across adjacent irreps of one l."""
    seg = fm.index_maps(*FLAGSHIP[:2])["seg"]
    assert seg.tolist() == [[0, 0, 128, 0], [128, 128, 64, 1 | 1 << 8],
                            [192, 320, 32, 2 | 4 << 8]]
    seg = fm.index_maps("8x0e+4x0o+4x1o", 8)["seg"]
    assert seg.tolist() == [[0, 0, 12, 0], [12, 12, 4, 1 | 1 << 8]]
    maps = fm.index_maps("16x0e+8x1o+5x0e", 8)
    seg = maps["seg"]
    assert seg[:, 2].tolist() == [16, 8, 5] and seg[2].tolist() == [24, 40, 5, 0]
    # every lane of a segment has its l's harmonic columns, in order
    for u0, j0, mul, lw in seg.tolist():
        dim = 2 * (lw & 3) + 1
        lanes = np.arange(j0, j0 + mul * dim)
        assert (maps["lane_ycol"][lanes] - 9 == (lw >> 8) + (lanes - j0) % dim).all()
        assert (maps["gate_dim"][u0:u0 + mul] == dim).all()


def test_passes_name_both_tile_passes():
    """torch.profiler's kernel names, as the split by pass searches them: the
    Hopper and the mma.sync tile passes under "tile pass", the stream
    floor's own."""
    tag, name = fm.PASSES["message_bwd"][0]
    assert tag == "tile pass"
    for key in ("void message_bwd_hopper_kernel<false>(__nv_bfloat16 const*)",
                "void message_bwd_tile_kernel<true, false, false>(__nv_bfloat16 const*)"):
        assert re.search(rf"\b{name}\b", key)
    assert not re.search(rf"\b{name}\b", "void bwd_stream_floor_tile_kernel(int)")
    assert fm.PASSES["bwd_stream_floor"][0] == ("tile pass", "bwd_stream_floor_tile_kernel")


def test_phase_probe_refuses_other_passes():
    with pytest.raises(ValueError, match="hopper"):
        fm.bwd_phase_stamps(*([None] * 5), *FLAGSHIP, 16, 16, 16, "bfloat16", which="walk")
    with pytest.raises(ValueError, match="hopper_route"):
        fm.bwd_phase_stamps(*([None] * 5), *FLAGSHIP, 16, 16, 16, "float32", which="tile")
    assert len(fm.PHASES["tile"]) == len(fm.PHASES["hopper"]) == 8
