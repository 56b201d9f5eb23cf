"""The message backwards' choice between their tile passes on the CPU:
``hopper_route`` (the Hopper tile pass of csrc/message_bwd_hopper.cuh)
against ``tile_route`` (the mma.sync tile pass of csrc/message_bwd.cu), the
same for the second order (``hopper2_route``, csrc/message_bwd2_hopper.cuh,
against message_bwd2.cu's tile pass and walk kernels), the Python mirrors
of both Hopper passes' shared-memory layouts, the second order's pair
table, the irrep segments, the profiler names of ``PASSES`` and the phase
probes' refusals.  Nothing here needs a card or JAX; the kernels
themselves are held against their plain versions in
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


# ---------------------------------------------------------------------------
# message_bwd2's Hopper tile pass (csrc/message_bwd2_hopper.cuh)
# ---------------------------------------------------------------------------
def _layout2(irreps, nb, nd):
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(irreps, nb, nd)
    return fm._hopper2_layout(ni, nd, d, kw, kf, fm.pair_table(irreps, nb, nd)[1])


def _column_of_rows(irreps, nb, nd):
    """xeq_h2_col of the pass over every m64 tile's 64 rows: the column of
    H each row stands for, -1 for padding."""
    tab, n_pt = fm.pair_table(irreps, nb, nd)
    ni = fm._launch_dims(irreps, nb, nd)[0]
    cols = []
    for i in range(n_pt + -(-nd // 64)):
        for rho in range(64):
            if i < n_pt:
                e = int(tab[32 * i + 8 * (rho >> 4) + (rho & 7)])
                cols.append(-1 if e < 0 else (e & 1023) + (ni if rho & 8 else 0))
            else:
                c = 64 * (i - n_pt) + rho
                cols.append(2 * ni + c if c < nd else -1)
    return np.array(cols)


def test_flagship_widths_take_the_bwd2_hopper_pass():
    """FLAGSHIP_KW's widths (H = 576, Kf = 30) in bf16 without cwf take the
    second order's Hopper pass, with two 16-slot stages: 16 x rows and 16
    cx rows of (576 + 480) * 2 + 16 bytes, 16 g rows of (128 + 480) * 2 +
    16, 1 KB each of ef and cef columns, 288 bytes each of their harmonic
    columns and 128 bytes of positions (90,624 with its rounding), beside
    wf's 36,864 bytes, three dfw2 tiles, the 12 warps' 16 x 9 harmonic
    cells, the 7 pair tiles' table and the barriers."""
    assert fm.hopper2_route("bfloat16", *FLAGSHIP)
    assert not fm.hopper2_route("bfloat16", *FLAGSHIP, has_cwf=True)
    assert not fm.hopper2_route("float32", *FLAGSHIP)
    smem, nst, stage = _layout2(*FLAGSHIP)
    assert stage == 90624 == 128 * -(-(2 * 16 * 2128 + 16 * 1232 + 2 * 1024 + 2 * 288 + 128)
                                        // 128)
    assert fm.pair_table(*FLAGSHIP)[1] == 7
    assert nst == 2 and smem == (2 * stage + 9 * 4096 + 3 * 2048 + 12 * 16 * 9 * 4
                                 + 7 * 32 * 4 + 64)
    assert smem <= fm.SMEM_MAX


@pytest.mark.parametrize("dims", WIDE + MMA_SYNC, ids=("kf33", "kf128", "h1152", "h640",
                                                         "odd_run"))
def test_bwd2_refused_widths_keep_their_routes(dims):
    """Kf > 32, H > 576 or an odd run: the second order's mma.sync tile
    pass (at H = 1152 its lean layout; at Kf > 32 its WIDE instance; at H =
    640 and the odd run d2wf in registers); f32 and a cotangent on d_wf
    keep the walk kernels at every width."""
    assert not fm.hopper2_route("bfloat16", *dims)
    assert fm.tile_route("message_bwd2", "bfloat16", *dims)
    ni, h, hp, d, dp, sdp, kw, kf = fm._launch_dims(*dims)
    layouts = fm._tile_layouts("message_bwd2", ni, dims[2], d, kw, kf)
    if dims == WIDE[2]:
        assert layouts[0] > fm.SMEM_MAX >= layouts[1]  # lean
    assert fm._dwf_regs("message_bwd2", ni, dims[2], d, kw, kf) == (dims in MMA_SYNC)
    for cwf in (False, True):
        assert not fm.tile_route("message_bwd2", "float32", *dims, has_cwf=cwf)
    assert not fm.tile_route("message_bwd2", "bfloat16", *dims, has_cwf=True)
    assert not fm.hopper2_route("bfloat16", *dims, has_cwf=True)


@pytest.mark.parametrize("dims", [FLAGSHIP, ("16x0e+8x1o+4x2e", 8, 16), ("120x0e+24x1o", 8, 16),
                                  ("2x0e+2x1o", 4, 8)], ids=("flagship", "small", "two_ls",
                                                            "pairs"))
def test_bwd2_pair_table_covers_every_column_once(dims):
    """The pass's row order: every column of H on exactly one row of its m64
    tiles; in each pair tile a warp's 8 row groups hold irreps of one l (or
    padding), each entry's first lane and harmonic column those of its
    irrep; the flagship's groups balanced over the 12 consumer warps."""
    assert fm.hopper2_route("bfloat16", *dims)
    ni, h = fm._launch_dims(*dims)[:2]
    cols = _column_of_rows(*dims)
    assert sorted(cols[cols >= 0].tolist()) == list(range(h))
    tab, n_pt = fm.pair_table(*dims)
    maps = fm.index_maps(*dims[:2])
    kw = dims[1] + 1
    for q0 in range(0, 32 * n_pt, 8):
        group = [int(e) for e in tab[q0:q0 + 8] if e >= 0]
        assert len({(e >> 22) & 3 for e in group}) <= 1
        for e in group:
            u = e & 1023
            assert (e >> 10) & 4095 == maps["gate_lane0"][u]
            assert 2 * ((e >> 22) & 3) + 1 == maps["gate_dim"][u]
            assert kw + ((e >> 24) & 15) == maps["lane_ycol"][maps["gate_lane0"][u]]
    if dims == FLAGSHIP:
        load = [0] * 12
        for i in range(n_pt):
            for w in range(4):
                e = int(tab[32 * i + 8 * w])
                load[(i % 3) * 4 + w] += 2 + 2 * ((e >> 22) & 3) + 1 if e >= 0 else 0
        for i in (7, 8):
            for w in range(4):
                load[(i % 3) * 4 + w] += 3
        assert max(load) == 13 and min(load) == 11


def test_passes_and_phases_name_the_bwd2_passes():
    """torch.profiler's kernel names of the second order's split by pass:
    the Hopper and the mma.sync tile passes under "tile pass", not the
    probe's stamped mma.sync instance; eight phases of each stamped pass."""
    tag, name = fm.PASSES["message_bwd2"][0]
    assert tag == "tile pass"
    for key in ("void message_bwd2_hopper_kernel<false>(__nv_bfloat16 const*)",
                "void message_bwd2_tile_kernel<true, false, false>(__nv_bfloat16 const*)"):
        assert re.search(rf"\b{name}\b", key)
    assert not re.search(rf"\b{name}\b", "message_bwd2_tile_stamped_kernel(__nv_bfloat16 const*)")
    assert len(fm.PHASES["tile2"]) == len(fm.PHASES["hopper2"]) == 8


def test_bwd2_phase_probe_refuses_other_widths():
    args = [None] * 7
    with pytest.raises(ValueError, match="hopper"):
        fm.bwd2_phase_stamps(*args, *FLAGSHIP, 16, 16, 16, "bfloat16", which="walk")
    with pytest.raises(ValueError, match="hopper2_route"):
        fm.bwd2_phase_stamps(*args, *FLAGSHIP, 16, 16, 16, "float32", which="tile")
    with pytest.raises(ValueError, match="hopper2_route"):
        fm.bwd2_phase_stamps(*args, *MMA_SYNC[0], 16, 16, 16, "bfloat16", which="hopper")
