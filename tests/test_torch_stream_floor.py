"""The backward's stream-floor probe of the port
(xequinet_torch/tools/bwd_stream_floor.py, csrc/bwd_stream_floor.cu) on the
CPU: the plain floor against the JAX tool's Pallas kernel in interpret
mode, exactly; the tool's flagship layout against the JAX tool's JSON; the
wrapper's refusals.  The CUDA kernel is held against its plain version on
the card by chip_smoke.py's phase 14."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from xequinet_torch import keys
from xequinet_torch.ops import fused_message as fm
from xequinet_torch.tools import bwd_stream_floor as bsf
from xequinet_tpu.ops.pallas_message import F_PACK, _merged_structure_matrices, _sd_stream

ROOT = Path(__file__).resolve().parents[1]


def _jax_floor_call(n_blocks, max_chunks, n_slots, bn, chunk, pad_nodes, irreps, nb, nd):
    """The JAX tool's floor kernel and pallas_call, rebuilt as
    tools/bwd_stream_floor.py:73-145 builds them, with its widths and
    window of :52-64 (its main() keeps them local and writes a file under
    tools/): the same body, grid, scalar prefetch, block specs and
    scratch."""
    _, _, (h, hp, d, dp, sdp, n_y) = _merged_structure_matrices(irreps, nb, nd)
    window = bn + 2 * ((pad_nodes + 7) // 8) * 8
    xw = hp + dp
    mm = jnp.bfloat16

    def floor_kernel(cb_ref, nc_ref, ws_ref, sd_ref, ef_ref, g_ref,
                     wfby_ref, e123_ref, x_ref,
                     dxwin_ref, def_ref, dwf_ref, xwin_ref, sem_x):
        b = pl.program_id(0)
        c = pl.program_id(1)
        w_dim = xwin_ref.shape[0]

        @pl.when(jnp.logical_and(b == 0, c == 0))
        def _():
            dwf_ref[...] = jnp.zeros_like(dwf_ref)

        @pl.when(c == 0)
        def _():
            dxwin_ref[...] = jnp.zeros_like(dxwin_ref)
            wstart = pl.multiple_of(ws_ref[b], 8)
            copy = pltpu.make_async_copy(
                x_ref.at[pl.ds(wstart, w_dim), :], xwin_ref, sem_x
            )
            copy.start()
            copy.wait()

        @pl.when(c < nc_ref[b])
        def _():
            def_ref[...] = ef_ref[...].astype(jnp.float32)

    def idx_chunk(b, c, *_refs):
        cc = jnp.minimum(c, _refs[1][b] - 1)
        return (_refs[0][b] + cc, 0)

    def idx_sd(b, c, *_refs):
        cc = jnp.minimum(c, _refs[1][b] - 1)
        return (_refs[0][b] + cc, 0, 0)

    const = lambda b, c, *_refs: (0, 0)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=3,
        grid=(n_blocks, max_chunks),
        in_specs=[
            pl.BlockSpec((1, 8, chunk), idx_sd, memory_space=pltpu.VMEM),
            pl.BlockSpec((chunk, F_PACK), idx_chunk, memory_space=pltpu.VMEM),
            pl.BlockSpec((bn, sdp + dp), lambda b, c, *_: (b, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((F_PACK, xw), const, memory_space=pltpu.VMEM),
            pl.BlockSpec((hp, 2 * dp + sdp), const, memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.HBM),
        ],
        out_specs=[
            pl.BlockSpec((1, window, xw), lambda b, c, *_: (b, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((chunk, F_PACK), idx_chunk, memory_space=pltpu.VMEM),
            pl.BlockSpec((F_PACK, hp), const, memory_space=pltpu.VMEM),
        ],
        scratch_shapes=[pltpu.VMEM((window, xw), mm), pltpu.SemaphoreType.DMA],
    )
    return pl.pallas_call(
        floor_kernel,
        out_shape=[
            jax.ShapeDtypeStruct((n_blocks, window, xw), jnp.float32),
            jax.ShapeDtypeStruct((n_slots, F_PACK), jnp.float32),
            jax.ShapeDtypeStruct((F_PACK, hp), jnp.float32),
        ],
        grid_spec=grid_spec,
        compiler_params=pltpu.CompilerParams(vmem_limit_bytes=64 * 1024 * 1024),
    )


def test_plain_floor_matches_the_jax_floor_kernel():
    """chip_smoke's rehearsal batch (12 molecules of bench.py's recipe, rng
    1234, block and chunk 32) at the JAX tool's widths, the operands drawn
    by the port tool: the JAX floor (interpret mode) and the port's plain
    floor give the same bits.  The JAX kernel copies all 128 edge-feature
    columns on every slot of the covered chunks; the port's tile pass
    stages Kf rounded up to 32 columns of the slots that add something (ef
    is zero past Kf by the packing contract) and zero-fills the others.
    So d_ef is compared on the valid slots, all of whose chunks are
    covered, and is zero on the rest; dx and d_wf are zero in both."""
    bn = chunk = 32
    p = bsf.problem("cpu", seed=1234, n_mols=12, bn=bn, chunk=chunk)
    n_blocks, max_chunks, n_slots = p["layout"]
    irreps, nb, nd = p["statics"]
    e123, _, (h, hp, d, dp, sdp, n_y) = _merged_structure_matrices(irreps, nb, nd)
    batch = p["batch"]
    as_np = lambda t: t.float().numpy()
    g_pad = np.zeros((n_blocks * bn, sdp + dp), np.float32)
    g_pad[: p["n_out"]] = as_np(p["g"])
    wfby = np.zeros((F_PACK, hp + dp), np.float32)
    wfby[:, :hp] = as_np(p["wf"])
    bf = lambda a: jnp.asarray(a, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        call = _jax_floor_call(n_blocks, max_chunks, n_slots, bn, chunk, bsf.PAD_NODES,
                               irreps, nb, nd)
        dxwin, d_ef_jax, dwf = call(
            jnp.asarray(batch[keys.K_CHUNK_BASE]), jnp.asarray(batch[keys.K_NCHUNKS]),
            jnp.asarray(batch[keys.K_WSTARTS]),
            _sd_stream(jnp.asarray(batch[keys.K_SRC2]), jnp.asarray(batch[keys.K_DST2]), chunk),
            bf(as_np(p["ef"])), bf(g_pad), bf(wfby), bf(e123), bf(as_np(p["x_cat"])))
    dx, d_ef, d_wf = bsf.plain_floor(p)
    valid = (p["slot_meta"][7]["slot_dst"] >= 0).numpy()
    cb, nc = batch[keys.K_CHUNK_BASE], batch[keys.K_NCHUNKS]
    covered = np.arange(n_slots) < chunk * (int(cb[-1]) + int(nc[-1]))
    assert valid.sum() == p["n_valid"] > 0 and not (valid & ~covered).any()
    np.testing.assert_array_equal(d_ef.numpy()[valid], np.asarray(d_ef_jax)[valid])
    assert not d_ef.numpy()[~valid].any()
    assert not np.asarray(dxwin).any() and not dx.numpy().any()
    assert not np.asarray(dwf).any() and not d_wf.numpy().any()
    assert dx.shape == (p["n_out"], hp + dp) and d_wf.shape == (F_PACK, hp)


def test_flagship_layout_matches_the_jax_tools_json():
    """bench.py's batch at default_rng(0) on the port's collate gives the
    JAX tool's n_blocks, max_chunks and n_slots (tools/bwd_stream_floor.json),
    the tool's byte bound of message_bwd is chip_smoke.py's, and the
    floor's own bound counts what its outputs need: ef's staged columns
    read, d_ef's written, dx's live columns and d_wf's live rows written."""
    import chip_smoke

    batch = bsf.build_batch(np.random.default_rng(0))
    want = json.loads((ROOT / "tools" / "bwd_stream_floor.json").read_text())
    got = bsf.layout_numbers(batch)
    assert got == (want["n_blocks"], want["max_chunks"], want["n_slots"]) == (48, 10, 189952)
    p = dict(statics=(bsf.IRREPS, bsf.NUM_BASIS, bsf.NODE_DIM),
             n_atoms=int(batch[keys.NODE_MASK].sum()),
             edge_mask=torch.as_tensor(batch[keys.EDGE_MASK]))
    (_, _), (bwd_bytes, _), _ = chip_smoke.kernel_costs(p, "bfloat16")
    c = bsf.costs(dict(p, n_valid=int(batch[keys.EDGE_MASK].sum()), layout=got,
                       x_cat=torch.empty((batch[keys.ATOMIC_NUMBERS].shape[0], 0))))
    assert c["bwd_bytes"] == bwd_bytes
    _, _, _, _, (h, _, d, _, _, n_y) = fm.structure_matrices(*p["statics"])
    n_e, ke, kw = int(batch[keys.EDGE_MASK].sum()), 32, bsf.NUM_BASIS + 1
    assert bsf.NUM_BASIS + 1 + n_y <= ke  # Kf, staged as 32 columns
    assert c["floor_bytes"] == n_e * ke * (2 + 4) + (p["n_atoms"] * (h + d) + kw * h) * 4
    assert c["floor_bytes"] < c["bwd_bytes"] and c["moved_bytes"] > 10 * c["floor_bytes"]


def test_floor_wrapper_refuses_cpu_tensors_and_other_routes():
    p = bsf.problem("cpu", seed=1234, n_mols=4, bn=32, chunk=32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        bsf.floor_call(p)
    assert fm._floor_route(bsf.IRREPS, bsf.NUM_BASIS, bsf.NODE_DIM, "bfloat16")
    assert not fm._floor_route(bsf.IRREPS, bsf.NUM_BASIS, bsf.NODE_DIM, "float32")
    assert not fm._floor_route(bsf.IRREPS, 23, bsf.NODE_DIM, "bfloat16")  # Kf = 33


def test_split_must_account_for_the_timed_call():
    """A split by pass gives a reading only with a tile pass and passes that
    sum to at least SPLIT_SHARE of the call's CUDA-event time; launches the
    profiler did not record are named."""
    split = {"tile pass": 0.96, "dx pass": 0.18, "d_wf reduction": 0.011}
    assert bsf.check_split("message_bwd", split, 1.20) == pytest.approx(1.151 / 1.20)
    with pytest.raises(RuntimeError, match="does not account"):
        bsf.check_split("message_bwd", split, 1.151 / (bsf.SPLIT_SHARE - 0.01))
    with pytest.raises(RuntimeError, match="does not account"):
        bsf.check_split("message_bwd", {"dx pass": 0.18}, 0.19)
    assert bsf.seen_note({"tile pass": 9, "dx pass": 10}, 10) == \
        "; tile pass 9 of 10 launches recorded"
    assert bsf.seen_note({"tile pass": 10}, 10) == ""


def test_reading_names_the_gap():
    assert bsf.reading(0.8, 0.02, 0.943)[0] == "stream"
    assert bsf.reading(0.25, 0.02, 0.943)[0] == "body"
    assert bsf.reading(0.55, 0.02, 0.943)[0] == "both"
