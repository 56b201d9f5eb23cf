"""The port's edge partition (xequinet_torch.parallel.edge_partition)
against the JAX package's, on the CPU.

Four gloo processes (tests/_torch_halo_worker.py, one pool for the
module) each hold every node and a contiguous quarter of the edges of
tests/test_edge_partition.py's periodic supercell and of its free
system; energy, forces and virial against the JAX
``make_edge_parallel_forward`` on a 4-device CPU mesh and against the
port's single-process forward, at that test's limits (energy rtol 1e-5,
forces rtol 1e-4 / atol 1e-5, virial rtol / atol 1e-4).  The padding and
the split are the JAX host function's, and a model on a kernel route is
refused with a pointer to the halo decomposition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate as jax_collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data as jax_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from xequinet_tpu.parallel import edge_partition as jep
from xequinet_tpu.parallel.mesh import GP_AXIS, make_mesh
from xequinet_torch.convert import params_from_flax
from xequinet_torch.models.model import resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.parallel import edge_partition as tep
from xequinet_torch.run.inference import batch_to_device

from tests._torch_halo_worker import run_pool

KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
          cutoff=3.0, action_blocks=2, output_modes=["energy"])
N_SHARDS = 4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _systems():
    """tests/test_edge_partition.py's periodic supercell and free system."""
    rng = np.random.default_rng(0)
    cell = np.diag([6.0, 6.5, 7.0])
    pos = rng.uniform(0, 1, size=(24, 3)) @ cell
    z = rng.integers(1, 9, 24).astype(np.int32)
    ei, offs = radius_graph_pbc_np(pos, cell, np.ones(3, bool), 3.0)
    pbc = JDatapoint(z, pos, cell=cell, pbc=np.ones(3, bool), edge_index=ei, cell_offsets=offs)
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(20, 3)) * 2.5
    z = rng.integers(1, 9, 20).astype(np.int32)
    ei, _ = radius_graph_np(pos, 3.0)
    return {"pbc": (jax_collate([pbc]), 24), "free": (jax_collate([JDatapoint(z, pos,
                                                                              edge_index=ei)]),
                                                     20)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    work = tmp_path_factory.mktemp("edge")
    systems = _systems()
    jm, extra, _ = jax_resolve_model("xpainn", **KW)
    b = {k: jnp.asarray(v) for k, v in systems["pbc"][0].items()}
    params = jax.jit(lambda d: jm.init(jax.random.PRNGKey(0), jax_edge_data(d)))(b)["params"]
    module, _, _ = resolve_model("xpainn", **KW)
    state = {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.array, params), module).items()}
    mesh = make_mesh(N_SHARDS, axis_names=(GP_AXIS,))
    fwd_ep = jep.make_edge_parallel_forward(lambda d: jm.apply({"params": params}, d), mesh)
    refs, cases = {}, {}
    for tag, (batch, n) in systems.items():
        virial = tag == "pbc"
        out = fwd_ep(jep.shard_batch(batch, mesh), True, virial)
        refs[tag] = dict(jax={k: np.asarray(v) for k, v in out.items()}, n=n, batch=batch,
                         virial=virial)
        cases[tag] = dict(kind="edge", kw=KW, state=state, batch=batch, virial=virial)
    cases["refuse"] = dict(kind="edge", kw=dict(KW, use_pallas_scatter="mega"), state=state,
                           refuse=True)
    refs["state"] = state
    return refs, run_pool(cases, work, N_SHARDS)


def _check(got, want, n, virial):
    np.testing.assert_allclose(got[keys.TOTAL_ENERGY][0], want[keys.TOTAL_ENERGY][0],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[keys.FORCES][:n], want[keys.FORCES][:n], rtol=1e-4,
                               atol=1e-5)
    if virial:
        np.testing.assert_allclose(got[keys.VIRIAL][0], want[keys.VIRIAL][0], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("system", ["pbc", "free"])
def test_edge_parallel_matches_jax_and_single_process(pool, system):
    """Every rank's energy, forces and (periodic) virial equal, and against
    the JAX edge-parallel forward and the port's single process."""
    refs, outs = pool
    ref = refs[system]
    for o in outs[1:]:
        for k, v in o[system].items():
            np.testing.assert_array_equal(v, outs[0][system][k])
    _check(outs[0][system], ref["jax"], ref["n"], ref["virial"])
    module, extra, _ = resolve_model("xpainn", **KW)
    module.load_state_dict({k: torch.as_tensor(v) for k, v in refs["state"].items()})
    single = make_forward(module.requires_grad_(False), extra)(
        batch_to_device(ref["batch"], "cpu"), True, ref["virial"])
    _check(outs[0][system], {k: v.numpy() for k, v in single.items()}, ref["n"],
           ref["virial"])


def test_shard_batch_is_the_jax_split():
    """The padded edge axis equals the JAX ``pad_edges_for_shards``; the
    shares concatenate to it, nodes whole on every rank."""
    batch = _systems()["pbc"][0]
    want = jep.pad_edges_for_shards(batch, N_SHARDS)
    got = tep.pad_edges_for_shards(batch, N_SHARDS)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    shares = [tep.shard_batch(batch, N_SHARDS, r) for r in range(N_SHARDS)]
    np.testing.assert_array_equal(np.concatenate([s[keys.EDGE_INDEX] for s in shares], 1),
                                  want[keys.EDGE_INDEX])
    np.testing.assert_array_equal(np.concatenate([s[keys.CELL_OFFSETS] for s in shares]),
                                  want[keys.CELL_OFFSETS])
    assert all(s[keys.POSITIONS] is batch[keys.POSITIONS] for s in shares)


def test_kernel_route_refused(pool):
    _, outs = pool
    err = outs[0]["refuse"]["error"]
    assert err is not None and "halo" in err


def test_parallel_exports_match_jax():
    """``xequinet_torch.parallel`` exports the JAX package's names; without
    a process group the mesh is one process and a stacked batch's slice is
    its first."""
    import xequinet_tpu.parallel as jp
    import xequinet_torch.parallel as tp

    assert tp.__all__ == jp.__all__ and all(hasattr(tp, n) for n in tp.__all__)
    batch = _systems()["free"][0]
    stacked = tp.stack_device_batches([batch, batch])
    want = jp.stack_device_batches([batch, batch])
    for k in want:
        np.testing.assert_array_equal(stacked[k], want[k])
    local = tp.device_put_sharded_batch(stacked, None, "cpu")
    for k in batch:
        np.testing.assert_array_equal(local[k].numpy(), batch[k])
    assert tp.make_mesh() == {tp.DP_AXIS: None}
    assert tp.make_mesh(axis_names=(tp.DP_AXIS, tp.GP_AXIS), shape=(1, 1)) == {
        tp.DP_AXIS: None, tp.GP_AXIS: None}
