"""The port's XPaiNN (xequinet_torch) against the JAX package on one
parameter tree: energy and forces on the plain route and on the mega
route (JAX mega kernels in interpret mode, the port's plain message op on
the CPU), and virial on a small crystal batch.

Tolerance: whole-model energies and forces within 1e-4 relative to the
largest magnitude.  Both packages run f32, but the forces are gradients
through stacked message / update blocks whose sums run in different orders (XLA's
fused reductions vs PyTorch's), and the LayerNorm / RMS divisions amplify
last-bit differences; per-op agreement is 1e-5 (test_torch_o3.py,
test_torch_message.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint
from xequinet_tpu.models.model import make_apply_forward
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from xequinet_torch.convert import load_flax_params
from xequinet_torch.models.model import init_params as torch_init_params
from xequinet_torch.models.model import resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.run.inference import batch_to_device

IRREPS = "16x0e+8x1o+4x2e"
NB = 8
SD = 16
LAYOUT = {"block_nodes": 8, "chunk": 8, "pad_nodes": 16, "max_chunks": 16}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _kw(use_pallas=False, **extra):
    kw = dict(node_dim=SD, node_irreps=IRREPS, embed_basis="one-hot",
              num_basis=NB, action_blocks=2, output_modes=["energy"], **extra)
    if use_pallas:
        kw.update(use_pallas_scatter=use_pallas, pallas_layout=(8, 8, 16, 16))
    return kw


def _molecules(rng, n_mols=3):
    dps = []
    for _ in range(n_mols):
        n = int(rng.integers(5, 9))
        z = rng.integers(1, 9, n).astype(np.int32)
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        dps.append(Datapoint(z, pos, edge_index=ei))
    return dps


def _crystals(rng, n_cells=2):
    dps = []
    for _ in range(n_cells):
        n = int(rng.integers(3, 6))
        cell = np.diag(rng.uniform(3.0, 4.0, size=3)) + rng.normal(size=(3, 3)) * 0.1
        pos = rng.uniform(0, 1, size=(n, 3)) @ cell
        pbc = np.array([True, True, True])
        ei, offs = radius_graph_pbc_np(pos, cell, pbc, 3.0)
        dps.append(Datapoint(rng.integers(1, 9, n).astype(np.int32), pos,
                             cell=cell, pbc=pbc, edge_index=ei, cell_offsets=offs))
    return dps


def _jax_params(kw, batch):
    """flax parameters of the plain-route model (the mega route shares
    the structure), initialised under jit (eager init is slow)."""
    m, _, _ = jax_resolve_model("xpainn", **kw)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    init = jax.jit(lambda d: m.init(jax.random.PRNGKey(0), compute_edge_data(d)))
    return init(b)["params"]


def _jax_forward(kw, params, batch, compute_virial=False, interpret=False):
    m, e, _ = jax_resolve_model("xpainn", **kw)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = jax.jit(lambda p, d: make_apply_forward(m, e)(p, d, True, compute_virial))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            return fwd(params, b)
    return fwd(params, b)


def _port(kw, params):
    module, extra, _ = resolve_model("xpainn", **kw)
    load_flax_params(module, jax.tree_util.tree_map(np.asarray, params))
    return make_forward(module.requires_grad_(False), extra)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale, (
        float(np.abs(got - want).max()), scale)


@pytest.mark.parametrize("route", [False, "mega"])
def test_model_energy_forces_match_jax(rng, route):
    batch = collate(_molecules(rng), kernel_layout=LAYOUT if route else None)
    kw = _kw(route)
    params = _jax_params(_kw(False), batch)
    want = _jax_forward(kw, params, batch, interpret=bool(route))
    got = _port(kw, params)(batch_to_device(batch, "cpu"), True, False)
    n_g = int(batch[keys.GRAPH_MASK].sum())
    _close(got[keys.TOTAL_ENERGY][:n_g], want[keys.TOTAL_ENERGY][:n_g], 1e-4)
    _close(got[keys.FORCES], want[keys.FORCES], 1e-4)


def test_model_virial_matches_jax_crystal(rng):
    batch = collate(_crystals(rng))
    kw = _kw(False, cutoff=3.0)
    params = _jax_params(kw, batch)
    want = _jax_forward(kw, params, batch, compute_virial=True)
    got = _port(kw, params)(batch_to_device(batch, "cpu"), True, True)
    n_g = int(batch[keys.GRAPH_MASK].sum())
    _close(got[keys.TOTAL_ENERGY][:n_g], want[keys.TOTAL_ENERGY][:n_g], 1e-4)
    _close(got[keys.FORCES], want[keys.FORCES], 1e-4)
    _close(got[keys.VIRIAL][:n_g], want[keys.VIRIAL][:n_g], 1e-4)


def test_model_bf16_mega_within_band(rng):
    """Flagship-style bf16 message and update pipelines on the mega route:
    the port (plain op on the CPU) against the JAX mega kernels in
    interpret mode, inside the 2e-2 relative band of the bf16 gate."""
    batch = collate(_molecules(rng), kernel_layout=LAYOUT)
    kw = _kw("mega", compute_dtype="bfloat16", update_compute_dtype="bfloat16")
    params = _jax_params(_kw(False), batch)
    want = _jax_forward(kw, params, batch, interpret=True)
    got = _port(kw, params)(batch_to_device(batch, "cpu"), True, False)
    gm, nm = batch[keys.GRAPH_MASK], batch[keys.NODE_MASK]
    # the quantities of bench.py's accuracy gate: per-graph energies
    # (relative to the largest) and mean |F|.  Elementwise bf16 forces are
    # not compared: XLA keeps some bf16 intermediates in f32 inside its
    # fusions, so the two packages round at different points.
    _close(got[keys.TOTAL_ENERGY][gm], want[keys.TOTAL_ENERGY][gm], 2e-2)
    a = float(np.abs(np.asarray(got[keys.FORCES])[nm]).mean())
    w = float(np.abs(np.asarray(want[keys.FORCES])[nm]).mean())
    assert abs(a - w) <= 2e-2 * w, (a, w)


def test_seeded_init_is_deterministic():
    kw = _kw("mega")
    a, _, _ = resolve_model("xpainn", **kw)
    b, _, _ = resolve_model("xpainn", **kw)
    sa = torch_init_params(a, seed=3).state_dict()
    sb = torch_init_params(b, seed=3).state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
