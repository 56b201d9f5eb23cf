"""The port's PaiNN and SO3krates (xequinet_torch.models.painn /
so3krates) against the JAX package on the CPU, on one flax parameter
tree carried over by ``load_flax_params`` (strict: no key left over or
missing): energy and forces of PaiNN (one-hot and gfn2-xtb embeddings)
and of SO3krates at ``max_l`` 3 (with and without the layer norms), a
JAX-written checkpoint of each served by the port's
``InferenceEngine(device="cpu")``, and, on the port alone, SO3krates'
energy invariance and force covariance under a random rotation.

Tolerances: energies 1e-5 relative, forces 1e-4 of the largest
component (whole-model forces, as tests/test_torch_model.py holds them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models.model import make_apply_forward
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.training.trainer import save_checkpoint
from xequinet_tpu.utils.config import ModelConfig, config_to_dict
from xequinet_torch.convert import load_flax_params, params_from_flax
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.run.inference import InferenceEngine, batch_to_device

from .helpers import random_rotation

PAINN = dict(node_dim=16, action_blocks=2, num_basis=8)
SO3 = dict(node_dim=24, node_channel=8, max_l=3, num_heads=4, action_blocks=2, num_basis=8,
           embed_basis="one-hot")
CASES = {
    "painn-onehot": ("painn", dict(PAINN, embed_basis="one-hot")),
    "painn-gfn2": ("painn", PAINN),  # the default embedding, gfn2-xtb aux56
    "so3krates-ln": ("so3krates", dict(SO3, layer_norm=True)),
    "so3krates": ("so3krates", SO3),
}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _molecules(seed, n_mols=3, port=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(5, 9))
        z = rng.integers(1, 9, n).astype(np.int32)
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        out.append((Datapoint if port else JDatapoint)(z, pos, edge_index=ei))
    return out


def _rel(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.fixture(scope="module", params=list(CASES))
def family(request):
    """(model, kwargs, batch, flax params, the JAX forward with forces)."""
    model, kw = CASES[request.param]
    batch = collate(_molecules(5))
    jm, extra, _ = jax_resolve_model(model, **kw)

    def init_and_forward(d):  # one XLA program: compiling takes seconds
        params = jm.init(jax.random.PRNGKey(1), compute_edge_data(d))["params"]
        return params, make_apply_forward(jm, extra)(params, d, True, False)

    params, want = jax.tree_util.tree_map(np.asarray, jax.jit(init_and_forward)(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    return model, kw, batch, params, want


def test_model_energy_forces_match_jax(family):
    model, kw, batch, params, want = family
    module, extra, _ = resolve_model(model, **kw)
    load_flax_params(module, params)
    got = make_forward(module.requires_grad_(False), extra)(batch_to_device(batch, "cpu"))
    gm, nm = batch[keys.GRAPH_MASK], batch[keys.NODE_MASK]
    _rel(got[keys.TOTAL_ENERGY][gm], want[keys.TOTAL_ENERGY][gm], 1e-5)
    _rel(got[keys.FORCES][nm], want[keys.FORCES][nm], 1e-4)
    assert np.isfinite(got[keys.FORCES].numpy()).all()  # padding rows too (v = 0)


def test_jax_checkpoint_serves_in_port_engine(family, tmp_path):
    """A checkpoint written by the JAX trainer's ``save_checkpoint``: the
    port rebuilds the model from its config and serves every molecule."""
    model, kw, batch, params, want = family
    path = str(tmp_path / f"{model}.ckpt")
    save_checkpoint(path, params, config_to_dict(ModelConfig(model_name=model,
                                                             model_kwargs=kw)))
    eng = InferenceEngine(path, device="cpu")
    res = eng.predict(_molecules(5, port=True))
    off = 0
    for g, r in enumerate(res):
        n = r[keys.FORCES].shape[0]
        _rel(r[keys.TOTAL_ENERGY], want[keys.TOTAL_ENERGY][g], 1e-5)
        _rel(r[keys.FORCES], want[keys.FORCES][off:off + n], 1e-4)
        off += n


def test_weight_tree_of_every_default_width_maps():
    """The full-width defaults of both builders (PaiNN 128 channels,
    SO3krates 120 / 32 x l <= 3): each leaf of the JAX tree (from
    ``eval_shape``, nothing computed) has a port parameter of its shape."""
    b = {k: jnp.asarray(v) for k, v in collate(_molecules(6)).items()}
    for model in ("painn", "so3krates"):
        jm, _, _ = jax_resolve_model(model)
        shapes = jax.eval_shape(lambda d: jm.init(jax.random.PRNGKey(0),
                                                  compute_edge_data(d)), b)["params"]
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        module, _, _ = resolve_model(model)
        assert len(params_from_flax(tree, module)) == len(module.state_dict())


def test_so3krates_rotation_on_port():
    """On the port alone (seeded weights, f32): a random rotation leaves
    the energy unchanged and rotates the forces."""
    module, extra, _ = resolve_model("so3krates", **dict(SO3, layer_norm=True))
    fwd = make_forward(init_params(module, seed=3).requires_grad_(False), extra)
    from xequinet_torch.data.batching import collate as tcollate

    dps = _molecules(7, port=True)
    out = fwd(batch_to_device(tcollate(dps), "cpu"))
    rot = random_rotation(np.random.default_rng(8))
    dps_r = [Datapoint(d.atomic_numbers, d.pos @ rot.T, edge_index=d.edge_index) for d in dps]
    out_r = fwd(batch_to_device(tcollate(dps_r), "cpu"))
    n_g = len(dps)
    _rel(out_r[keys.TOTAL_ENERGY][:n_g], out[keys.TOTAL_ENERGY][:n_g], 1e-5)
    f = out[keys.FORCES].double().numpy()
    _rel(out_r[keys.FORCES].numpy(), f @ rot.T, 1e-4)
