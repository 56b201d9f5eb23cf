"""The port's Cartesian tensor head and XMatNet (xequinet_torch.models.
xe3net / matlayer / xmatnet, utils.mat_toolkit) against the JAX package
on the CPU, on flax parameter trees carried over by ``load_flax_params``:

* XPaiNN with the energy and ``"cartesian"`` heads: energy and the
  Cartesian tensor on the plain route and on the mega route (the port's
  plain message op; the JAX package's plain route on the same
  slot-layout batch; XPaiNN's forces are held in test_torch_model.py),
  and ``CartTensorOut`` alone with ``isotropic``, ``reduce_op="mean"``
  and ``None``;
* ``SelfLayer``, ``PairLayer`` and ``Expansion``;
* ``MatToolkit``'s pad / unpad / blocks / assemble;
* XMatNet's onsite and offsite blocks on both routes;
* ``InferenceEngine.predict``'s per-graph Cartesian tensor against the
  JAX engine's;
* matrix labels through ``collate`` with the kernel layout;
* ``run_train`` of a tiny XMatNet on matrix labels;

and, on the port alone with its own ``wigner_D``, T(Rx) = R T R^T of the
Cartesian head and B(Rx) = D(R) B(x) D(R)^T of XMatNet's blocks.
Tolerances: 1e-5 of the largest entry for the energy, the tensor and
the blocks against JAX; 1e-4 under a rotation on the port (f32 through
the whole model).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate, kernel_slot_cap
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models import matlayer as jmat
from xequinet_tpu.models import xe3net as jxe3
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.irreps import Irreps as JIrreps
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.utils.mat_toolkit import MatToolkit as JMatToolkit
from xequinet_torch.convert import load_flax_params, params_from_flax
from xequinet_torch.data.batching import collate as tcollate
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models import matlayer as tmat
from xequinet_torch.models import xe3net as txe3
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.run.inference import InferenceEngine, batch_to_device
from xequinet_torch.utils.mat_toolkit import MatToolkit

from .helpers import random_rotation
from .test_torch_tensor_product import irreps_D

LAYOUT = {"block_nodes": 8, "chunk": 8, "pad_nodes": 16, "max_chunks": 16}
MEGA = dict(use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16))
XPAINN = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
              action_blocks=1)
CART = dict(XPAINN, output_modes=["energy", "cartesian"], hidden_channels=4, hidden_dim=8)
# def2-SVP's shell structure, H to O (the union basis 3x0e+2x1o+1x2e, D = 14)
SVP = {"H": [0, 0, 1], "He": [0, 0, 1], "Li": [0, 0, 0, 1, 1], "Be": [0, 0, 0, 1, 1]}
SVP.update({e: [0, 0, 0, 1, 1, 2] for e in ("B", "C", "N", "O")})
# one matrix layer (XLA compiles each for seconds); the layers' residual
# inputs are held in the layer tests
XMAT = dict(XPAINN, node_irreps="8x0e+4x1o+2x2e", hidden_irreps="4x0e+4x1o+4x2e",
            n_mat_layers=1, target_basis=SVP, elements=list(SVP))


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _molecules(seed, n_mols=3, port=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(4, 8))
        z = rng.integers(1, 9, n).astype(np.int32)
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        out.append((Datapoint if port else JDatapoint)(z, pos, edge_index=ei))
    return out


def _rel(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-12), err


def _jax_model(model, kw, batch):
    """(flax params as numpy, the JAX model's outputs as numpy) from one
    jitted ``init_with_output`` (no forces)."""
    jm, _, _ = jax_resolve_model(model, **kw)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    out, params = jax.jit(lambda d: jm.init_with_output(jax.random.PRNGKey(2),
                                                        compute_edge_data(d)))(b)
    return tuple(jax.tree_util.tree_map(np.asarray, t) for t in (params["params"], out))


def _port_forward(model, kw, params, batch, compute_forces):
    module, extra, _ = resolve_model(model, **kw)
    load_flax_params(module, params)
    return make_forward(module.requires_grad_(False), extra)(batch_to_device(batch, "cpu"),
                                                              compute_forces)


def _flax_layer(layer, *args):
    """(params as numpy, output) of a flax layer, from one jitted
    ``init_with_output``."""
    out, params = jax.jit(lambda *a: layer.init_with_output(jax.random.PRNGKey(4), *a))(*args)
    return jax.tree_util.tree_map(np.asarray, params["params"]), np.asarray(out)


def _port_layer(module, params, *args):
    load_flax_params(module, params)
    with torch.no_grad():
        return module(*[torch.as_tensor(np.asarray(a)) for a in args]).numpy()


# ---------------------------------------------------------------------------
# the Cartesian tensor head
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cartesian():
    """The slot-layout batch, flax params and the JAX plain route's
    energy and tensor of XPaiNN with the Cartesian head (XPaiNN's forces
    are held against JAX in tests/test_torch_model.py; here the port's
    forces are held finite)."""
    batch = collate(_molecules(41), kernel_layout=LAYOUT)
    return (batch,) + _jax_model("xpainn", CART, batch)


@pytest.mark.parametrize("route", ["plain", "mega"])
def test_cartesian_head_model_matches_jax(cartesian, route):
    batch, params, want = cartesian
    got = _port_forward("xpainn", dict(CART, **(MEGA if route == "mega" else {})), params,
                        batch, True)
    gm = batch[keys.GRAPH_MASK]
    assert got[keys.CARTESIAN_TENSOR].shape == (gm.shape[0], 3, 3)
    _rel(got[keys.CARTESIAN_TENSOR][gm], want[keys.CARTESIAN_TENSOR][gm], 1e-5)
    _rel(got[keys.TOTAL_ENERGY][gm], want[keys.TOTAL_ENERGY][gm], 1e-5)
    assert torch.isfinite(got[keys.FORCES]).all()


@pytest.mark.parametrize("opts", [dict(reduce_op="mean", layer_norm=False),
                                  dict(reduce_op=None), dict(isotropic=True, symmetry="ij=ji")])
def test_cart_tensor_head_options_match_jax(opts):
    """CartTensorOut alone on random node features of a two-graph batch."""
    rng = np.random.default_rng(51)
    irreps, n = "8x0e+4x1o+2x2e", 7
    data = {keys.NODE_INVARIANT: rng.normal(size=(n, 8)).astype(np.float32),
            keys.NODE_EQUIVARIANT: rng.normal(size=(n, JIrreps(irreps).dim)).astype(np.float32),
            keys.BATCH: np.array([0, 0, 0, 1, 1, 2, 2], np.int32),
            keys.NODE_MASK: np.array([1, 1, 1, 1, 1, 0, 0], bool),
            keys.GRAPH_MASK: np.array([1, 1, 0], bool)}
    kw = dict(node_dim=8, hidden_dim=8, hidden_channels=4, **opts)
    head = jxe3.CartTensorOut(node_irreps=JIrreps(irreps), **kw)
    out, params = jax.jit(lambda d: head.init_with_output(jax.random.PRNGKey(5), d))(
        {k: jnp.asarray(v) for k, v in data.items()})
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    want = np.asarray(out[keys.CARTESIAN_TENSOR])
    module = txe3.CartTensorOut(node_irreps=irreps, **kw)
    load_flax_params(module, params)
    with torch.no_grad():
        got = module({k: torch.as_tensor(v) for k, v in data.items()})[keys.CARTESIAN_TENSOR]
    rows = data[keys.NODE_MASK] if opts.get("reduce_op", "sum") is None else data[keys.GRAPH_MASK]
    _rel(got.numpy()[rows], want[rows], 1e-5)


def test_predict_returns_cartesian_tensor_like_jax_engine(cartesian, tmp_path, monkeypatch):
    """Both engines serve one JAX-written checkpoint; the port's predict
    returns each graph's 3 x 3 tensor, equal to the JAX engine's."""
    from xequinet_tpu.run.inference import InferenceEngine as JaxEngine
    from xequinet_tpu.training.trainer import save_checkpoint
    from xequinet_tpu.utils.config import ModelConfig, config_to_dict

    monkeypatch.setenv("XEQ_COMPILE_CACHE", "0")
    _, params, _ = cartesian
    path = str(tmp_path / "cart.ckpt")
    save_checkpoint(path, params, config_to_dict(ModelConfig(model_name="xpainn",
                                                             model_kwargs=CART)))
    jeng = JaxEngine(path)
    jeng._params = jax.tree_util.tree_map(jnp.asarray, params)  # no eager flax init
    want = jeng.predict(_molecules(42), compute_forces=False)
    got = InferenceEngine(path, device="cpu").predict(_molecules(42, port=True),
                                                      compute_forces=False)
    for r, w in zip(got, want):
        assert set(r) == set(w) == {keys.TOTAL_ENERGY, keys.ATOMIC_ENERGIES,
                                    keys.CARTESIAN_TENSOR}
        assert r[keys.CARTESIAN_TENSOR].shape == (3, 3)
        _rel(r[keys.CARTESIAN_TENSOR], w[keys.CARTESIAN_TENSOR], 1e-5)


def test_cartesian_tensor_rotates_on_port():
    """T(R x) = R T(x) R^T for the port's head (seeded weights, f32)."""
    module, extra, _ = resolve_model("xpainn", **CART)
    fwd = make_forward(init_params(module, seed=6).requires_grad_(False), extra)
    dps = _molecules(61, port=True)
    rot = random_rotation(np.random.default_rng(62))
    rot_dps = [Datapoint(d.atomic_numbers, d.pos @ rot.T, edge_index=d.edge_index) for d in dps]
    t = fwd(batch_to_device(tcollate(dps), "cpu"), False)[keys.CARTESIAN_TENSOR][:3]
    t_rot = fwd(batch_to_device(tcollate(rot_dps), "cpu"), False)[keys.CARTESIAN_TENSOR][:3]
    _rel(t_rot.numpy(), rot @ t.double().numpy() @ rot.T, 1e-4)


def test_flagship_width_xmatnet_carries_every_weight():
    """XMatNet's flax tree at the card's widths (FLAGSHIP_KW's XPaiNN and
    the default ``hidden_irreps`` 32x0e+32x1o+32x2e) maps onto the port's
    parameters one to one (``eval_shape``: nothing computed)."""
    b = {k: jnp.asarray(v) for k, v in collate(_molecules(71)).items()}
    kw = dict(node_dim=128, node_irreps="128x0e+64x1o+32x2e", embed_basis="one-hot",
              target_basis=SVP, elements=list(SVP))
    jm, _, _ = jax_resolve_model("xmatnet", **kw)
    shapes = jax.eval_shape(lambda d: jm.init(jax.random.PRNGKey(0), compute_edge_data(d)),
                            b)["params"]
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    module, _, _ = resolve_model("xmatnet", **kw)
    assert len(params_from_flax(tree, module)) == len(module.state_dict())


# ---------------------------------------------------------------------------
# the matrix layers, the toolkit and XMatNet
# ---------------------------------------------------------------------------

IRR_IN = "4x0e+4x1o+4x2e"
IRR_HID = "4x0e+4x1e+4x1o+4x2e"


def test_self_layer_matches_jax():
    """With the previous layer's features added (``fii_in``)."""
    rng = np.random.default_rng(81)
    x = rng.normal(size=(5, JIrreps(IRR_IN).dim)).astype(np.float32)
    prev = rng.normal(size=(5, JIrreps(IRR_HID).dim)).astype(np.float32)
    params, want = _flax_layer(jmat.SelfLayer(irreps_in=JIrreps(IRR_IN),
                                              irreps_hidden=JIrreps(IRR_HID)),
                               jnp.asarray(x), jnp.asarray(prev))
    _rel(_port_layer(tmat.SelfLayer(IRR_IN, IRR_HID), params, x, prev), want, 1e-5)


def test_pair_layer_matches_jax():
    """With the previous layer's features added (``fij_in``)."""
    rng = np.random.default_rng(82)
    x = rng.normal(size=(5, JIrreps(IRR_IN).dim)).astype(np.float32)
    attr = rng.normal(size=(6, 8)).astype(np.float32)
    ei = np.array([[0, 1, 2, 3, 4, 0], [1, 2, 3, 4, 0, 2]], np.int32)
    prev = rng.normal(size=(6, JIrreps(IRR_HID).dim)).astype(np.float32)
    params, want = _flax_layer(jmat.PairLayer(irreps_in=JIrreps(IRR_IN),
                                              irreps_hidden=JIrreps(IRR_HID), edge_attr_dim=8),
                               jnp.asarray(x), jnp.asarray(attr), jnp.asarray(ei),
                               jnp.asarray(prev))
    _rel(_port_layer(tmat.PairLayer(IRR_IN, IRR_HID, 8), params, x, attr, ei, prev), want,
         1e-5)


def test_expansion_matches_jax():
    rng = np.random.default_rng(83)
    block, out = "4x0e+2x1e+2x1o+2x2e", "2x0e+1x1o+1x2e"
    x = rng.normal(size=(3, JIrreps(block).dim)).astype(np.float32)
    embed = rng.normal(size=(3, 16)).astype(np.float32)
    params, want = _flax_layer(jmat.Expansion(irreps_block=JIrreps(block),
                                              irreps_out=JIrreps(out), node_dim=16),
                               jnp.asarray(x), jnp.asarray(embed))
    got = _port_layer(tmat.Expansion(block, out, 16), params, x, embed)
    assert got.shape == (3, 10, 10)
    _rel(got, want, 1e-5)


def test_mat_toolkit_matches_jax():
    rng = np.random.default_rng(84)
    tk, jtk = MatToolkit(SVP, list(SVP)), JMatToolkit(SVP, list(SVP))
    assert str(tk.get_basis_irreps()) == str(jtk.get_basis_irreps()) == "3x0e+2x1o+1x2e"
    for map_type in ("pyscf", "orca"):
        tk, jtk = MatToolkit(SVP, list(SVP), map_type), JMatToolkit(SVP, list(SVP), map_type)
        np.testing.assert_array_equal(tk.m_idx, jtk.m_idx)
        at_no = np.array([8, 1, 1, 6, 3])
        n_orb = 14 + 5 + 5 + 14 + 9
        mat = rng.normal(size=(n_orb, n_orb))
        ei = tk.get_edge_index_full(at_no)
        np.testing.assert_array_equal(ei, jtk.get_edge_index_full(at_no))
        padded = tk.padding_matrix(at_no, mat)
        np.testing.assert_array_equal(padded, jtk.padding_matrix(at_no, mat))
        np.testing.assert_array_equal(tk.unpadding_matrix(at_no, padded), mat)
        nb, eb = tk.get_padded_blocks(at_no, mat, ei)
        for a, b in zip((nb, eb), jtk.get_padded_blocks(at_no, mat, ei)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tk.get_mask(at_no, ei), jtk.get_mask(at_no, ei)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tk.assemble_blocks(at_no, nb, eb, ei), mat)
    with pytest.raises(ImportError):  # a basis by name needs PySCF, as in JAX
        MatToolkit("def2-svp", ["H"])


@pytest.fixture(scope="module")
def xmatnet():
    batch = collate(_molecules(91), kernel_layout=LAYOUT)
    return (batch,) + _jax_model("xmatnet", XMAT, batch)


@pytest.mark.parametrize("route", ["plain", "mega"])
def test_xmatnet_blocks_match_jax(xmatnet, route):
    batch, params, want = xmatnet
    got = _port_forward("xmatnet", dict(XMAT, **(MEGA if route == "mega" else {})), params,
                        batch, False)
    for k in (keys.NODE_MAT_BLOCKS, keys.EDGE_MAT_BLOCKS):
        assert got[k].shape[1:] == (14, 14)
        _rel(got[k], want[k], 1e-5)
    nm = batch[keys.NODE_MASK]
    node = got[keys.NODE_MAT_BLOCKS].numpy()
    np.testing.assert_allclose(node, node.transpose(0, 2, 1), atol=1e-6)  # onsite symmetric
    assert not node[~nm].any() and not got[keys.EDGE_MAT_BLOCKS].numpy()[
        ~batch[keys.EDGE_MASK]].any()


def test_xmatnet_blocks_rotate_on_port():
    """B(R x) = D(R) B(x) D(R)^T for the onsite and offsite blocks (seeded
    weights, f32), with D of the basis irreps 3x0e+2x1o+1x2e."""
    module, extra, _ = resolve_model("xmatnet", **XMAT)
    fwd = make_forward(init_params(module, seed=9).requires_grad_(False), extra)
    dps = _molecules(92, port=True)
    rot = random_rotation(np.random.default_rng(93))
    rot_dps = [Datapoint(d.atomic_numbers, d.pos @ rot.T, edge_index=d.edge_index) for d in dps]
    out = fwd(batch_to_device(tcollate(dps), "cpu"), False)
    out_r = fwd(batch_to_device(tcollate(rot_dps), "cpu"), False)
    d = irreps_D("3x0e+2x1o+1x2e", rot)
    for k in (keys.NODE_MAT_BLOCKS, keys.EDGE_MAT_BLOCKS):
        b = out[k].double().numpy()
        _rel(out_r[k].numpy(), np.einsum("ab,nbc,dc->nad", d, b, d), 1e-4)


def _matrix_molecules(seed, n_mols, port):
    """Molecules with XMatNet labels: the padded blocks of a random
    symmetric AO matrix each."""
    rng = np.random.default_rng(seed)
    tk = MatToolkit(SVP, list(SVP))
    mols = _molecules(seed, n_mols, port)
    for d in mols:
        n_orb = int(sum(tk.atom2mask[int(z)].sum() for z in d.atomic_numbers))
        m = rng.normal(size=(n_orb, n_orb))
        nb, eb = tk.get_padded_blocks(d.atomic_numbers, 0.5 * (m + m.T), d.edge_index)
        d.extras[keys.NODE_MAT_BLOCKS] = nb.astype(np.float32)
        d.extras[keys.EDGE_MAT_BLOCKS] = eb.astype(np.float32)
    return mols


def test_matrix_labels_collate_with_kernel_layout_like_jax():
    """The port's collate puts the node and edge matrix labels in the same
    rows and slots as the JAX package's, with the kernel layout."""
    layout = dict(LAYOUT, slot_cap=kernel_slot_cap(32, 128, LAYOUT))
    want = collate(_matrix_molecules(95, 4, False), 32, 128, 5, kernel_layout=layout)
    got = tcollate(_matrix_molecules(95, 4, True), 32, 128, 5, kernel_layout=layout)
    assert set(got) == set(want)
    for k in (keys.NODE_MAT_BLOCKS, keys.EDGE_MAT_BLOCKS, keys.EDGE_INDEX, keys.EDGE_MASK):
        np.testing.assert_array_equal(got[k], want[k])


def test_run_train_xmatnet(tmp_path):
    """run_train on the CPU, on an XDB of matrix labels on the mega route
    (plain message op): two steps, a finite loss, and the last checkpoint
    serves."""
    from xequinet_torch.data.store import create_dataset
    from xequinet_torch.run.train import run_train
    from xequinet_torch.utils.config import load_config

    create_dataset(tmp_path / "db", _matrix_molecules(97, 8, True), units={},
                   split={"train": list(range(4)), "valid": list(range(4, 8))})
    targets = [keys.NODE_MAT_BLOCKS, keys.EDGE_MAT_BLOCKS]
    over = {
        "model": {"model_name": "xmatnet", "model_kwargs": dict(XMAT, **MEGA)},
        "data": {"db_path": str(tmp_path / "db"), "targets": targets, "batch_size": 2,
                 "valid_batch_size": 4, "node_shift": False, "node_scale": False},
        "trainer": {"max_epochs": 1, "warmup_epochs": 0, "lossfn": "matloss", "max_lr": 2e-3,
                    "losses_weight": {k: 1.0 for k in targets},
                    "save_dir": str(tmp_path / "out"), "log_steps": 1, "seed": 0},
    }
    tr = run_train(load_config(overrides=over), device="cpu")
    assert tr.step == 2
    log = (tmp_path / "out" / "loss.log").read_text()
    loss = [float(x.split()[0]) for x in log.split("train-loss ")[1:]]
    assert loss and all(np.isfinite(loss)), log
    for r in tr.validate().values():
        assert np.isfinite(r["mae"])
