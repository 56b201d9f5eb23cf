"""The port's building blocks and output heads against the JAX package,
on the CPU: every cutoff and radial basis, ResidualLayer, Gate (with and
without ``refine``), ``scalar_indices``, the conditioned multi-head
XPaiNN (charge and spin embeddings; energy, charges, dipole, polar,
spatial and scalar heads) in f32 on the plain route and in bf16 on the
mega route, the weight bridge on every new parameter name,
``InferenceEngine.predict``'s per-head outputs, the loss and metrics on
charge, dipole and polarizability targets, and ``run_train`` of the
multi-head model.  Charge conservation,
dipole equivariance and polarizability symmetry are held on the port
alone, as tests/test_models_extra.py holds them on the JAX package.

Tolerances: 1e-5 relative per op; whole-model outputs within 1e-4 of
their largest magnitude in f32, 2e-2 in bf16 (bench.py's band).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models import basic as jbasic
from xequinet_tpu.models import o3layer as jo3layer
from xequinet_tpu.models import rbf as jrbf
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops import o3ops as jo3ops
from xequinet_tpu.ops.irreps import Irreps as JIrreps
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_torch.convert import load_flax_params, params_from_flax
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models import basic as tbasic
from xequinet_torch.models import o3layer as to3layer
from xequinet_torch.models import rbf as trbf
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.models.output import resolve_output
from xequinet_torch.models.properties import make_forward
from xequinet_torch.ops import o3ops as to3ops
from xequinet_torch.run.inference import InferenceEngine, batch_to_device

from .helpers import random_rotation
from .test_torch_model import LAYOUT, _jax_forward, _jax_params, _port

IRREPS = "16x0e+8x1o+4x2e"
HEADS = ["energy", "charges", "dipole", "polar", "spatial", "scalar"]
MULTI = dict(node_dim=16, node_irreps=IRREPS, embed_basis="one-hot", num_basis=8,
             action_blocks=1, charge_embed=True, spin_embed=True, output_modes=HEADS,
             magnitude=True, isotropic=True)
# the other head options, with another basis and cutoff (held against JAX
# on the free XPaiNN-Ewald in tests/test_torch_ewald.py)
MULTI_B = dict(MULTI, conservation=False, reduce_op="mean", hidden_irreps="8x0e+8x1o+4x2e",
               rbf_kernel="expbern", cutoff_fn="polynomial")
GRAPH_OUT = [keys.TOTAL_ENERGY, keys.DIPOLE, keys.DIPOLE_MAGNITUDE, keys.POLARIZABILITY,
             keys.ISO_POLARIZABILITY, keys.SPATIAL_EXTENT, keys.SCALAR_OUTPUT]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-12)
    assert float(np.abs(got - want).max()) <= tol * scale, (float(np.abs(got - want).max()),
                                                          scale)


def _flax_apply(module, *args):
    """(flax variables' params as numpy, output) of a flax module."""
    variables = module.init(jax.random.PRNGKey(3), *args)
    params = jax.tree_util.tree_map(np.asarray, variables.get("params", {}))
    # perturb every leaf so that a parameter read from the wrong place shows
    params = jax.tree_util.tree_map(lambda p: p + 0.05 * np.cos(np.arange(p.size)).reshape(
        p.shape).astype(p.dtype), params)
    return params, np.asarray(module.apply({"params": params}, *args))


def _port_apply(module, params, *args):
    if params:
        load_flax_params(module, params)
    with torch.no_grad():
        return module(*[torch.as_tensor(np.asarray(a)) for a in args]).numpy()


@pytest.mark.parametrize("name,kw", [("cosine", {}), ("polynomial", {}),
                                     ("polynomial", {"order": 5}), ("exponential", {}),
                                     ("flat", {}), ("flat", {"offset_factor": 0.3})])
def test_cutoffs_match_jax(name, kw):
    d = np.linspace(0.0, 5.5, 301, dtype=np.float32)[:, None]
    want = np.asarray(jrbf.resolve_cutoff(name, 5.0, **kw)(jnp.asarray(d)))
    got = trbf.resolve_cutoff(name, 5.0, **kw)(torch.as_tensor(d)).numpy()
    _rel(got, want, 1e-5)
    assert got[-1, 0] == 0.0 and np.isfinite(got).all()


@pytest.mark.parametrize("kernel", ["bessel", "gaussian", "expbern", "expnorm"])
def test_rbfs_match_jax(kernel):
    """Every basis with its flax parameters (``alpha`` of expbern a 0-d
    parameter), at zero (padding edges) and across the cutoff."""
    d = np.concatenate([[0.0], np.linspace(0.3, 5.0, 63)]).astype(np.float32)[:, None]
    params, want = _flax_apply(jrbf.resolve_rbf(kernel, 12, 5.0), jnp.asarray(d))
    module = trbf.resolve_rbf(kernel, 12, 5.0)
    assert f"{type(module).__name__}_0" == f"{type(jrbf.resolve_rbf(kernel, 12, 5.0)).__name__}_0"
    got = _port_apply(module, params, d)
    _rel(got, want, 1e-5)
    if kernel == "expbern":
        assert module.alpha.shape == ()


def test_residual_layer_and_scalar_indices_match_jax():
    x = np.random.default_rng(5).normal(size=(11, 16)).astype(np.float32)
    params, want = _flax_apply(jbasic.ResidualLayer(node_dim=16, n_layers=2), jnp.asarray(x))
    _rel(_port_apply(tbasic.ResidualLayer(16, n_layers=2), params, x), want, 1e-5)
    for irreps in (IRREPS, "3x1o+2x0e+1x2e+4x0e", "2x1e+1x0o"):
        np.testing.assert_array_equal(to3ops.scalar_indices(irreps),
                                      jo3ops.scalar_indices(irreps))


@pytest.mark.parametrize("refine", [False, True])
def test_gate_matches_jax(refine):
    irreps = "4x0e+2x1o+4x0e+3x2e"  # simplified inside the gate
    x = np.random.default_rng(7).normal(size=(9, JIrreps(irreps).dim)).astype(np.float32)
    params, want = _flax_apply(jo3layer.Gate(irreps=JIrreps(irreps), refine=refine),
                               jnp.asarray(x))
    module = to3layer.Gate(irreps, refine=refine)
    assert bool(params) == refine == bool(list(module.parameters()))
    _rel(_port_apply(module, params, x), want, 1e-5)


def _molecules(seed, n_mols=3, port=False):
    rng = np.random.default_rng(seed)
    dps = []
    for _ in range(n_mols):
        n = int(rng.integers(5, 9))
        z = rng.integers(1, 9, n).astype(np.int32)
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        cls = Datapoint if port else JDatapoint
        dps.append(cls(z, pos, edge_index=ei, charge=int(rng.integers(-2, 3)),
                       spin=int(rng.integers(0, 3))))
    return dps


@pytest.fixture(scope="module")
def multihead():
    """(model kwargs, batch, flax parameters, the JAX forward with
    forces) of the conditioned multi-head XPaiNN; the init batch carries
    the charge and spin keys, as the JAX trainer's does."""
    kw = MULTI
    batch = collate(_molecules(71))
    assert keys.TOTAL_CHARGE in batch and keys.TOTAL_SPIN in batch
    params = _jax_params(kw, batch)
    return kw, batch, params, _jax_forward(kw, params, batch)


def graph_totals(x, batch):
    return np.bincount(batch[keys.BATCH], weights=np.asarray(x, dtype=np.float64),
                       minlength=batch[keys.GRAPH_MASK].shape[0])


def test_multihead_matches_jax(multihead):
    """Every head, f32, plain route (the charge and spin embeddings
    conditioning the node scalars), with energy forces."""
    kw, batch, params, want = multihead
    got = _port(kw, params)(batch_to_device(batch, "cpu"), True, False)
    gm, nm = batch[keys.GRAPH_MASK], batch[keys.NODE_MASK]
    for k in GRAPH_OUT:
        _rel(got[k][gm], np.asarray(want[k])[gm], 1e-4)
    _rel(got[keys.FORCES][nm], np.asarray(want[keys.FORCES])[nm], 1e-4)
    _rel(got[keys.ATOMIC_CHARGES][nm], np.asarray(want[keys.ATOMIC_CHARGES])[nm], 1e-4)
    if kw.get("conservation", True):
        q = graph_totals(got[keys.ATOMIC_CHARGES], batch)
        np.testing.assert_allclose(q[gm], batch[keys.TOTAL_CHARGE][gm], atol=1e-4)


def test_multihead_bf16_mega_within_band(multihead):
    """bf16 message and update pipelines on the mega route (the port's
    plain message op against the JAX mega kernels in interpret mode):
    every per-graph head within 2e-2, and per atom (as forces are held)
    the mean |charge|: the two packages round bf16 at different points,
    so single atoms' charges move by up to 2.4% of the largest."""
    kw, _, params, _ = multihead
    batch = collate(_molecules(71), kernel_layout=LAYOUT)
    kw = dict(kw, use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16),
              compute_dtype="bfloat16", update_compute_dtype="bfloat16")
    want = _jax_forward(kw, params, batch, interpret=True, compute_forces=False)
    got = _port(kw, params)(batch_to_device(batch, "cpu"), False, False)
    gm, nm = batch[keys.GRAPH_MASK], batch[keys.NODE_MASK]
    for k in GRAPH_OUT:
        _rel(got[k][gm], np.asarray(want[k])[gm], 2e-2)
    a = float(got[keys.ATOMIC_CHARGES][nm].abs().mean())
    w = float(np.abs(np.asarray(want[keys.ATOMIC_CHARGES])[nm]).mean())
    assert abs(a - w) <= 2e-2 * w, (a, w)


def test_predict_returns_every_head(multihead):
    """InferenceEngine.predict returns each graph's dipole, polarizability,
    scalar output and spatial extent and each atom's charges, as the JAX
    engine does, equal to the JAX forward on the same batch."""
    kw, batch, params, want = multihead
    module, extra, cutoff = resolve_model("xpainn", **kw)
    load_flax_params(module, jax.tree_util.tree_map(np.asarray, params))
    eng = InferenceEngine(module=module, model_kwargs=kw, extra=extra, cutoff=cutoff,
                          device="cpu")
    dps = _molecules(71, port=True)
    res = eng.predict(dps)
    off = 0
    per_graph = [keys.TOTAL_ENERGY, keys.DIPOLE, keys.POLARIZABILITY, keys.SCALAR_OUTPUT,
                 keys.SPATIAL_EXTENT]
    for g, (dp, r) in enumerate(zip(dps, res)):
        n = dp.num_atoms
        assert set(r) == set(per_graph) | {keys.FORCES, keys.ATOMIC_CHARGES,
                                           keys.ATOMIC_ENERGIES}
        for k in per_graph:
            _rel(r[k], np.asarray(want[k])[g], 1e-4)
        for k in (keys.FORCES, keys.ATOMIC_CHARGES):
            _rel(r[k], np.asarray(want[k])[off:off + n], 1e-4)
        off += n


@pytest.mark.parametrize("model,kw", [
    ("xpainn", MULTI_B),
    ("xpainn-ewald", dict(MULTI, use_pbc=True, num_k_points=[2, 2, 2], ewald_blocks=2,
                          ewald_output_mode=["energy", "charges"])),
    ("xpainn-ewald", dict(MULTI, use_pbc=False, rbf_kernel="gaussian", layer_norm=False)),
])
def test_weight_bridge_maps_every_new_name(model, kw):
    """Every leaf of the flax tree (raw params such as ``down_projection``
    and ``alpha``, 0-d arrays, the heads' O3Linear / Gate / ScalarMLP,
    the Ewald blocks' ResidualLayer_0..3, LayerNorm_0, Dense_0/1) lands on
    the port's parameter of the same path, Dense kernels transposed; the
    strict check refuses a missing or an extra leaf."""
    jm, _, _ = jax_resolve_model(model, **kw)
    dps = _molecules(81)
    if kw.get("use_pbc"):
        for d in dps:
            d.cell, d.pbc = np.eye(3) * 20.0, np.array([True] * 3)
            d.cell_offsets = np.zeros((d.edge_index.shape[1], 3), dtype=np.int64)
    b = {k: jnp.asarray(v) for k, v in collate(dps).items()}
    shapes = jax.eval_shape(lambda d: jm.init(jax.random.PRNGKey(0), compute_edge_data(d)),
                            b)["params"]
    rng = np.random.default_rng(9)
    tree = jax.tree_util.tree_map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                                  shapes)
    module, _, _ = resolve_model(model, **kw)
    sd = params_from_flax(tree, module)
    module.load_state_dict(sd, strict=True)
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        parts = [p.key for p in path]
        names.add(parts[-1] if not parts[-2].startswith("Dense_") else "Dense")
        name = ".".join(["blocks", parts[0][len("blocks_"):]] + parts[1:])
        if parts[-1] == "kernel":
            name, leaf = name[: -len("kernel")] + "weight", leaf.T
        elif parts[-1] == "scale":
            name = name[: -len("scale")] + "weight"
        np.testing.assert_array_equal(module.get_parameter(name).detach().numpy(), leaf)
    if model == "xpainn-ewald" and kw["use_pbc"]:
        assert "down_projection" in names
    if kw.get("rbf_kernel") == "expbern":
        alpha = module.state_dict()["blocks.0.ExponentialBernstein_0.alpha"]
        assert "alpha" in names and alpha.shape == ()
    with pytest.raises(KeyError, match="unmapped"):
        params_from_flax(dict(tree, extra_leaf={"kernel": np.zeros((2, 2))}), module)


def _port_multihead(seed=0):
    module, extra, _ = resolve_model("xpainn", **MULTI)
    init_params(module, seed=seed)
    return make_forward(module.requires_grad_(False), extra)


def _port_batch(dps):
    from xequinet_torch.data.batching import collate as tcollate

    return batch_to_device(tcollate(dps), "cpu")


def test_port_charge_dipole_polar_properties():
    """On the port alone (seeded weights): atomic charges sum to each
    graph's charge; the dipole rotates with the molecule and the
    polarizability is symmetric and rotates as R a R^T."""
    fwd = _port_multihead()
    rng = np.random.default_rng(91)
    dps = _molecules(92, port=True)
    dps[0].charge = 2
    out = fwd(_port_batch(dps), False, False)
    q = out[keys.ATOMIC_CHARGES].numpy()
    off = 0
    for dp in dps:
        np.testing.assert_allclose(q[off:off + dp.num_atoms].sum(), dp.charge, atol=1e-4)
        off += dp.num_atoms
    R = random_rotation(rng)
    rot = [Datapoint(d.atomic_numbers, d.pos @ R.T, edge_index=d.edge_index, charge=d.charge,
                     spin=d.spin) for d in dps]
    out_r = fwd(_port_batch(rot), False, False)
    for g in range(len(dps)):
        d, d_r = out[keys.DIPOLE][g].numpy(), out_r[keys.DIPOLE][g].numpy()
        np.testing.assert_allclose(d_r, R @ d, rtol=2e-3, atol=1e-4)
        a, a_r = out[keys.POLARIZABILITY][g].numpy(), out_r[keys.POLARIZABILITY][g].numpy()
        np.testing.assert_allclose(a, a.T, atol=1e-5)
        np.testing.assert_allclose(a_r, R @ a @ R.T, rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("name", ["painn", "so3krates", "xmatnet"])
def test_unported_families_and_cartesian_head_raise(name):
    """The families once missing from the port now build (held against JAX
    in tests/test_torch_painn_so3krates.py and test_torch_xe3net_xmatnet.py),
    as does the Cartesian head; a name neither package knows raises."""
    kw = dict(node_dim=24, target_basis={"H": [0]}, elements=["H"])
    module, extra, _ = resolve_model(name, **kw)
    assert extra and sum(p.numel() for p in module.parameters()) > 0
    assert resolve_output("cartesian", node_dim=16, node_irreps=IRREPS) is not None
    with pytest.raises(NotImplementedError, match="Unsupported model"):
        resolve_model(name + "-x", **kw)
    with pytest.raises(NotImplementedError, match="Unsupported output head"):
        resolve_output(name, node_dim=16)


def test_loss_and_metric_on_head_targets_match_jax():
    """WeightedLoss and ErrorMetric on atomic charges (masked by atom),
    the dipole and the polarizability (masked by graph), as the JAX
    package's: the same padded batch and predictions give the same loss
    terms and metric sums."""
    from xequinet_tpu.training import loss as jloss
    from xequinet_torch.training import loss as tloss

    rng = np.random.default_rng(101)
    batch = collate(_molecules(102))
    n, g = batch[keys.NODE_MASK].shape[0], batch[keys.GRAPH_MASK].shape[0]
    arrays = {keys.ATOMIC_CHARGES: (n,), keys.DIPOLE: (g, 3), keys.POLARIZABILITY: (g, 3, 3)}
    target = dict(batch, **{k: rng.normal(size=s).astype(np.float32)
                            for k, s in arrays.items()})
    result = {k: rng.normal(size=s).astype(np.float32) for k, s in arrays.items()}
    weights = {keys.ATOMIC_CHARGES: 2.0, keys.DIPOLE: 0.5, keys.POLARIZABILITY: 0.1}
    j = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    t = lambda d: batch_to_device(d, "cpu")
    for fn in ("l2", "l1", "smoothl1", "matloss"):
        want, want_terms = jloss.WeightedLoss(fn, **weights)(j(result), j(target))
        got, got_terms = tloss.WeightedLoss(fn, **weights)(t(result), t(target))
        _rel(got.numpy(), np.asarray(want), 1e-6)
        for k in weights:
            _rel(got_terms[k].numpy(), np.asarray(want_terms[k]), 1e-6)
    want = jloss.ErrorMetric(*weights)(j(result), j(target))
    got = tloss.ErrorMetric(*weights)(t(result), t(target))
    assert set(got) == set(want) == set(weights)
    for k in weights:
        for a, b in zip(got[k], want[k]):
            _rel(a.numpy(), np.asarray(b), 1e-6)


def test_run_train_multihead(tmp_path):
    """run_train, 2 epochs of the conditioned multi-head XPaiNN on the
    mega route (the plain message op on the CPU) on an XDB of molecules
    with charge, spin, energy, forces, atomic charges, dipole and
    polarizability labels: the loss falls and the last checkpoint serves
    every head."""
    from xequinet_torch.data.store import create_dataset
    from xequinet_torch.run.train import run_train
    from xequinet_torch.utils.config import load_config

    rng = np.random.default_rng(111)
    dps = []
    for d in _molecules(112, n_mols=16, port=True):
        n = d.num_atoms
        q = rng.normal(size=n) * 0.3
        dps.append(Datapoint(d.atomic_numbers, d.pos, charge=d.charge, spin=d.spin,
                             energy=float(rng.normal()), forces=rng.normal(size=(n, 3)),
                             atomic_charges=q - q.mean() + d.charge / n,
                             dipole=rng.normal(size=3), polar=np.eye(3) * 5.0))
    create_dataset(tmp_path / "db", dps, units={})
    targets = [keys.TOTAL_ENERGY, keys.FORCES, keys.ATOMIC_CHARGES, keys.DIPOLE,
               keys.POLARIZABILITY]
    over = {
        "model": {"model_kwargs": dict(MULTI, output_modes=HEADS[:4],
                                       use_pallas_scatter="mega",
                                       pallas_layout=(8, 8, 16, 16))},
        "data": {"db_path": str(tmp_path / "db"), "targets": targets, "batch_size": 4,
                 "valid_batch_size": 4},
        "trainer": {"max_epochs": 2, "warmup_epochs": 1, "lossfn": "l2", "max_lr": 2e-3,
                    "losses_weight": dict(zip(targets, (1.0, 10.0, 5.0, 1.0, 0.1))),
                    "save_dir": str(tmp_path / "out"), "log_steps": 1000, "seed": 0},
    }
    run_train(load_config(overrides=over), device="cpu")
    log = (tmp_path / "out" / "loss.log").read_text()
    train_loss = [float(x.split()[0]) for x in log.split("train-loss ")[1:]]
    assert len(train_loss) == 2 and train_loss[1] < train_loss[0], train_loss
    eng = InferenceEngine(str(tmp_path / "out" / "xequinet_last.ckpt"), device="cpu")
    for dp, r in zip(dps[:3], eng.predict(dps[:3])):
        assert r[keys.DIPOLE].shape == (3,) and r[keys.POLARIZABILITY].shape == (3, 3)
        np.testing.assert_allclose(r[keys.ATOMIC_CHARGES].sum(), dp.charge, atol=1e-4)
