"""The port's XPaiNN-Ewald (xequinet_torch) against the JAX package, on
the CPU: the k-grids, the periodic model (energy, forces, virial; f32 on
the plain route, bf16 on the mega route against the JAX mega kernels in
interpret mode), the free model with and without the SVD frame, the
delta and SVD-frame transforms, ``run_train`` on cells, and the
Calculator on periodic ghost rows against the JAX Calculator.

Tolerances: whole-model f32 energy, forces and virial within 1e-4 of the
largest magnitude (test_torch_model.py); bf16 within bench.py's 2e-2
band on per-graph energies and mean |F|; host code exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data import transforms as jtf
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models import ewald as jewald
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.training.trainer import save_checkpoint
from xequinet_tpu.utils.config import ModelConfig, config_to_dict
from xequinet_torch.data import transforms as ttf
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.store import create_dataset
from xequinet_torch.interface.calculator import Calculator
from xequinet_torch.models import ewald as tewald
from xequinet_torch.ops.radius_graph import radius_graph_pbc_np
from xequinet_torch.ops.spatial_sort import ghost_layout_pbc
from xequinet_torch.run.inference import InferenceEngine, batch_to_device
from xequinet_torch.run.train import run_train
from xequinet_torch.utils.config import load_config

from .test_torch_calculator import PBC_CAPS, _check, _pbc_chain, jax_calculator
from .test_torch_heads import GRAPH_OUT, HEADS
from .test_torch_model import LAYOUT, _close, _crystals, _jax_forward, _jax_params, _port
from ._torch_jax_native import module_fixture

SMALL = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
             action_blocks=1, output_modes=["energy"], projection_dim=4)
PBC = dict(SMALL, cutoff=3.0, use_pbc=True, num_k_points=[2, 2, 2])
# the free model carries the heads' other options (test_torch_heads.py's
# MULTI_B without the charge and spin embeddings)
FREE = dict(SMALL, use_pbc=False, k_cutoff=0.6, delta_k=0.3, num_k_basis=8,
            output_modes=HEADS, ewald_output_mode=["energy", "charges"], magnitude=True,
            isotropic=True, conservation=False, reduce_op="mean",
            hidden_irreps="8x0e+8x1o+4x2e", rbf_kernel="expbern", cutoff_fn="polynomial")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_order(tmp_path_factory):
    """The JAX package's cell lists built into a private path, so that its
    edge order is the one the port reproduces whatever other workers do to
    the shared library (tests/_torch_jax_native.py)."""
    yield from module_fixture(tmp_path_factory)


def test_k_grids_match_jax():
    for n in ((3, 3, 3), (2, 1, 3)):
        np.testing.assert_array_equal(tewald.get_k_index_product_set(*n),
                                      jewald.get_k_index_product_set(*n))
    assert tewald.get_k_index_product_set(3, 3, 3).shape == (171, 3)
    for args in ((0.4, 0.2, 20, None), (0.6, 0.3, 8, None), (0.4, 0.1, 64, None),
                 (0.5, 0.2, 8, 0.3)):
        for got, want in zip(tewald.get_k_voxel_grid(*args), jewald.get_k_voxel_grid(*args)):
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def crystals():
    """Three small cells, collated plain and with the kernel layout, and
    flax parameters of the periodic model."""
    dps = _crystals(np.random.default_rng(21), n_cells=3)
    plain = collate(dps)
    return plain, collate(dps, kernel_layout=LAYOUT), _jax_params(PBC, plain, "xpainn-ewald")


def test_ewald_pbc_matches_jax(crystals):
    """f32, plain route: energy, forces and the virial (the k-grid is read
    from the strained cell)."""
    batch, _, params = crystals
    want = _jax_forward(PBC, params, batch, compute_virial=True, model="xpainn-ewald")
    got = _port(PBC, params, "xpainn-ewald")(batch_to_device(batch, "cpu"), True, True)
    n_g = int(batch[keys.GRAPH_MASK].sum())
    _close(got[keys.TOTAL_ENERGY][:n_g], want[keys.TOTAL_ENERGY][:n_g], 1e-4)
    _close(got[keys.FORCES], want[keys.FORCES], 1e-4)
    _close(got[keys.VIRIAL][:n_g], want[keys.VIRIAL][:n_g], 1e-4)
    _close(got[keys.ATOMIC_ENERGIES][batch[keys.NODE_MASK]],
           np.asarray(want[keys.ATOMIC_ENERGIES])[batch[keys.NODE_MASK]], 1e-4)


def test_ewald_pbc_bf16_mega_within_band(crystals):
    """bench.py's pbc_ewald_mega path at a small size: bf16 message and
    update pipelines on the mega route, the port's plain message op
    against the JAX mega kernels in interpret mode: per-graph energies
    and mean |F| within 2e-2.  (The f32 mega route with the virial is held
    to the JAX Calculator in test_calculator_ewald_matches_jax.)  The bf16
    virial is not compared at this width: at 16 channels it moves from the
    f32 virial by the rounding points alone, by -0.7% in the JAX package
    and +3.8% in the port on this batch (XPaiNN without Ewald: -2.1% and
    -3.0%)."""
    _, batch, params = crystals
    kw = dict(PBC, use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16),
              compute_dtype="bfloat16", update_compute_dtype="bfloat16")
    want = _jax_forward(kw, params, batch, interpret=True, model="xpainn-ewald")
    got = _port(kw, params, "xpainn-ewald")(batch_to_device(batch, "cpu"), True, False)
    gm, nm = batch[keys.GRAPH_MASK], batch[keys.NODE_MASK]
    _close(got[keys.TOTAL_ENERGY][gm], want[keys.TOTAL_ENERGY][gm], 2e-2)
    a = float(np.abs(np.asarray(got[keys.FORCES])[nm]).mean())
    w = float(np.abs(np.asarray(want[keys.FORCES])[nm]).mean())
    assert abs(a - w) <= 2e-2 * w, (a, w)


def _free_molecules(seed, svd):
    """Four molecules (port and JAX datapoints), in their SVD frame when
    ``svd``, with neighbour lists built after the frame."""
    rng = np.random.default_rng(seed)
    out_t, out_j = [], []
    for _ in range(4):
        n = int(rng.integers(5, 9))
        z = rng.integers(1, 9, n).astype(np.int32)
        pos = rng.normal(size=(n, 3)) * 1.5 + rng.normal(size=3) * 3.0
        f = rng.normal(size=(n, 3))
        dt, dj = Datapoint(z, pos, forces=f), JDatapoint(z, pos, forces=f)
        if svd:
            dt = ttf.SVDFrameTransform(atomic_vector_targets=[keys.FORCES])(dt)
            dj = jtf.SVDFrameTransform(atomic_vector_targets=[keys.FORCES])(dj)
            np.testing.assert_array_equal(dt.pos, dj.pos)
            np.testing.assert_array_equal(dt.forces, dj.forces)
        dj.edge_index = dt.edge_index = radius_graph_np(dt.pos, 5.0)[0]
        out_t.append(dt)
        out_j.append(dj)
    return out_t, out_j


@pytest.fixture(scope="module")
def free_params():
    return _jax_params(FREE, collate(_free_molecules(31, False)[1]), "xpainn-ewald")


@pytest.mark.parametrize("svd", [False, True])
def test_ewald_free_matches_jax(free_params, svd):
    """The free model (k-voxel grid, sinc damping) with every head (and a
    charges head after the Ewald block), the exponential Bernstein basis
    and the polynomial cutoff: energy, forces and each head, f32, plain
    route, on molecules as they come or in their SVD frame."""
    params = free_params
    batch = collate(_free_molecules(31, svd)[1])
    want = _jax_forward(FREE, params, batch, model="xpainn-ewald")
    got = _port(FREE, params, "xpainn-ewald")(batch_to_device(batch, "cpu"), True, False)
    n_g = int(batch[keys.GRAPH_MASK].sum())
    for k in GRAPH_OUT:
        _close(got[k][:n_g], want[k][:n_g], 1e-4)
    nm = batch[keys.NODE_MASK]
    for k in (keys.FORCES, keys.ATOMIC_CHARGES):
        _close(got[k][nm], np.asarray(want[k])[nm], 1e-4)


def test_transforms_match_jax():
    """DeltaTransform on every base field, SVDFrameTransform on a vector
    and a per-atom vector label, and build_transform_pipeline's order
    (units -> delta -> SVD frame -> neighbours), exactly as JAX."""
    rng = np.random.default_rng(41)
    n = 7
    fields = dict(energy=1.5, base_energy=0.25, forces=rng.normal(size=(n, 3)),
                  base_forces=rng.normal(size=(n, 3)), atomic_charges=rng.normal(size=n),
                  base_charges=rng.normal(size=n), dipole=rng.normal(size=3),
                  base_dipole=rng.normal(size=3))
    z, pos = rng.integers(1, 9, n).astype(np.int32), rng.normal(size=(n, 3)) * 2.0
    dt, dj = Datapoint(z, pos, **fields), JDatapoint(z, pos, **fields)
    bases = ["energy", "base_forces", "charges", "dipole"]
    dt, dj = ttf.DeltaTransform(bases)(dt), jtf.DeltaTransform(bases)(dj)
    for f in ("energy", "forces", "atomic_charges", "dipole"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
        assert getattr(dt, "base_" + f if f != "atomic_charges" else "base_charges") is None
    with pytest.raises(ValueError, match="missing"):
        ttf.DeltaTransform(["energy"])(dt)
    kw = dict(vector_targets=keys.DIPOLE, atomic_vector_targets=[keys.FORCES])
    dt, dj = ttf.SVDFrameTransform(**kw)(dt), jtf.SVDFrameTransform(**kw)(dj)
    for f in ("pos", "forces", "dipole"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    pipe_kw = dict(base_targets=["energy"], svd_frame=True, vector_targets=[keys.DIPOLE],
                   cutoff=4.0)
    a = ttf.build_transform_pipeline(**pipe_kw)(Datapoint(z, pos, **fields))
    b = jtf.build_transform_pipeline(**pipe_kw)(JDatapoint(z, pos, **fields))
    for f in ("pos", "energy", "dipole", "edge_index"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _cells(rng, n_cells):
    dps = []
    for _ in range(n_cells):
        n = int(rng.integers(3, 6))
        cell = np.diag(rng.uniform(3.0, 4.0, size=3)) + rng.normal(size=(3, 3)) * 0.1
        pos = rng.uniform(0, 1, size=(n, 3)) @ cell
        dps.append(Datapoint(rng.integers(1, 9, n).astype(np.int32), pos, cell=cell,
                             pbc=np.array([True] * 3), energy=float(rng.normal()),
                             forces=rng.normal(size=(n, 3)),
                             virial=rng.normal(size=(3, 3))))
    return dps


def test_run_train_ewald_cells(tmp_path):
    """run_train, 2 epochs of the periodic XPaiNN-Ewald on the mega route
    (the plain message op on the CPU) on an XDB of cells with energy,
    force and virial labels: the loss falls and the last checkpoint serves
    energies, forces and the virial."""
    dps = _cells(np.random.default_rng(51), 16)
    create_dataset(tmp_path / "db", dps, units={})
    kw = dict(PBC, use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16))
    over = {
        "model": {"model_name": "xpainn-ewald", "model_kwargs": kw},
        "data": {"db_path": str(tmp_path / "db"), "targets": ["energy", "forces", "virial"],
                 "cutoff": 3.0, "batch_size": 4, "valid_batch_size": 4},
        "trainer": {"max_epochs": 2, "warmup_epochs": 1, "lossfn": "l2",
                    "losses_weight": {"energy": 1.0, "forces": 10.0, "virial": 0.1},
                    "max_lr": 2e-3, "save_dir": str(tmp_path / "out"), "log_steps": 1000,
                    "seed": 0},
    }
    run_train(load_config(overrides=over), device="cpu")
    log = (tmp_path / "out" / "loss.log").read_text()
    train_loss = [float(x.split()[0]) for x in log.split("train-loss ")[1:]]
    assert len(train_loss) == 2 and train_loss[1] < train_loss[0], train_loss
    eng = InferenceEngine(str(tmp_path / "out" / "xequinet_last.ckpt"), device="cpu")
    res = eng.predict(dps[:3], compute_virial=True)
    assert all(np.isfinite(r[keys.FORCES]).all() and r[keys.VIRIAL].shape == (3, 3)
               for r in res)


@pytest.fixture(scope="module")
def ewald_ckpt(tmp_path_factory, crystals):
    """A JAX trainer checkpoint of the periodic XPaiNN-Ewald at cutoff 5.0
    with the weights of ``crystals`` (the cutoff sets no parameter's
    shape)."""
    kw = dict(PBC, cutoff=5.0)
    params = crystals[2]
    path = str(tmp_path_factory.mktemp("ewald") / "ewald.ckpt")
    save_checkpoint(path, jax.tree_util.tree_map(np.asarray, params),
                    config_to_dict(ModelConfig(model_name="xpainn-ewald", model_kwargs=kw)))
    return path


@pytest.fixture(scope="module")
def ewald_chain(ewald_ckpt, crystals):
    """The periodic chain and the JAX Calculator's result on it.  The JAX
    Calculator is handed the checkpoint's parameter tree: on its first
    call it would build the same tree by an eager flax init (16 s on the
    CPU) and the checkpoint's restore."""
    z, pos, cell, pbc = _pbc_chain(n=400)
    calc = jax_calculator(ewald_ckpt, compute_virial=True, **PBC_CAPS)
    calc._params = jax.tree_util.tree_map(jnp.asarray, crystals[2])
    return (z, pos, cell, pbc), calc.calculate(z, pos, cell=cell, pbc=pbc)


@pytest.mark.parametrize("pallas", [None, "mega"])
def test_calculator_ewald_matches_jax(ewald_ckpt, ewald_chain, pallas):
    """The port's Calculator serving the periodic XPaiNN-Ewald on the
    periodic chain, on the plain route and on the mega route with its
    periodic ghost rows (whose BATCH is the padding graph's, so their
    K_DOT_R comes from the identity cell and NODE_MASK keeps them out of
    every sum), against the JAX Calculator: energy, forces, virial."""
    (z, pos, cell, pbc), want = ewald_chain
    ei, offs = radius_graph_pbc_np(pos, cell, pbc, 5.0)
    assert ghost_layout_pbc(pos, cell, pbc, ei, offs)["n_ghosts"] > 0
    calc = Calculator(ewald_ckpt, compute_virial=True, pallas=pallas, device="cpu", **PBC_CAPS)
    got = calc.calculate(z, pos, cell=cell, pbc=pbc)
    assert calc.last_route == (pallas or "plain")
    _check(got, want, virial=True)
