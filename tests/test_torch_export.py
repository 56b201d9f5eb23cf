"""The port's export (xequinet_torch.interface.export, ``xeq-torch export``)
and its in-graph periodic neighbour list against the JAX package's, on the
CPU.

One JAX trainer checkpoint per model serves both packages; the same seeded
numpy inputs go to the JAX ``load_exported(...)`` program's ``.call`` and
to the port's loaded ``torch.export`` program (the JAX exports are written
by two spawned processes beside the port's).  Mirrors
tests/test_pipeline.py:233, :295, :356, tests/test_round2.py:303, :346,
:384 and tests/test_xmatnet.py:316 at their sizes.  Tolerances: f32
energy 1e-5 relative; forces, virial, charges, dipole and matrix blocks
1e-4 of their largest magnitude; manifests key for key;
``radius_graph_pbc_fixed`` exactly (tests/test_round2.py:56, :80, :92).
"""

import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint
from xequinet_tpu.interface import export as jexport
from xequinet_tpu.models.model import resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from xequinet_tpu.ops.radius_graph import radius_graph_pbc_fixed as jax_pbc_fixed
from xequinet_tpu.training.trainer import save_checkpoint
from xequinet_tpu.utils import qc as jqc
from xequinet_tpu.utils.config import ModelConfig, config_to_dict
from xequinet_torch import cli
from xequinet_torch.interface import export as texport
from xequinet_torch.interface.calculator import Calculator
from xequinet_torch.ops.radius_graph import radius_graph_pbc_fixed
from xequinet_torch.utils import qc as tqc

KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
          cutoff=5.0, action_blocks=1, output_modes=["energy"])
QKW = dict(KW, output_modes=["energy", "charges", "dipole"])
MAT_BASIS = {"H": [0], "O": [0, 0, 1]}
MAT_KW = dict(node_dim=16, node_irreps="8x0e+4x1o+2x2e", hidden_irreps="8x0e+8x1o+8x2e",
              embed_basis="one-hot", num_basis=8, action_blocks=1, n_mat_layers=1,
              target_basis=MAT_BASIS, elements=["H", "O"], cutoff=5.0)


@pytest.fixture(autouse=True, scope="module")
def _units_and_threads():
    """The exports set the process-wide default units from the checkpoint in
    both packages; put both maps back at the end (a later JAX test in the
    same worker expects eV)."""
    torch.set_num_threads(2)
    saved = dict(jqc.DEFAULT_UNITS_MAP), dict(tqc.DEFAULT_UNITS_MAP)
    yield
    for m, s in zip((jqc.DEFAULT_UNITS_MAP, tqc.DEFAULT_UNITS_MAP), saved):
        m.clear()
        m.update(s)


def _write_ckpt(path, model, kw, dp):
    """A JAX trainer checkpoint of ``model`` at seeded weights (the
    initialisation jitted on ``dp``)."""
    module, _, _ = resolve_model(model, **kw)
    batch = {k: jnp.asarray(v) for k, v in collate([dp]).items()}
    params = jax.jit(lambda d: module.init(jax.random.PRNGKey(0),
                                           compute_edge_data(d))["params"])(batch)
    save_checkpoint(path, params, config_to_dict(ModelConfig(model_name=model,
                                                             model_kwargs=kw)))
    return path


def _molecule(rng, n=6):
    z = rng.integers(1, 5, n).astype(np.int32)
    pos = rng.normal(size=(n, 3)) * 1.5
    ei, _ = radius_graph_np(pos, 5.0)
    return Datapoint(z, pos, edge_index=ei)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(0)
    water = np.array([[0.0, 0.76, -0.48], [0.0, 0.0, 0.1], [0.0, -0.76, -0.48]])
    wpos = water + rng.normal(size=(3, 3)) * 0.05
    wdp = Datapoint(np.array([1, 8, 1], np.int32), wpos, edge_index=radius_graph_np(wpos, 5.0)[0])
    return {"energy": _write_ckpt(str(d / "e.ckpt"), "xpainn", KW, _molecule(rng)),
            "charges": _write_ckpt(str(d / "q.ckpt"), "xpainn", QKW, _molecule(rng, 5)),
            "matrix": _write_ckpt(str(d / "m.ckpt"), "xmatnet", MAT_KW, wdp),
            "water": wdp}


# each test's JAX export: (checkpoint, export_model's arguments)
JAX_EXPORTS = {
    "matrix": ("matrix", dict(max_atoms=8, max_edges=16, output_mode="matrix",
                              compute_virial=False)),
    "energy": ("energy", dict(max_atoms=16, max_edges=128, compute_virial=False)),
    "periodic": ("energy", dict(max_atoms=8, max_edges=1024, periodic=True,
                                compute_virial=True)),
    "gmx": ("energy", dict(max_atoms=8, max_edges=1024, output_mode="gmx", max_reps=1)),
    "dipole": ("charges", dict(max_atoms=8, max_edges=128, output_mode="dipole")),
    "dipole_net": ("charges", dict(max_atoms=8, max_edges=128, output_mode="dipole",
                                   net_charge=-1)),
}


@pytest.fixture(scope="module")
def jax_exports(ckpts, tmp_path_factory):
    """The JAX exports, written by two spawned processes while the port's
    exports run in the tests (the JAX export initialises its model eagerly,
    seconds per model): {name: future of the export directory}."""
    d = tmp_path_factory.mktemp("jax_exports")
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    futures = {name: pool.submit(jexport.export_model, ckpts[ck], str(d / name), **kw)
               for name, (ck, kw) in JAX_EXPORTS.items()}
    yield futures
    pool.shutdown(cancel_futures=True)


def _jax_program(jax_exports, name):
    return jexport.load_exported(jax_exports[name].result(timeout=300))


def _both(jax_exports, name, ckpt, out):
    """The JAX and the port's export of one checkpoint: (JAX program, JAX
    manifest, port program, port manifest); manifests equal key for key."""
    texport.export_model(ckpt, str(out / "torch"), device="cpu", **JAX_EXPORTS[name][1])
    t, tm = texport.load_exported(str(out / "torch"))
    j, jm = _jax_program(jax_exports, name)
    assert tm == jm
    return j, jm, t, tm


def _call(j, t, args):
    """Both programs on the same numpy inputs, as numpy tuples."""
    got = t(*[torch.as_tensor(a) for a in args])
    want = j.call(*[jnp.asarray(a) for a in args])
    return ([g.detach().numpy() for g in got], [np.asarray(w) for w in want])


def _held(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got, np.float64) - want).max()) <= rel * scale


def _energy_forces(got, want):
    assert abs(float(got[0]) - float(want[0])) <= 1e-5 * abs(float(want[0]))
    _held(got[1], want[1], 1e-4)


def _padded(dp, n, e, periodic=False, charge=0):
    pos = np.zeros((n, 3), np.float32)
    pos[:dp.num_atoms] = dp.pos
    z = np.zeros(n, np.int32)
    z[:dp.num_atoms] = dp.atomic_numbers
    ei = np.zeros((2, e), np.int32)
    ei[:, :dp.num_edges] = dp.edge_index
    args = [pos, z, ei, np.arange(e) < dp.num_edges]
    if periodic:
        offs = np.zeros((e, 3), np.float32)
        offs[:dp.num_edges] = dp.cell_offsets
        args += [offs, np.asarray(dp.cell, np.float32)]
    return args + [np.array([charge], np.int32)]


def _edge_set(ei, offs):
    return {(int(c), int(n), *np.asarray(o).round().astype(int).tolist())
            for c, n, o in zip(ei[0], ei[1], offs)}


PBC_CELL = np.array([[6.0, 0.4, 0.0], [0.0, 6.5, 0.3], [0.2, 0.0, 7.0]])


@pytest.mark.parametrize("case", ["pbc_xyz", "pbc_xz", "reps_overflow", "free"])
def test_radius_graph_pbc_fixed_matches_jax_exactly(case):
    """tests/test_round2.py's three cases: every output equal to the JAX
    function's (edge index, mask, offsets, n_edges_found, needed_reps), and
    the real edges those of the host list."""
    rng = np.random.default_rng(0)
    if case.startswith("pbc"):
        cell, pbc = PBC_CELL, np.array([True, case == "pbc_xyz", True])
        pos, cutoff, cap = rng.uniform(0, 1, size=(8, 3)) @ cell, 4.5, 512
    elif case == "reps_overflow":
        cell, pbc = np.eye(3) * 2.0, np.ones(3, bool)
        pos, cutoff, cap = rng.uniform(0, 1, size=(4, 3)) @ cell, 4.5, 256
    else:
        cell, pbc = np.eye(3), np.zeros(3, bool)
        pos, cutoff, cap = rng.normal(size=(7, 3)) * 2.0, 3.0, 128
    pos32, cell32 = pos.astype(np.float32), cell.astype(np.float32)
    want = jax_pbc_fixed(pos32, cell32, pbc, cutoff, cap, max_reps=1)
    got = radius_graph_pbc_fixed(torch.as_tensor(pos32), torch.as_tensor(cell32),
                                 torch.as_tensor(pbc), cutoff, cap, max_reps=1)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ei, mask, offs, n_found, needed = (g.numpy() for g in got)
    if case == "reps_overflow":
        assert (needed == 3).all()
        return
    ei_h, offs_h = radius_graph_pbc_np(pos32, cell, pbc, cutoff)
    assert int(n_found) == ei_h.shape[1] and (needed <= 1).all()
    assert _edge_set(ei[:, mask], offs[mask]) == _edge_set(ei_h, offs_h)
    assert (np.diff(ei[0][mask]) >= 0).all()


def test_export_energy_roundtrip_and_unit_styles(ckpts, jax_exports, tmp_path):
    """tests/test_pipeline.py:233 and :295: the energy program (16 atoms,
    128 edges, no virial), written by ``xeq-torch export`` in the ``real``
    unit style, against the JAX ``metal`` one times the kcal/mol factor;
    the manifests equal key for key but the unit style."""
    rng = np.random.default_rng(1)
    dp = _molecule(rng, 9)
    assert cli.main(["export", "-c", ckpts["energy"], "-out", str(tmp_path / "tr"),
                     "--max-atoms", "16", "--max-edges", "128", "--unit-style", "real",
                     "--no-virial", "--device", "cpu"]) == 0
    t, tm = texport.load_exported(str(tmp_path / "tr"))
    j, jm = _jax_program(jax_exports, "energy")
    assert tm == dict(jm, unit_style="real") and tm["max_atoms"] == 16
    got, want = _call(j, t, _padded(dp, 16, 128))
    assert len(got) == len(want) == 2
    factor = tqc.unit_conversion("eV", "kcal/mol")
    _energy_forces([got[0] / factor, got[1] / factor], want)


def test_export_periodic_energy_virial_matches_jax_and_calculator(ckpts, jax_exports,
                                                                  tmp_path):
    """tests/test_round2.py:346: the periodic energy program with the virial
    (8 atoms, 1024 edges) against the JAX one, and against the port's
    Calculator (the JAX test's limits)."""
    rng = np.random.default_rng(2)
    cell = np.diag([6.0, 6.5, 7.0])
    pos = rng.uniform(0, 1, size=(6, 3)) @ cell
    z = rng.integers(1, 5, 6).astype(np.int32)
    ei, offs = radius_graph_pbc_np(pos, cell, np.ones(3, bool), 5.0)
    dp = Datapoint(z, pos, cell=cell, pbc=np.ones(3, bool), edge_index=ei, cell_offsets=offs)
    j, jm, t, tm = _both(jax_exports, "periodic", ckpts["energy"], tmp_path)
    assert tm["periodic"] is True and tm["compute_virial"] is True
    got, want = _call(j, t, _padded(dp, 8, 1024, periodic=True))
    _energy_forces(got, want)
    _held(got[2], want[2], 1e-4)
    ref = Calculator(ckpts["energy"], compute_virial=True, device="cpu").calculate(
        z, pos, cell=cell, pbc=np.ones(3, bool))
    np.testing.assert_allclose(float(got[0]), ref[keys.TOTAL_ENERGY], rtol=1e-4)
    np.testing.assert_allclose(got[1][:6], ref[keys.FORCES], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got[2], ref[keys.VIRIAL], rtol=1e-3, atol=1e-4)


def test_export_remat_checkpoint_matches_calculator(tmp_path):
    """A JAX checkpoint trained with ``remat: true`` (``save_edge_agg``)
    exports (the exporter traces the model without remat: it changes no
    output): its energy program with the virial on a free molecule
    against the port's Calculator serving the same checkpoint with remat,
    1e-5 for the energy, 1e-4 for forces and virial."""
    rng = np.random.default_rng(9)
    path = _write_ckpt(str(tmp_path / "remat.ckpt"), "xpainn",
                       dict(KW, remat=True, remat_policy="save_edge_agg"), _molecule(rng))
    texport.export_model(path, str(tmp_path / "out"), max_atoms=16, max_edges=128,
                         device="cpu")
    t, tm = texport.load_exported(str(tmp_path / "out"))
    assert tm["compute_virial"] is True
    dp = _molecule(rng, 9)
    got = [g.detach().numpy() for g in t(*[torch.as_tensor(a) for a in
                                           _padded(dp, 16, 128)])]
    calc = Calculator(path, compute_virial=True, device="cpu")
    ref = calc.calculate(dp.atomic_numbers, dp.pos)
    assert any(getattr(b, "remat_policy", None) for b in calc.module.blocks)
    assert abs(float(got[0]) - ref[keys.TOTAL_ENERGY]) <= 1e-5 * abs(ref[keys.TOTAL_ENERGY])
    _held(got[1][:dp.num_atoms], ref[keys.FORCES], 1e-4)
    _held(got[2], ref[keys.VIRIAL], 1e-4)


def test_export_gmx_matches_jax(ckpts, jax_exports, tmp_path):
    """tests/test_round2.py:303: the self-contained GROMACS program (8
    atoms, 1024 edges, max_reps 1) builds its list in the graph: the same
    n_edges_found and needed_reps as the JAX one, energy and forces in
    kJ/mol and nm; the manifest's cutoff is in nm."""
    rng = np.random.default_rng(3)
    cell = np.diag([6.0, 6.5, 7.0])
    pos = np.zeros((8, 3), np.float32)
    pos[:6] = rng.uniform(0, 1, size=(6, 3)) @ cell * 0.1
    z = np.zeros(8, np.int32)
    z[:6] = rng.integers(1, 5, 6)
    j, jm, t, tm = _both(jax_exports, "gmx", ckpts["energy"], tmp_path)
    assert tm["output_mode"] == "gmx" and np.isclose(tm[keys.CUTOFF_RADIUS], 0.5)
    got, want = _call(j, t, [pos, z, (cell * 0.1).astype(np.float32), np.ones(3, bool),
                             np.zeros(1, np.int32)])
    _energy_forces(got, want)
    assert int(got[2]) == int(want[2]) <= 1024
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].max() <= tm["max_reps"]


def test_export_dipole_charge_wiring_and_net_charge(ckpts, jax_exports, tmp_path):
    """tests/test_pipeline.py:356 and tests/test_round2.py:384: the dipole
    program's charges and dipole against the JAX one at total charges 0 and
    1 (the charges sum to each), and ``net_charge`` baked in through
    ``xeq-torch export --net-charge`` (the input ignored)."""
    rng = np.random.default_rng(4)
    dp = _molecule(rng, 5)
    j, jm, t, tm = _both(jax_exports, "dipole", ckpts["charges"], tmp_path)
    assert tm["output_mode"] == "dipole"
    for q in (0, 1):
        got, want = _call(j, t, _padded(dp, 8, 128, charge=q))
        _held(got[0], want[0], 1e-4)
        _held(got[1], want[1], 1e-4)
        assert got[1].shape == (3,)
        np.testing.assert_allclose(got[0][:5].sum(), q, atol=1e-4)
    assert cli.main(["export", "-c", ckpts["charges"], "-out", str(tmp_path / "tb"),
                     "--max-atoms", "8", "--max-edges", "128", "--mode", "dipole",
                     "--net-charge", "-1", "--device", "cpu"]) == 0
    tb, tbm = texport.load_exported(str(tmp_path / "tb"))
    jb, jbm = _jax_program(jax_exports, "dipole_net")
    assert tbm == jbm and tbm["net_charge"] == -1
    got, want = _call(jb, tb, _padded(dp, 8, 128, charge=7))
    _held(got[0], want[0], 1e-4)
    np.testing.assert_allclose(got[0][:5].sum(), -1.0, atol=1e-4)


def test_export_matrix_matches_jax(ckpts, jax_exports, tmp_path):
    """tests/test_xmatnet.py:316: XMatNet's node and edge blocks (8 atoms, 16
    edges) against the JAX program; the manifest carries the basis."""
    dp = ckpts["water"]
    j, jm, t, tm = _both(jax_exports, "matrix", ckpts["matrix"], tmp_path)
    assert tm["target_basis"] == MAT_BASIS and tm["elements"] == ["H", "O"]
    assert json.loads((tmp_path / "torch" / "manifest.json").read_text()) == tm
    args = _padded(dp, 8, 16)
    args[2][:, dp.num_edges:] = 7
    got, want = _call(j, t, args)
    _held(got[0][:3], want[0][:3], 1e-4)
    _held(got[1][:dp.num_edges], want[1][:dp.num_edges], 1e-4)
