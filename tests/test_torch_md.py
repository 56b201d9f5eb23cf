"""The port's MD path on the CPU against the JAX package: the host
neighbour lists and spatial layouts (exact), ghost rows through the model, the
default (gfn2-xtb) embedding, every integrator of ENSEMBLE_FACTORY on an
analytic force field, NVE conservation through the port's Calculator,
and ``run_md`` end to end.

Tolerances: integer layouts and edge lists exactly; the whole model at f32
within 1e-4 of the largest magnitude (forces are gradients through
stacked blocks whose sums run in different orders in the two packages);
the integrators, numpy in both packages, to 1e-10; ``run_md``'s final
positions within 1e-4 A and its logged energies within 1e-5 relative.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint
from xequinet_tpu.data.fmt_conversion import read_xyz as jax_read_xyz
from xequinet_tpu.models.model import make_apply_forward
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops import radius_graph as jrg
from xequinet_tpu.ops import spatial_sort as jss
from xequinet_tpu.run import dynamics as jmd
from xequinet_tpu.utils.config import load_md_config as jax_load_md_config
from xequinet_torch.convert import load_flax_params
from xequinet_torch.data.fmt_conversion import write_xyz
from xequinet_torch.interface.calculator import Calculator
from xequinet_torch.models.model import resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.ops import native
from xequinet_torch.ops import radius_graph as trg
from xequinet_torch.ops import spatial_sort as tss
from xequinet_torch.run import dynamics as tmd
from xequinet_torch.run.inference import batch_to_device
from xequinet_torch.utils.config import load_md_config
from xequinet_torch.utils.qc import ATOM_MASS

from .test_pbc_mega import _crystal, _ghost_batch
from .test_torch_calculator import KW, write_ckpt
from ._torch_jax_native import module_fixture, private_jax_native


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_order(tmp_path_factory):
    """The JAX package's cell lists built into a private path, so that its
    edge order is the one the port reproduces whatever other workers do to
    the shared library (tests/_torch_jax_native.py)."""
    yield from module_fixture(tmp_path_factory)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """tests/test_round4.py's NVE model: one block, f32."""
    return write_ckpt(str(tmp_path_factory.mktemp("md") / "md.ckpt"),
                      dict(KW, action_blocks=1))


# ---------------------------------------------------------------------------
# host layouts and neighbour lists
# ---------------------------------------------------------------------------
def test_spatial_layouts_match_jax_exactly():
    """spatial_sort_free, index_reach, sort_axis_pbc and ghost_layout_pbc
    on tests/test_pbc_mega.py's crystal recipe: the same integer arrays."""
    rng = np.random.default_rng(0)
    z, pos, cell, pbc = _crystal(rng)
    ei, offs = jrg.radius_graph_pbc_np(pos, cell, pbc, 5.0)
    got = tss.ghost_layout_pbc(pos, cell, pbc, ei, offs)
    want = jss.ghost_layout_pbc(pos, cell, pbc, ei, offs)
    assert sorted(got) == sorted(want) and want["n_ghosts"] > 0
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    for p in (pbc, np.array([True, False, True])):
        assert tss.sort_axis_pbc(cell, p, pos) == jss.sort_axis_pbc(cell, p, pos)
    free = rng.normal(size=(80, 3)) * np.array([6.0, 1.0, 2.0])
    for a, b in zip(tss.spatial_sort_free(free), jss.spatial_sort_free(free)):
        np.testing.assert_array_equal(a, b)
    perm, rank = tss.spatial_sort_free(free)
    ef, _ = jrg.radius_graph_np(free, 5.0)
    assert tss.index_reach(rank[ef[0]], rank[ef[1]]) == jss.index_reach(rank[ef[0]],
                                                                        rank[ef[1]])
    assert tss.index_reach(np.zeros(0), np.zeros(0)) == 0


def _edge_set(ei, offs):
    return sorted(zip(ei[0].tolist(), ei[1].tolist(), np.asarray(offs).astype(int).tolist()))


def test_native_neighbor_lists_match_jax():
    """The port's C++ lists (free and periodic) give the JAX package's
    edges in the same order, and the edge set of the port's numpy path."""
    assert native.get_lib() is not None, "g++ should build csrc/neighborlist.cpp"
    assert native._so_path().parent.name == "_build"
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(120, 3)) * 4.0
    got = trg.radius_graph_np(pos, 4.0)
    np.testing.assert_array_equal(got[0], jrg.radius_graph_np(pos, 4.0)[0])
    plain = trg.radius_graph_np(pos, 4.0, use_native=False)
    assert _edge_set(*got) == _edge_set(*plain)
    for p in (np.array([True] * 3), np.array([True, False, True])):
        _, xpos, cell, _ = _crystal(rng, n=50)
        xpos = xpos + rng.normal(size=xpos.shape) * 3.0  # some outside the cell
        got = trg.radius_graph_pbc_np(xpos, cell, p, 5.0)
        want = jrg.radius_graph_pbc_np(xpos, cell, p, 5.0)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        plain = trg.radius_graph_pbc_np(xpos, cell, p, 5.0, use_native=False)
        assert _edge_set(*got) == _edge_set(*plain)


def test_private_jax_native_survives_a_lost_library(monkeypatch, tmp_path):
    """A process whose JAX loader gave up on its library (``_build_failed``,
    as after an error while another worker rebuilt it) searches with numpy,
    in another edge order than the port's cell lists; the private build of
    tests/_torch_jax_native.py gives the cell lists' order back."""
    from xequinet_tpu.ops import native as jn

    monkeypatch.setattr(jn, "_lib", None)
    monkeypatch.setattr(jn, "_build_failed", True)
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(120, 3)) * 4.0
    got = trg.radius_graph_np(pos, 4.0)
    assert jn.get_lib() is None
    lost = jrg.radius_graph_np(pos, 4.0)[0]
    assert lost.shape == got[0].shape and not np.array_equal(lost, got[0])
    with private_jax_native(tmp_path):
        np.testing.assert_array_equal(jrg.radius_graph_np(pos, 4.0)[0], got[0])
    assert jn._build_failed and jn._lib is None  # the loader's state is put back


@pytest.mark.parametrize("max_edges", [64, 600])
def test_radius_graph_fixed_matches_jax(max_edges):
    """Edges, mask and n_found of the device search, with padding nodes,
    below (overflow) and above the found count."""
    rng = np.random.default_rng(2)
    pos = (rng.normal(size=(24, 3)) * 1.5).astype(np.float32)
    mask = np.arange(24) < 20
    ei, em, nf = trg.radius_graph_fixed(torch.as_tensor(pos), 3.0, max_edges,
                                        torch.as_tensor(mask))
    jei, jem, jnf = jrg.radius_graph_fixed(jnp.asarray(pos), 3.0, max_edges, jnp.asarray(mask))
    np.testing.assert_array_equal(ei.numpy(), np.asarray(jei))
    np.testing.assert_array_equal(em.numpy(), np.asarray(jem))
    assert int(nf) == int(jnf) and ei.dtype == torch.int32


# ---------------------------------------------------------------------------
# the model: ghost rows and the default embedding
# ---------------------------------------------------------------------------
def _jax_params(kw, batch):
    m, _, _ = jax_resolve_model("xpainn", **kw)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(lambda d: m.init(jax.random.PRNGKey(0), compute_edge_data(d)))(b)["params"]


def _both(kw, batch, compute_virial):
    """(port, JAX) outputs on one parameter tree."""
    params = _jax_params(kw, batch)
    m, e, _ = jax_resolve_model("xpainn", **kw)
    fwd = jax.jit(lambda p, d: make_apply_forward(m, e)(p, d, True, compute_virial))
    want = fwd(params, {k: jnp.asarray(v) for k, v in batch.items()})
    module, extra, _ = resolve_model("xpainn", **kw)
    load_flax_params(module, jax.tree_util.tree_map(np.array, params))
    got = make_forward(module.requires_grad_(False), extra)(
        batch_to_device(batch, "cpu"), True, compute_virial)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale, (float(np.abs(got - want).max()),
                                                           scale)


def test_ghost_batch_matches_jax():
    """A periodic ghost batch (tests/test_pbc_mega.py's recipe, two message
    blocks, so the ghost refresh matters) through the port's XPaiNN:
    energy, forces (zero on ghost rows) and the strain-trick virial."""
    rng = np.random.default_rng(1)
    z, pos, cell, pbc = _crystal(rng)
    ei, offs = jrg.radius_graph_pbc_np(pos, cell, pbc, 5.0)
    plan = jss.ghost_layout_pbc(pos, cell, pbc, ei, offs)
    gb = _ghost_batch(z, pos, cell, plan)
    got, want = _both(KW, gb, compute_virial=True)
    _close(got[keys.TOTAL_ENERGY][:1], want[keys.TOTAL_ENERGY][:1], 1e-4)
    _close(got[keys.FORCES], want[keys.FORCES], 1e-4)
    _close(got[keys.VIRIAL][0], want[keys.VIRIAL][0], 1e-4)
    assert np.abs(got[keys.FORCES][np.nonzero(plan["is_ghost"])[0]]).max() == 0


def test_default_embedding_model_matches_jax():
    """XPaiNN with the JAX package's default embedding (gfn2-xtb on aux56,
    fixed table + Dense): energy and forces at f32."""
    rng = np.random.default_rng(3)
    dps = []
    for _ in range(3):
        n = int(rng.integers(5, 9))
        p = rng.normal(size=(n, 3)) * 1.5
        dps.append(Datapoint(rng.integers(1, 30, n).astype(np.int32), p,
                             edge_index=jrg.radius_graph_np(p, 5.0)[0]))
    kw = {k: v for k, v in KW.items() if k != "embed_basis"}
    got, want = _both(kw, collate(dps), compute_virial=False)
    _close(got[keys.TOTAL_ENERGY][:3], want[keys.TOTAL_ENERGY][:3], 1e-4)
    _close(got[keys.FORCES], want[keys.FORCES], 1e-4)


# ---------------------------------------------------------------------------
# integrators
# ---------------------------------------------------------------------------
class MorseFF:
    """Analytic Morse pairs (all pairs, numpy) with the ForceField surface
    the integrators read: __call__ -> (energy, forces), ``cell`` and
    ``last_virial``."""

    def __init__(self, cell):
        self.cell = None if cell is None else np.array(cell, dtype=float)
        self.last_virial = None

    def __call__(self, pos):
        d = pos[:, None, :] - pos[None, :, :]
        r = np.sqrt((d ** 2).sum(-1) + np.eye(len(pos)))
        ex = np.exp(-1.5 * (r - 1.6))
        e_pair = 0.4 * (1.0 - ex) ** 2
        np.fill_diagonal(e_pair, 0.0)
        de = 0.4 * 2.0 * (1.0 - ex) * 1.5 * ex
        np.fill_diagonal(de, 0.0)
        fpair = -(de / r)[:, :, None] * d
        f = fpair.sum(1)
        self.last_virial = 0.5 * np.einsum("ijk,ijl->kl", d, fpair)
        return 0.5 * float(e_pair.sum()), f


def _md_system():
    rng = np.random.default_rng(8)
    g = np.stack(np.meshgrid(*[np.arange(2)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = g * 1.7 + rng.normal(size=(8, 3)) * 0.05
    z = np.array([1, 6, 7, 8, 1, 6, 7, 8])
    masses = ATOM_MASS[z]
    vel = jmd.maxwell_boltzmann(masses, 300.0, np.random.default_rng(9))
    return pos, vel, masses, np.diag([6.0, 6.5, 7.0])


def _stage_kwargs(name):
    if name in ("velocityverlet", "nve"):
        return {}
    if name in ("fire", "optimize"):
        return {"fmax": 1e-6}
    kw = {"temperature": 250.0}
    if "npt" in name or name == "parrinellorahman":
        kw["pressure_gpa"] = 0.5
    return kw


@pytest.mark.parametrize("name", sorted(jmd.ENSEMBLE_FACTORY))
def test_integrator_matches_jax(name):
    """Five steps of each ENSEMBLE_FACTORY entry, the same rng in both
    packages: positions, velocities and the cell to 1e-10."""
    assert sorted(tmd.ENSEMBLE_FACTORY) == sorted(jmd.ENSEMBLE_FACTORY)
    pos, vel, masses, cell = _md_system()
    runs = []
    for mod in (tmd, jmd):
        ff = MorseFF(cell)
        integ = mod.ENSEMBLE_FACTORY[name](ff, 0.5, **_stage_kwargs(name))
        state = mod.MDState(pos.copy(), vel.copy(), masses)
        rng = np.random.default_rng(10)
        for _ in range(5):
            state = integ.step(state, rng)
        extra = [integ.conserved_energy(state, ff(state.pos)[0])] if hasattr(
            integ, "conserved_energy") else []
        runs.append((state.pos, state.vel, ff.cell, state.step, extra))
    (p1, v1, c1, s1, h1), (p2, v2, c2, s2, h2) = runs
    assert s1 == s2 == 5
    np.testing.assert_allclose(p1, p2, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(v1, v2, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(c1, c2, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(h1, h2, rtol=1e-10, atol=1e-10)


# ---------------------------------------------------------------------------
# through the port's Calculator
# ---------------------------------------------------------------------------
def test_nve_energy_conservation_calculator(ckpt):
    """tests/test_round4.py's recipe on the port: Velocity Verlet through
    the port's Calculator conserves Epot + Ekin within 2e-3 eV per atom
    over 200 steps of 0.25 fs."""
    rng = np.random.default_rng(0)
    z = rng.integers(1, 5, 6).astype(np.int32)
    pos = rng.normal(size=(6, 3)) * 1.8
    ff = tmd.ForceField(Calculator(ckpt, device="cpu"), z)
    masses = ATOM_MASS[z]
    state = tmd.MDState(pos.copy(), tmd.maxwell_boltzmann(masses, 50.0, rng), masses)
    integ = tmd.VelocityVerlet(ff, timestep_fs=0.25)
    e0 = ff(state.pos)[0] + state.kinetic_energy()
    devs = []
    for i in range(200):
        state = integ.step(state, rng)
        if (i + 1) % 20 == 0:
            devs.append(abs(ff(state.pos)[0] + state.kinetic_energy() - e0))
    assert max(devs) / len(z) < 2e-3, f"NVE drift {max(devs)} eV"


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def _energies(lines):
    out = []
    for line in lines:
        m = re.search(r"Epot=(\S+)eV Ekin=(\S+)eV", line)
        if m:
            out.append((float(m.group(1)), float(m.group(2))))
    return np.array(out)


def test_run_md_matches_jax(ckpt, tmp_path):
    """run_md from an xyz file: an NVE and a Langevin stage of 20 steps
    each, the same config and seed in both packages (the port on the CPU):
    final positions within 1e-4 A, logged energies within 1e-5 relative,
    and the port's extxyz trajectory read back by the JAX reader."""
    rng = np.random.default_rng(12)
    z = np.array([6, 1, 1, 8, 1, 7, 1, 1], dtype=np.int32)
    xyz = tmp_path / "mol.xyz"
    write_xyz(str(xyz), [tmd.Datapoint(z, rng.normal(size=(8, 3)) * 1.4, charge=0)])
    stages = [{"name": "nve", "timestep": 0.5, "steps": 20, "log_interval": 10},
              {"name": "langevin", "timestep": 0.5, "steps": 20, "log_interval": 10,
               "temperature": 300.0, "friction_fs": 0.02}]
    common = dict(input_file=str(xyz), model_file=ckpt, ensembles=stages, seed=3,
                  init_temperature=200.0, compile_cache=False)
    traj = str(tmp_path / "traj.xyz")
    t_log, j_log = _Log(), _Log()
    got = tmd.run_md(load_md_config(overrides=dict(common, device="cpu", xyz_traj=traj)),
                     logger=t_log)
    want = jmd.run_md(jax_load_md_config(overrides=common), logger=j_log)
    assert got.step == want.step == 40
    np.testing.assert_allclose(got.pos, want.pos, rtol=0, atol=1e-4)
    e_got, e_want = _energies(t_log.lines), _energies(j_log.lines)
    assert e_got.shape == e_want.shape == (4, 2)
    np.testing.assert_allclose(e_got, e_want, rtol=1e-5, atol=1e-6)
    frames = jax_read_xyz(traj)
    assert len(frames) == 4
    np.testing.assert_allclose(frames[-1].pos, got.pos, rtol=0, atol=1e-7)
