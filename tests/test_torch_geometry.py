"""The port's geometry drivers against the JAX package on the CPU:
``Calculator.hessian`` (free and periodic), ``run/geometry.py``
(analytic against numerical Hessians, ``run_opt`` with ``$freeze``,
frequencies, thermochemistry, the Shermo file, the saved Hessian and
``--no-opt``), the ASE adapter ``XequiCalculator`` on a stand-in for ASE,
and the i-PI driver against a fake server.

One JAX checkpoint (XPaiNN, node_dim 16, 16x0e+8x1o+4x2e, one block, f32)
serves both packages; the JAX drivers are the oracle.

Tolerances:
* the Hessian: max |H_port - H_jax| <= 1e-4 max |H_jax| plus twice the
  port's own change of its Hessian when the positions move by one f32 ulp
  (x (1 + 1e-7)), measured in the test: the limit the force loss's
  gradient needed (chip_smoke.py, GRAD_TOL and GRAD_ULP_FACTOR), since a
  Hessian of a random-weight model is a gradient of a gradient too;
* analytic against numerical Hessians: the JAX package's own test
  (tests/test_round2.py), atol 5e-3 and rtol 1e-2 at eps 1e-3;
* ``run_opt``: final energies 1e-4 relative, frequencies 1e-3 of the
  largest and thermochemistry 1e-3 relative, frozen atoms bit for bit;
* energies, forces and the virial through the ASE adapter and the i-PI
  wire: 1e-5 relative (f32 of the same model in another package's
  summation order).
"""

import re
import socket
import struct
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate as jax_collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.interface import calculator as jcalc_mod
from xequinet_tpu.interface import ipi_driver as jipi
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.run import geometry as jgeo
from xequinet_tpu.training.trainer import save_checkpoint as jax_save
from xequinet_tpu.utils import qc as jqc
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.fmt_conversion import (datapoint_from_pyscf, datapoint_to_ase,
                                                datapoint_to_pyscf, read_xyz,
                                                write_xyz)
from xequinet_torch.interface import calculator as tcalc_mod
from xequinet_torch.interface import ipi_driver as tipi
from xequinet_torch.run import dynamics as tdyn
from xequinet_torch.run import geometry as tgeo
from xequinet_torch.utils import qc as tqc

KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
          cutoff=5.0, action_blocks=1, output_modes=["energy"])
GRAD_TOL, GRAD_ULP_FACTOR = 1e-4, 2.0
CELL = np.diag([6.0, 6.5, 7.0])


@pytest.fixture(autouse=True, scope="module")
def _default_units():
    """``run_train``, ``run_test`` and ``run_infer`` of both packages set the
    process-wide default units from a checkpoint; put back what the other
    test files of this process expect once this file is done."""
    saved = [(m, dict(m.DEFAULT_UNITS_MAP)) for m in (jqc, tqc)]
    yield
    for m, units in saved:
        m.DEFAULT_UNITS_MAP.clear()
        m.DEFAULT_UNITS_MAP.update(units)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A JAX trainer checkpoint of the small XPaiNN at seeded weights."""
    module, _, _ = jax_resolve_model("xpainn", **KW)
    rng = np.random.default_rng(0)
    z = rng.integers(1, 5, 6).astype(np.int32)
    pos = rng.normal(size=(6, 3)) * 1.5
    ei, _ = radius_graph_np(pos, 5.0)
    batch = {k: jnp.asarray(v) for k, v in jax_collate([JDatapoint(z, pos, edge_index=ei)]).items()}
    params = jax.jit(lambda d: module.init(jax.random.PRNGKey(0),
                                           compute_edge_data(d))["params"])(batch)
    path = str(tmp_path_factory.mktemp("geo") / "small.ckpt")
    jax_save(path, params, {"model_name": "xpainn", "model_kwargs": KW, "default_units": {}})
    return path


@pytest.fixture(scope="module")
def jax_calc(ckpt):
    """One JAX Calculator (virial on, no on-disk XLA cache) for every JAX
    driver of this file, so that each shape compiles once."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jcalc_mod, "init_params", _template_init)
    yield jcalc_mod.Calculator(ckpt, compute_virial=True, compile_cache=False)
    mp.undo()


def _template_init(module, sample_batch, seed=0):
    """The JAX package's ``init_params`` as shapes only (``jax.eval_shape``):
    where a checkpoint's weights then replace every leaf, the template
    needs no values, and eager flax init costs seconds per batch shape on
    the CPU."""
    data = {k: jnp.asarray(v) for k, v in sample_batch.items()}
    return jax.eval_shape(lambda d: module.init(jax.random.PRNGKey(seed),
                                                compute_edge_data(d))["params"], data)


@pytest.fixture(scope="module")
def port_calc(ckpt):
    return tcalc_mod.Calculator(ckpt, compute_virial=True, device="cpu")


def _molecule(seed=3, n=6):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, n).astype(np.int32), rng.normal(size=(n, 3)) * 1.3


def _crystal(seed=4, n=5):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 5, n).astype(np.int32), rng.uniform(0, 1, (n, 3)) @ CELL


# ---------------------------------------------------------------------------
# the Hessian
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("periodic", [False, True], ids=["free", "periodic"])
def test_hessian_matches_jax(periodic, jax_calc, port_calc):
    z, pos = _crystal() if periodic else _molecule()
    kw = dict(cell=CELL, pbc=np.array([True] * 3)) if periodic else {}
    h_jax = jax_calc.hessian(z, pos, **kw)
    h = port_calc.hessian(z, pos, **kw)
    # the port's own change under a one-ulp move of the positions
    moved = np.abs(port_calc.hessian(z, pos * (1 + 1e-7), **kw) - h).max()
    scale = np.abs(h_jax).max()
    limit = GRAD_TOL * scale + GRAD_ULP_FACTOR * moved
    assert h.shape == (3 * len(z), 3 * len(z))
    np.testing.assert_array_equal(h, h.T)
    err = np.abs(h - h_jax).max()
    assert err <= limit, (err, limit, scale)
    # rows in several passes give the same matrix
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcalc_mod, "HESSIAN_ROWS", 5)
        np.testing.assert_allclose(port_calc.hessian(z, pos, **kw), h, rtol=0,
                                   atol=1e-6 * scale)


def test_analytic_hessian_matches_numerical(port_calc):
    """The JAX package's own check (tests/test_round2.py) on the port."""
    z, pos = _molecule(seed=5, n=5)
    ff = tdyn.ForceField(port_calc, z)
    h_a = tgeo.analytic_hessian(ff, pos)
    h_n = tgeo.numerical_hessian(ff, pos, eps=1e-3)
    assert h_a.shape == (15, 15)
    np.testing.assert_allclose(h_a, h_a.T, atol=1e-8)
    np.testing.assert_allclose(h_a, h_n, atol=5e-3, rtol=1e-2)
    # the translational sum rule: each row sums to zero over the atoms
    rows = h_a.reshape(15, 5, 3).sum(axis=1)
    assert np.abs(rows).max() <= 1e-3 * np.abs(h_a).max()


def test_analytic_hessian_rejects_delta(port_calc):
    ff = tdyn.ForceField(port_calc, np.array([1, 1]))
    ff.extra_calcs.append(lambda p: (0.0, np.zeros_like(p)))
    with pytest.raises(ValueError, match="numerical_hessian"):
        tgeo.analytic_hessian(ff, np.zeros((2, 3)))


def test_parse_constraints_and_rrho_match_jax(tmp_path):
    f = tmp_path / "cons.txt"
    f.write_text("# freeze three atoms\n$freeze\nxyz 1-2, 5\n")
    assert tgeo.parse_constraints(str(f), 6).tolist() == jgeo.parse_constraints(str(f), 6).tolist()
    bad = tmp_path / "bad.txt"
    bad.write_text("$freeze\ndistance 1 2\n")
    with pytest.raises(NotImplementedError):
        tgeo.parse_constraints(str(bad), 6)
    rng = np.random.default_rng(9)
    a = rng.normal(size=(12, 12))
    h, masses = a @ a.T, np.array([1.008, 12.011, 15.999, 14.007])
    f_t, modes_t = tgeo.harmonic_analysis(h, masses)
    f_j, _ = jgeo.harmonic_analysis(h, masses)
    np.testing.assert_allclose(f_t, f_j, rtol=1e-12)
    assert tgeo.thermochemistry(f_t, -3.0, masses) == jgeo.thermochemistry(f_j, -3.0, masses)


def test_format_adapters_match_jax():
    """ASE and PySCF are on neither machine: the adapters that build their
    objects raise ImportError, as the JAX package's do; the one that reads
    a PySCF Mole takes a duck-typed one."""
    from xequinet_tpu.data import fmt_conversion as jfmt

    assert not tgeo.has_geometric_engine()
    dp = Datapoint(np.array([1]), np.zeros((1, 3)))
    for fn in (datapoint_to_ase, datapoint_to_pyscf):
        with pytest.raises(ImportError):
            fn(dp)
    mole = types.SimpleNamespace(elements=["O", "h", "H"], charge=-1, spin=1,
                                 atom_coords=lambda: np.eye(3))
    got, want = datapoint_from_pyscf(mole), jfmt.datapoint_from_pyscf(mole)
    assert got.atomic_numbers.tolist() == want.atomic_numbers.tolist() == [8, 1, 1]
    np.testing.assert_allclose(got.pos, want.pos, rtol=1e-12)
    assert (got.charge, got.spin) == (want.charge, want.spin) == (-1, 1)


# ---------------------------------------------------------------------------
# run_opt
# ---------------------------------------------------------------------------
def _opt_inputs(tmp_path, tag):
    d = tmp_path / tag
    d.mkdir()
    z, pos = _molecule(seed=7, n=6)
    write_xyz(d / "m.xyz", [Datapoint(z, pos)])
    (d / "cons.txt").write_text("$freeze\natoms 1,3\n")
    return d, z, pos


@pytest.mark.parametrize("no_opt", [False, True], ids=["opt", "no-opt"])
def test_run_opt_matches_jax(no_opt, ckpt, jax_calc, port_calc, tmp_path, monkeypatch):
    # each package's run_opt on its shared Calculator (one compile per shape)
    monkeypatch.setattr(jgeo, "Calculator", lambda *a, **k: jax_calc)
    monkeypatch.setattr(tgeo, "Calculator", lambda *a, **k: port_calc)
    out = {}
    for tag, mod in (("jax", jgeo), ("port", tgeo)):
        d, z, pos = _opt_inputs(tmp_path, tag)
        out[tag] = mod.run_opt(ckpt, str(d / "m.xyz"), output_file=str(d / "opt.xyz"),
                               max_steps=8, fmax=0.05, freq=True,
                               constraints=str(d / "cons.txt"), shermo=True,
                               save_hessian=True, no_opt=no_opt)[0]
    got, want = out["port"], out["jax"]
    # frozen atoms 1 and 3 (1-based) exactly where the input file put them
    start = read_xyz(str(tmp_path / "port" / "m.xyz"))[0].pos
    np.testing.assert_array_equal(got["positions"][[0, 2]], start[[0, 2]])
    assert np.abs(got["positions"] - start).max() > 0 or no_opt
    if no_opt:
        np.testing.assert_array_equal(got["positions"], start)
    assert got["converged"] == want["converged"]
    np.testing.assert_allclose(got["energy"], want["energy"], rtol=1e-4)
    f_scale = np.abs(want["frequencies_cm1"]).max()
    np.testing.assert_allclose(got["frequencies_cm1"], want["frequencies_cm1"], rtol=0,
                               atol=1e-3 * f_scale)
    assert set(got["thermo"]) == set(want["thermo"])
    for k, v in want["thermo"].items():
        np.testing.assert_allclose(got["thermo"][k], v, rtol=1e-3, atol=1e-3 * abs(
            want["thermo"]["ZPE (eV)"]), err_msg=k)
    shm_t = (tmp_path / "port" / "m_freq.shm").read_text()
    shm_j = (tmp_path / "jax" / "m_freq.shm").read_text()
    # the same lines, the numbers aside
    shape = lambda text: [re.sub(r"-?\d+(?:\.\d+)?", "#", ln).split() for ln in text.splitlines()]
    assert shape(shm_t) == shape(shm_j)
    for sec in ("*E", "*wavenum", "*atoms", "*elevel"):
        assert sec in shm_t
    h_t = np.loadtxt(tmp_path / "port" / "m_h.txt")
    assert h_t.shape == (18, 18)
    assert (tmp_path / "port" / "opt.xyz").read_text().count("\n") == 8


# ---------------------------------------------------------------------------
# the ASE adapter and the i-PI driver
# ---------------------------------------------------------------------------
class _Atoms:
    """Duck-typed ASE Atoms: what XequiCalculator._compute reads."""

    def __init__(self, z, pos, cell=None, info=None):
        self.numbers, self.positions = z, pos
        self.cell = cell if cell is not None else np.zeros((3, 3))
        self.pbc = np.array([cell is not None] * 3)
        self.info = info or {}

    def get_atomic_numbers(self):
        return self.numbers

    def get_positions(self):
        return self.positions

    def get_volume(self):
        return abs(np.linalg.det(self.cell))


@pytest.fixture
def fake_ase(monkeypatch):
    """ase.calculators.calculator.Calculator stand-in (ase is not
    installed here)."""
    base = type("Calculator", (), {"calculate": lambda self, *a, **k: None})
    for name in ("ase", "ase.calculators", "ase.calculators.calculator"):
        mod = types.ModuleType(name)
        mod.Calculator = base
        monkeypatch.setitem(sys.modules, name, mod)


def test_xequi_calculator_matches_jax(ckpt, fake_ase, jax_calc, monkeypatch):
    monkeypatch.setattr(jcalc_mod, "Calculator", lambda *a, **k: jax_calc)
    port = tcalc_mod.XequiCalculator(ckpt, device="cpu")
    jax_ = jcalc_mod.XequiCalculator(ckpt)
    assert port.as_ase().implemented_properties == jax_.implemented_properties
    z, pos = _crystal()
    for atoms in (_Atoms(z, pos, CELL, {"charge": 0}), _Atoms(*_molecule())):
        got, want = port._compute(atoms), jax_._compute(atoms)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5 * np.abs(v).max(),
                                       err_msg=k)
    assert "stress" in port._compute(_Atoms(z, pos, CELL))


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk
        buf += chunk
    return buf


def _fake_ipi_server(frames, result):
    """A listening socket and the thread that plays i-PI for ``frames``
    (cells and positions in Bohr): STATUS, POSDATA, STATUS, GETFORCE per
    frame, then EXIT; each reply's raw bytes go to ``result``."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    server.bind(("localhost", 0))
    server.listen(1)

    def run():
        conn, _ = server.accept()
        hdr = lambda m: conn.sendall(m.ljust(12).encode())
        for cell, pos in frames:
            hdr("STATUS")
            assert _recv_exact(conn, 12).decode().strip() == "READY"
            hdr("POSDATA")
            conn.sendall(cell.astype("<f8").tobytes())
            conn.sendall(np.linalg.pinv(cell).astype("<f8").tobytes())
            conn.sendall(struct.pack("<i", len(pos)))
            conn.sendall(pos.astype("<f8").tobytes())
            hdr("STATUS")
            assert _recv_exact(conn, 12).decode().strip() == "HAVEDATA"
            hdr("GETFORCE")
            assert _recv_exact(conn, 12).decode().strip() == "FORCEREADY"
            n_bytes = 8 + 4 + 24 * len(pos) + 72 + 4
            result.append(_recv_exact(conn, n_bytes))
        hdr("EXIT")
        conn.close()
        server.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return server.getsockname()[1], t


def _decode_reply(raw, n):
    e = struct.unpack("<d", raw[:8])[0]
    assert struct.unpack("<i", raw[8:12])[0] == n
    f = np.frombuffer(raw[12 : 12 + 24 * n], dtype="<f8").reshape(n, 3)
    v = np.frombuffer(raw[12 + 24 * n : 84 + 24 * n], dtype="<f8").reshape(3, 3)
    assert struct.unpack("<i", raw[-4:])[0] == 0
    return e, f, v


def test_ipi_driver_matches_jax(ckpt, jax_calc, monkeypatch):
    """Three rounds (two free, one periodic) against a fake server; the
    port's replies against the JAX driver's on the same frames."""
    from xequinet_tpu.utils.qc import units

    monkeypatch.setattr(jipi, "Calculator", lambda *a, **k: jax_calc)
    bohr = units["Angstrom"]
    z, pos = _crystal()
    frames = [(np.zeros((3, 3)), pos * bohr), (np.zeros((3, 3)), (pos + 0.05) * bohr),
              (CELL * bohr, pos * bohr)]
    replies = {}
    for tag, make in (("jax", lambda p: jipi.IPIDriver(ckpt, z, port=p)),
                      ("port", lambda p: tipi.IPIDriver(ckpt, z, port=p, device="cpu"))):
        replies[tag] = []
        port, thread = _fake_ipi_server(frames, replies[tag])
        assert make(port).run() == len(frames)
        thread.join(timeout=30)
        assert not thread.is_alive()
    for got, want in zip(replies["port"], replies["jax"]):
        (eg, fg, vg), (ew, fw, vw) = _decode_reply(got, len(z)), _decode_reply(want, len(z))
        np.testing.assert_allclose(eg, ew, rtol=1e-5)
        np.testing.assert_allclose(fg, fw, rtol=0, atol=1e-5 * np.abs(fw).max())
        np.testing.assert_allclose(vg, vw, rtol=0, atol=1e-5 * max(np.abs(vw).max(), 1e-12))
    # and against the port's Calculator directly, in the wire's units
    drv = tipi.IPIDriver(ckpt, z, device="cpu")
    e, f, _ = drv._compute(np.zeros((3, 3)), pos * bohr)
    ref = drv.calc.calculate(z, pos)
    np.testing.assert_allclose(e, ref[keys.TOTAL_ENERGY] * drv._e_conv, rtol=1e-12)
    np.testing.assert_allclose(f, ref[keys.FORCES] * drv._e_conv * drv._l_conv, rtol=1e-12)
