"""The port's embedding-table tools against the JAX package on the CPU:
``utils/qc.py``'s ``convert_torch_table`` and ``gen_int2c1e`` (under one
stand-in ``pyscf`` that both packages import), the port's own copies of
the xTB and auxiliary basis files, an XPaiNN on a converted table, and
the package data that ``pyproject.toml`` ships for the port.

Tolerances: the tables bit for bit, the basis files byte for byte; the
model at f32 within 1e-4 of the largest magnitude (tests/test_torch_md.py's
limit for the default embedding).
"""

import hashlib
import re
import sys
import tomllib
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint
from xequinet_tpu.ops import radius_graph as jrg
from xequinet_tpu.utils import qc as jqc
from xequinet_torch.ops import cuda_build, native
from xequinet_torch.utils import qc as tqc

from .test_torch_calculator import KW
from .test_torch_md import _both, _close

REPO = Path(__file__).resolve().parents[1]
EMBED, AUX = "seeded8", "auxtest"


@pytest.fixture(autouse=True)
def _own_tables(tmp_path, monkeypatch):
    """Each package writes and reads its tables under its own temporary
    ``PRE_FOLDER``; the cached tables are dropped on both sides after."""
    torch.set_num_threads(2)
    monkeypatch.setattr(jqc, "PRE_FOLDER", tmp_path / "jax")
    monkeypatch.setattr(tqc, "PRE_FOLDER", tmp_path / "port")
    yield
    jqc.get_embedding_table.cache_clear()
    tqc.get_embedding_table.cache_clear()


def _torch_dict(path, seed, width=8):
    rng = np.random.default_rng(seed)
    torch.save({e: torch.tensor(rng.normal(size=width).astype(np.float32))
                for e in tqc.ELEMENTS_LIST[1:]}, path)
    return path


def _table(folder, embed=EMBED, aux=AUX):
    return np.load(folder / f"{embed}_{aux}.npz")["table"]


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_convert_torch_table_matches_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="convert_torch_table"):
        tqc.get_embedding_table(EMBED, AUX)
    pt = _torch_dict(tmp_path / "emb.pt", seed=0)
    got = tqc.convert_torch_table(str(pt), EMBED, AUX)
    want = jqc.convert_torch_table(str(pt), EMBED, AUX)
    assert got == tmp_path / "port" / f"{EMBED}_{AUX}.npz" and want.parent == tmp_path / "jax"
    table = _table(tmp_path / "port")
    _same_bits(table, _table(tmp_path / "jax"))
    assert table.shape == (len(tqc.ELEMENTS_LIST), 8) and not table[0].any()
    _same_bits(np.asarray(tqc.get_embedding_table(EMBED, AUX), np.float32),
               table.astype(np.float32))
    # a new table under the same name is read, not the cached one
    tqc.convert_torch_table(str(_torch_dict(tmp_path / "emb2.pt", seed=1)), EMBED, AUX)
    np.testing.assert_array_equal(np.asarray(tqc.get_embedding_table(EMBED, AUX)),
                                  _table(tmp_path / "port").astype(np.float32))


class _StandInMole:
    """What ``gen_int2c1e`` reads of ``pyscf.gto.M(atom=, basis=, spin=)``:
    the shells of each atom from its basis file (one s shell where the
    file has none), ``nao``, ``ao_loc_nr()`` and an ``int1e_ovlp`` of seeded
    symmetric noise whose seed hashes the atom string, the spin and the
    basis files' contents."""

    def __init__(self, atom, basis, spin=0):
        h = hashlib.sha256(f"{atom}|{spin}".encode())
        self.ls = []
        for label in (a.split()[0] for a in atom.split(";")):
            text = Path(basis[label]).read_text() if Path(basis[label]).exists() \
                else basis[label]
            h.update(text.encode())
            ls = ["SPDFG".index(m) for m in re.findall(rf"^{label}\s+([SPDFG])", text, re.M)]
            self.ls += ls or [0]
        self.nao = sum(2 * l + 1 for l in self.ls)
        self.seed = int.from_bytes(h.digest()[:8], "little")

    def ao_loc_nr(self):
        return np.concatenate([[0], np.cumsum([2 * l + 1 for l in self.ls])])

    def intor(self, name):
        assert name == "int1e_ovlp"
        a = np.random.default_rng(self.seed).normal(size=(self.nao, self.nao))
        return (a + a.T) / 2


@pytest.fixture
def pyscf(monkeypatch):
    """A stand-in ``pyscf`` package in ``sys.modules``; ``calls`` keeps
    every ``gto.M`` call's basis dict."""
    calls = []

    def M(atom, basis, spin=0):
        calls.append(basis)
        return _StandInMole(atom, basis, spin)

    gto = types.ModuleType("pyscf.gto")
    gto.M = M
    mod = types.ModuleType("pyscf")
    mod.gto, mod.calls = gto, calls
    monkeypatch.setitem(sys.modules, "pyscf", mod)
    monkeypatch.setitem(sys.modules, "pyscf.gto", gto)
    return mod


@pytest.mark.parametrize("embed,aux", [("gfn2-xtb", "aux56"), ("gfn1-xtb", "aux28")])
def test_gen_int2c1e_matches_jax(embed, aux, tmp_path, pyscf):
    got = tqc.gen_int2c1e(embed, aux)
    n_port = len(pyscf.calls)
    want = jqc.gen_int2c1e(embed, aux)
    assert got.parent == tmp_path / "port" and want.parent == tmp_path / "jax"
    table = _table(tmp_path / "port", embed, aux)
    _same_bits(table, _table(tmp_path / "jax", embed, aux))
    n_aux = int(re.search(r"aux(\d+)", aux).group(1))
    assert table.shape == (len(tqc.ELEMENTS_LIST), n_aux) and not table[0].any()
    assert np.abs(table[1:]).min() > 0
    # the port read its own copies of the basis files, the JAX package its
    port_files = {Path(f).parent for b in pyscf.calls[:n_port] for f in b.values()}
    jax_files = {Path(f).parent for b in pyscf.calls[n_port:] for f in b.values()}
    assert port_files == {tqc.BASIS_FOLDER} and jax_files == {jqc.BASIS_FOLDER}
    # get_embedding_table generates a missing table through it, and reads it
    tqc.PRE_FOLDER.joinpath(f"{embed}_{aux}.npz").unlink()
    np.testing.assert_array_equal(np.asarray(tqc.get_embedding_table(embed, aux)),
                                  table.astype(np.float32))


def test_basis_files_are_the_jax_packages():
    names = sorted(p.name for p in tqc.BASIS_FOLDER.iterdir())
    assert names == sorted(p.name for p in jqc.BASIS_FOLDER.iterdir())
    assert {"gfn1-xtb.dat", "gfn2-xtb.dat", "aux28.dat", "aux56.dat"} <= set(names)
    for name in names:
        assert (tqc.BASIS_FOLDER / name).read_bytes() == \
            (jqc.BASIS_FOLDER / name).read_bytes(), name


def test_converted_table_model_matches_jax(tmp_path):
    """XPaiNN with a converted table as its embedding, the JAX parameters
    carried across by convert.py: energy and forces at f32."""
    pt = _torch_dict(tmp_path / "emb.pt", seed=2)
    tqc.convert_torch_table(str(pt), EMBED, AUX)
    jqc.convert_torch_table(str(pt), EMBED, AUX)
    rng = np.random.default_rng(4)
    dps = []
    for _ in range(3):
        n = int(rng.integers(5, 9))
        p = rng.normal(size=(n, 3)) * 1.5
        dps.append(Datapoint(rng.integers(1, 87, n).astype(np.int32), p,
                             edge_index=jrg.radius_graph_np(p, 5.0)[0]))
    kw = dict(KW, action_blocks=1, embed_basis=EMBED, aux_basis=AUX)
    got, want = _both(kw, collate(dps), compute_virial=False)
    _close(got[keys.TOTAL_ENERGY][:3], want[keys.TOTAL_ENERGY][:3], 1e-4)
    _close(got[keys.FORCES], want[keys.FORCES], 1e-4)


def test_package_data_ships_what_the_port_reads():
    """Each ``xequinet_torch`` glob of pyproject.toml's package data
    matches files, and together they cover every file the port reads from
    its package: the kernel and neighbour-list sources, the shipped
    embedding tables and the basis files."""
    data = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = {pkg: pats for pkg, pats in data["tool"]["setuptools"]["package-data"].items()
             if pkg.split(".")[0] == "xequinet_torch"}
    shipped = set()
    for pkg, pats in globs.items():
        root = REPO / pkg.replace(".", "/")
        for pat in pats:
            hits = {p.resolve() for p in root.glob(pat) if p.is_file()}
            assert hits, f"{pkg}: {pat} matches nothing"
            shipped |= hits
    needed = {(cuda_build.CSRC_DIR / f).resolve() for src, hdrs, _, _ in
              cuda_build._KERNELS.values() for f in (src, *hdrs)}
    needed.add(Path(native._SRC).resolve())
    needed |= {p.resolve() for p in (tqc.THIS_FOLDER / "pre_computed").iterdir()}
    needed |= {p.resolve() for p in tqc.BASIS_FOLDER.iterdir()}
    assert {"gfn2-xtb_aux28.npz", "gfn2-xtb_aux56.npz"} <= {p.name for p in needed}
    assert needed <= shipped, sorted(str(p) for p in needed - shipped)
