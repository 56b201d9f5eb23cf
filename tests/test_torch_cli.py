"""The port's user-facing drivers against the JAX package on the CPU: the
block-YAML reader (against PyYAML), ``run_test``, ``run_infer`` and the
xTB delta correction (against the JAX drivers), and ``cli.main`` (every
subcommand parsed; ``test``, ``infer`` and ``opt`` driven end to end with
``--device cpu``; each refusing without a card).  ``train`` through the
command line, with preemption and resume, is in tests/test_torch_lmdb.py.

Models: XPaiNN, node_dim 16, 16x0e+8x1o+4x2e, one block, f32, seeded
weights; molecules of 4-7 atoms with random labels.  Tolerances: MAE and
RMSE 1e-5 relative; energies 1e-5 relative, forces 1e-5 of the largest
force; the delta correction's arithmetic 1e-12.
"""

import copy
import glob
import os
import pickle
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental.pallas import tpu as pltpu

from xequinet_tpu.data.batching import collate as jax_collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.run import inference as jinf
from xequinet_tpu.run import test as jtest
from xequinet_tpu.training.trainer import save_checkpoint as jax_save
from xequinet_tpu.utils import config as jconfig
from xequinet_tpu.utils import qc as jqc
from xequinet_torch import cli
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.fmt_conversion import write_xyz
from xequinet_torch.data.store import create_dataset
from xequinet_torch.run import inference as tinf
from xequinet_torch.run import test as ttest
from xequinet_torch.utils import qc as tqc
from xequinet_torch.utils.config import (MDConfig, XequiConfig, YAMLError, config_to_dict,
                                         load_config, load_md_config, yaml_loads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
          cutoff=5.0, action_blocks=1, output_modes=["energy"])
# pad_nodes 8 keeps the window (24 rows) inside the node capacity: the JAX
# collate applies a layout that re-pads the node axis before it adds the
# force labels (ROADMAP section 3), so its run_test cannot take one
MEGA = dict(KW, use_pallas_scatter="mega", pallas_layout=[8, 8, 8, 16])


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
def _env(monkeypatch):
    torch.set_num_threads(2)
    monkeypatch.setenv("XEQ_COMPILE_CACHE", "0")  # no on-disk XLA cache
    monkeypatch.setattr(jtest, "init_params", _template_init)
    monkeypatch.setattr(jinf, "init_params", _template_init)


def _template_init(module, sample_batch, seed=0):
    """The JAX package's ``init_params`` as shapes only (``jax.eval_shape``):
    where a checkpoint's weights then replace every leaf, the template
    needs no values, and eager flax init costs seconds per batch shape on
    the CPU."""
    data = {k: jnp.asarray(v) for k, v in sample_batch.items()}
    return jax.eval_shape(lambda d: module.init(jax.random.PRNGKey(seed),
                                                compute_edge_data(d))["params"], data)


def _molecules(seed, n, lo=4, hi=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(lo, hi + 1))
        out.append(Datapoint(rng.integers(1, 5, k).astype(np.int32),
                             rng.normal(size=(k, 3)) * 1.3, energy=float(rng.normal()),
                             forces=rng.normal(size=(k, 3))))
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A dataset (12 train, 2 valid, 8 test molecules), JAX checkpoints of
    one parameter tree on the plain and the mega route, and an extxyz."""
    tmp = tmp_path_factory.mktemp("cli")
    dps = _molecules(0, 22)
    create_dataset(str(tmp / "db"), dps, units={},
                   split={"train": list(range(12)), "valid": [12, 13],
                          "test": list(range(14, 22))})
    module, _, _ = jax_resolve_model("xpainn", **KW)
    d = dps[0]
    batch = {k: jnp.asarray(v) for k, v in jax_collate([JDatapoint(
        d.atomic_numbers, d.pos, edge_index=_edges(d.pos))]).items()}
    params = jax.jit(lambda b: module.init(jax.random.PRNGKey(0),
                                           compute_edge_data(b))["params"])(batch)
    ckpts = {}
    for route, kw in (("plain", KW), ("mega", MEGA)):
        ckpts[route] = str(tmp / f"{route}.ckpt")
        jax_save(ckpts[route], params, {"model_name": "xpainn", "model_kwargs": kw,
                                        "default_units": {}})
    write_xyz(str(tmp / "in.xyz"), _molecules(1, 6))
    return {"dir": tmp, "db": str(tmp / "db"), "ckpt": ckpts, "xyz": str(tmp / "in.xyz")}


def _edges(pos):
    from xequinet_tpu.ops.radius_graph import radius_graph_np

    return radius_graph_np(pos, 5.0)[0]


def _config(db, **trainer):
    return {"data": {"db_path": db, "targets": ["energy", "forces"], "batch_size": 4,
                     "valid_batch_size": 4},
            "trainer": dict(trainer)}


# ---------------------------------------------------------------------------
# the YAML reader
# ---------------------------------------------------------------------------
DOC_BLOCKS = [blk for path in sorted(glob.glob(os.path.join(REPO, "docs", "*.md")))
              for blk in re.findall(r"```yaml\n(.*?)```", open(path).read(), re.S)]


@pytest.mark.parametrize("i", range(len(DOC_BLOCKS)))
def test_yaml_reader_matches_pyyaml_on_docs(i):
    assert DOC_BLOCKS  # docs/config.md has four
    assert yaml_loads(DOC_BLOCKS[i]) == yaml.safe_load(DOC_BLOCKS[i])


def test_yaml_reader_matches_pyyaml_on_dumped_configs(tmp_path, monkeypatch):
    cfg = XequiConfig()
    cfg.model.model_kwargs = dict(MEGA, max_lr=5e-4, nested={"a": [1, 2.5, None, "x y"]})
    cfg.model.default_units = {"energy": "eV", "pos": "Angstrom"}
    cfg.trainer.losses_weight = {"energy": 1.0, "forces": 100.0}
    cfg.trainer.early_stoppings = {"energy": {"patience": 50, "threshold": 1e-4}}
    cfg.trainer.run_name = "it's: #1"
    cfg.data.targets = ["energy", "forces"]
    md = MDConfig(ensembles=[{"name": "langevin", "timestep": 0.5, "temperature": 300.0},
                             {"name": "nve", "steps": 10}], columns=["Epot", "T"],
                  pallas="mega", skin=0.5, device="cpu")
    for obj in (cfg, md):
        for flow in (False, None):
            text = yaml.safe_dump(config_to_dict(obj), default_flow_style=flow, width=10**6)
            assert yaml_loads(text) == yaml.safe_load(text)
    monkeypatch.setitem(sys.modules, "yaml", None)  # the port reads YAML without PyYAML
    (tmp_path / "c.yaml").write_text(yaml_dump := text)
    assert config_to_dict(load_md_config(str(tmp_path / "c.yaml"))) == config_to_dict(md)
    (tmp_path / "t.yaml").write_text(
        "trainer:\n  max_epochs: 2  # two\n  device: cpu\nmodel:\n  model_kwargs: "
        "{node_dim: 16,\n    output_modes: [energy]}\n")
    got = load_config(str(tmp_path / "t.yaml"))
    assert (got.trainer.max_epochs, got.trainer.device) == (2, "cpu")
    assert got.model.model_kwargs == {"node_dim": 16, "output_modes": ["energy"]}
    assert yaml_dump


@pytest.mark.parametrize("text", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: b\n  c", "a: 1e-4",
    "a: 1:20", "a: 2001-12-14", "a: 'open", "a: [1, 2", "a: 1\na: 2", "a:\n\t- 1",
    "a: b: c", "a: -", "---\na: 1\n---\nb: 2", "? a\n: 1", "a:\n  - 1\n b: 2",
    "a: yes", "a: 017", "a: 0x1f", "a: 1_000", "a: .inf", 'a: "\\x41"'])
def test_yaml_reader_refuses_with_the_line(text):
    with pytest.raises(YAMLError, match=r"line \d+"):
        yaml_loads(text)


# ---------------------------------------------------------------------------
# run_test, run_infer, the delta correction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("route", ["plain", "mega"])
def test_run_test_matches_jax(route, work, tmp_path):
    over = _config(work["db"])
    got = ttest.run_test(load_config(overrides=over), work["ckpt"][route], verbose=True,
                         results_file=str(tmp_path / "r.pkl"), device="cpu")
    with pltpu.force_tpu_interpret_mode():  # the JAX mega kernels on the CPU
        want = jtest.run_test(jconfig.load_config(overrides=over), work["ckpt"][route])
    assert set(got) == set(want) == {"energy", "energy/atom", "forces"}
    for prop, r in want.items():
        assert got[prop]["count"] == r["count"]
        np.testing.assert_allclose(got[prop]["mae"], r["mae"], rtol=1e-5)
        np.testing.assert_allclose(got[prop]["rmse"], r["rmse"], rtol=1e-5)
    with open(tmp_path / "r.pkl", "rb") as f:
        dump = pickle.load(f)
    assert len(dump) == 8 and set(dump[0]) == {"energy", "target_energy", "forces"}


def test_run_infer_matches_jax(work, tmp_path):
    out_t, out_j = str(tmp_path / "t.pkl"), str(tmp_path / "j.pkl")
    got = tinf.run_infer(work["ckpt"]["mega"], work["xyz"], output_file=out_t,
                         compute_forces=True, batch_size=4, device="cpu")
    # one chunk on the JAX side (one compile), two on the port's
    want = jinf.run_infer(work["ckpt"]["plain"], work["xyz"], output_file=out_j,
                          compute_forces=True, batch_size=6)
    with open(out_t, "rb") as f:
        pick_t = pickle.load(f)
    with open(out_j, "rb") as f:
        pick_j = pickle.load(f)
    assert len(pick_t) == len(pick_j) == len(got) == 6
    for g, w, pt, pj in zip(got, want, pick_t, pick_j):
        assert set(g) == set(w) == set(pt) == set(pj) >= {"energy", "forces"}
        np.testing.assert_allclose(g["energy"], w["energy"], rtol=1e-5)
        np.testing.assert_allclose(g["forces"], w["forces"], rtol=0,
                                   atol=1e-5 * np.abs(w["forces"]).max())
        np.testing.assert_array_equal(pt["forces"], g["forces"])


class _FakeXTB:
    """A stand-in for tblite's calculator: fixed results per structure."""

    def __init__(self, dp):
        n = len(dp.atomic_numbers)
        rng = np.random.default_rng(n)
        self.res = {"energy": -5.0 + 0.1 * n, "gradient": rng.normal(size=(n, 3)),
                    "virial": rng.normal(size=(3, 3)), "charges": rng.normal(size=n),
                    "dipole": rng.normal(size=3)}

    def singlepoint(self):
        return self.res


def test_delta_correction_matches_jax(monkeypatch):
    from xequinet_tpu.data import fmt_conversion as jfmt
    from xequinet_torch.data import fmt_conversion as tfmt

    dp = _molecules(2, 1)[0]
    rng = np.random.default_rng(5)
    n = dp.num_atoms
    result = {"energy": np.float32(-3.2), "forces": rng.normal(size=(n, 3)),
              "virial": rng.normal(size=(3, 3)), "atomic_charges": rng.normal(size=n),
              "dipole": rng.normal(size=3)}
    with pytest.raises(ImportError):  # no tblite here
        tinf._delta_correction(dp, copy.deepcopy(result), "gfn2-xtb")
    monkeypatch.setattr(tfmt, "datapoint_to_xtb", lambda d, method: _FakeXTB(d))
    monkeypatch.setattr(jfmt, "datapoint_to_xtb", lambda d, method: _FakeXTB(d))
    units = {"energy": "kcal/mol", "pos": "Bohr"}
    for qc in (tqc, jqc):  # set_default_units only adds keys: swap the map back after
        monkeypatch.setattr(qc, "DEFAULT_UNITS_MAP", dict(qc.DEFAULT_UNITS_MAP))
        qc.set_default_units(units)
    got = tinf._delta_correction(dp, copy.deepcopy(result), "gfn2-xtb")
    want = jinf._delta_correction(dp, copy.deepcopy(result), "gfn2-xtb")
    assert set(got) == set(want) == set(result)
    for k in result:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, err_msg=k)
        assert not np.allclose(got[k], result[k]), k


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
PARSED = {
    "train": (["train", "-C", "c.yaml", "-c", "w.ckpt", "-r"],
              dict(config="c.yaml", ckpt="w.ckpt", resume=True)),
    "test": (["test", "-c", "m.ckpt", "--no-ema", "-v", "--results", "r.pkl", "--device", "cpu"],
             dict(config="config.yaml", ckpt="m.ckpt", no_ema=True, verbose=True,
                  results="r.pkl", device="cpu")),
    "infer": (["infer", "-c", "m.ckpt", "-in", "a.xyz", "-out", "o.pkl", "--forces", "--stress",
               "-d", "gfn2-xtb", "-b", "8", "--format", "extxyz"],
              dict(ckpt="m.ckpt", input="a.xyz", output="o.pkl", forces=True, stress=True,
                   delta="gfn2-xtb", batch_size=8, format="extxyz", device=None)),
    "opt": (["opt", "-c", "m.ckpt", "-in", "a.xyz", "--max-steps", "5", "--fmax", "0.1",
             "--freq", "--temp", "300", "-con", "c.txt", "--engine", "native", "--shermo",
             "--save-hessian", "--no-opt", "--opt-params", "p.json", "--device", "cpu"],
            dict(max_steps=5, fmax=0.1, freq=True, temp=300.0, constraints="c.txt",
                 engine="native", shermo=True, save_hessian=True, no_opt=True,
                 opt_params="p.json", device="cpu", delta=None, output=None)),
    "md": (["md", "-C", "md.yaml"], dict(config="md.yaml")),
    "export": (["export", "-c", "m.ckpt", "-out", "m.pt", "--mode", "gmx", "--periodic",
                "--net-charge", "-1", "--max-reps", "2"],
               dict(mode="gmx", periodic=True, net_charge=-1, max_reps=2, max_atoms=256,
                    max_edges=8192, unit_style="metal", no_virial=False, device=None)),
}


@pytest.mark.parametrize("task", sorted(PARSED))
def test_cli_parses_every_subcommand(task):
    argv, want = PARSED[task]
    args = cli.build_parser().parse_args(argv)
    assert args.task == task
    for k, v in want.items():
        assert getattr(args, k) == v, k
    if task == "export":  # dispatched to the export, which runs on the card by default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)


def test_cli_device_cpu_drives_test_infer_opt(work, tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"data:\n  db_path: {work['db']}\n  targets: [energy, forces]\n"
                   f"  valid_batch_size: 4\n")
    results = tmp_path / "r.pkl"
    assert cli.main(["test", "-C", str(cfg), "-c", work["ckpt"]["mega"], "--results",
                     str(results), "--device", "cpu"]) == 0
    assert len(pickle.load(open(results, "rb"))) == 8
    out = tmp_path / "o.pkl"
    assert cli.main(["infer", "-c", work["ckpt"]["mega"], "-in", work["xyz"], "-out", str(out),
                     "--forces", "--device", "cpu"]) == 0
    assert len(pickle.load(open(out, "rb"))) == 6
    xyz = tmp_path / "m.xyz"
    write_xyz(str(xyz), _molecules(3, 1))
    (tmp_path / "cons.txt").write_text("$freeze\nxyz 1\n")
    assert cli.main(["opt", "-c", work["ckpt"]["plain"], "-in", str(xyz), "-out",
                     str(tmp_path / "opt.xyz"), "--max-steps", "3", "--freq", "--shermo",
                     "-con", str(tmp_path / "cons.txt"), "--device", "cpu"]) == 0
    assert (tmp_path / "m_freq.shm").exists() and (tmp_path / "opt.xyz").exists()


def test_cli_refuses_without_a_card(work, tmp_path):
    """Without a card and without the CPU asked for, every subcommand that
    runs a model raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"data:\n  db_path: {work['db']}\n  targets: [energy]\n")
    md = tmp_path / "md.yaml"
    md.write_text(f"input_file: {work['xyz']}\nmodel_file: {work['ckpt']['plain']}\n"
                  f"logfile: {tmp_path / 'md.log'}\n")
    for argv in (["train", "-C", str(cfg)], ["test", "-C", str(cfg), "-c", work["ckpt"]["plain"]],
                 ["infer", "-c", work["ckpt"]["plain"], "-in", work["xyz"]],
                 ["opt", "-c", work["ckpt"]["plain"], "-in", work["xyz"]],
                 ["md", "-C", str(md)]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(argv)
