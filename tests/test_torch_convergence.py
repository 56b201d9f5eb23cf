"""The port's study tools against the JAX package's on the CPU:
``xequinet_torch/tools/make_synthetic_dataset.py`` (the PES, the generator
end to end, ``sample_structure``) against ``tools/make_synthetic_dataset.py``,
and ``xequinet_torch/tools/convergence_study.py`` (``make_config`` field by
field, ``parse_curve`` on a log of the port's trainer, the NVE drift fit)
against ``tools/convergence_study.py``.  ``nve_drift`` itself (1,400 force
calls before its NVE run) is driven by ``chip_smoke.py`` phase 13 (e), on
the card and in the CPU rehearsal; here its fit is held to the JAX tool's
formula on a fixed energy series, and its protocol to the study's bar on
the synthetic PES.  Also the port's own: the launch ledger and the f32
switches across a resume, the forces against differences of the energy,
the energy under both compute dtypes, and ``device_put_sharded_batch``
defaulting to the card.  The bf16 accuracy study
(``xequinet_torch/tools/bf16_accuracy_study.py``): ``make_config`` field
by field against ``tools/bf16_accuracy_study.py``'s for every dtype mode,
and its ``main`` end to end on the CPU.

Sizes: clusters of 8-32 atoms; the generator at 6 structures of 8-10
atoms, seed 7; ``run_train`` two epochs of a 16-wide one-block XPaiNN on
the plain route.  Tolerances, f32: PES energies 1e-5 relative, forces
1e-5 of max |F|; after the generator's 8 descent steps positions 1e-4 A,
energies 1e-5 relative, forces 1e-4 of max |F|.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from tools import bf16_accuracy_study as jbf16
from tools import convergence_study as jstudy
from tools import make_synthetic_dataset as jgen
from xequinet_tpu.utils import qc as jqc
from xequinet_torch.data.store import XDBDataset
from xequinet_torch.parallel import data_parallel as tdp
from xequinet_torch.tools import bf16_accuracy_study as tbf16
from xequinet_torch.tools import convergence_study as tstudy
from xequinet_torch.tools.compare_datasets import compare
from xequinet_torch.tools import make_synthetic_dataset as tgen
from xequinet_torch.training import trainer as ttrainer
from xequinet_torch.utils import qc as tqc

FLAGSHIP_FLAGS = dict(node_dim=128, irreps="128x0e+64x1o+32x2e", num_basis=20,
                      compute_dtype="bfloat16", f32_finetune_epochs=40, mega=True,
                      batch_size=64, run_name="converge")


@pytest.fixture(autouse=True, scope="module")
def _default_units():
    """run_train sets the process-wide default units; put back what the
    other test files of this process expect once this file is done."""
    saved = [(m, dict(m.DEFAULT_UNITS_MAP)) for m in (jqc, tqc)]
    yield
    for m, units in saved:
        m.DEFAULT_UNITS_MAP.clear()
        m.DEFAULT_UNITS_MAP.update(units)


@pytest.fixture(autouse=True)
def _elements(monkeypatch):
    """``use_extended_elements`` rebinds module globals in both tools:
    each test starts from, and leaves, the H, C, N, O set."""
    torch.set_num_threads(2)
    for mod in (jgen, tgen):
        monkeypatch.setattr(mod, "ELEMENTS", mod.ELEMENTS.copy())
        monkeypatch.setattr(mod, "ELEMENT_P", list(mod.ELEMENT_P))


def _use(elements):
    if elements == "extended":
        jgen.use_extended_elements()
        tgen.use_extended_elements()


@pytest.mark.parametrize("elements,n_atoms,seed", [("hcno", 8, 0), ("extended", 20, 1),
                                                   ("extended", 32, 2)])
def test_pes_against_jax(elements, n_atoms, seed):
    _use(elements)
    z, pos = tgen.random_cluster(np.random.default_rng(seed), n_atoms)
    e_j, g_j = (np.asarray(t) for t in jgen.make_energy_fn()(pos, z))
    e_t, g_t = tgen.make_energy_fn("cpu")(pos, z)
    assert g_t.dtype == torch.float32 and e_t.dtype == torch.float32
    e_t, g_t = float(e_t), g_t.numpy()
    assert abs(e_t - float(e_j)) <= 1e-5 * abs(float(e_j))
    assert np.abs(g_t - g_j).max() <= 1e-5 * np.abs(g_j).max()
    # the same draws: the port's cluster is the JAX tool's
    zj, pj = jgen.random_cluster(np.random.default_rng(seed), n_atoms)
    assert np.array_equal(z, zj) and np.array_equal(pos, pj)


def test_pes_refuses_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgen.make_energy_fn()


def test_generator_against_jax(tmp_path, monkeypatch):
    flags = ["--n", "6", "--atoms", "8", "10", "--elements", "extended", "--seed", "7"]
    monkeypatch.setattr(sys, "argv", ["make_synthetic_dataset.py", str(tmp_path / "jax")]
                        + flags)
    jgen.main()
    tgen.main([str(tmp_path / "port")] + flags + ["--device", "cpu"])
    a = XDBDataset(tmp_path / "port")
    for name in ("split.json", "info.json"):
        assert json.loads((tmp_path / "port" / name).read_text()) == \
            json.loads((tmp_path / "jax" / name).read_text()), name
    gap = compare(tmp_path / "port", tmp_path / "jax")
    assert gap["records"] == [6, 6] and gap["split_equal"]
    assert gap["atomic_numbers_differ"] == 0
    assert gap["max_pos_gap_A"] <= 1e-4
    assert gap["max_energy_gap_rel"] <= 1e-5
    assert gap["max_force_gap_rel_max_F"] <= 1e-4
    efn = tgen.make_energy_fn("cpu")
    for i in range(6):
        x = a.reader[i]
        # the labels are the port's PES at the stored positions: F = -dE/dR
        e, g = efn(x.pos, x.atomic_numbers)
        assert float(e) == pytest.approx(x.energy, rel=1e-6)
        np.testing.assert_array_equal(x.forces, -g.numpy().astype(x.forces.dtype))


def test_sample_structure_against_jax():
    got = tgen.sample_structure(np.random.default_rng(7), n_atoms=24, relax_steps=40,
                                device="cpu")
    want = jgen.sample_structure(np.random.default_rng(7), n_atoms=24, relax_steps=40)
    assert np.array_equal(got.atomic_numbers, want.atomic_numbers)
    assert np.abs(got.pos - want.pos).max() <= 1e-4


def test_make_config_field_by_field():
    got = tstudy.make_config("db", "out", 400, **FLAGSHIP_FLAGS)
    want = jstudy.make_config("db", "out", 400, **FLAGSHIP_FLAGS)
    n = 0
    for sec in ("model", "trainer", "data"):
        g, w = getattr(got, sec), getattr(want, sec)
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), f"{sec}.{f.name}"
            n += 1
    assert n == 48  # every field of the JAX schema
    # the port's own field: the card unless asked otherwise
    assert got.trainer.device is None
    assert tstudy.make_config("db", "out", 1, device="cpu").trainer.device == "cpu"


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16", "bf16msg", "bf16_f32ft"])
def test_bf16_study_make_config_field_by_field(mode, tiny):
    got = tbf16.make_config("db", "out", mode, 60, tiny=tiny)
    want = jbf16.make_config("db", "out", mode, 60, tiny=tiny)
    n = 0
    for sec in ("model", "trainer", "data"):
        g, w = getattr(got, sec), getattr(want, sec)
        for f in dataclasses.fields(w):
            assert getattr(g, f.name) == getattr(w, f.name), f"{sec}.{f.name}"
            n += 1
    assert n == 48  # every field of the JAX schema
    assert got.trainer.device is None
    assert "use_pallas_scatter" not in got.model.model_kwargs  # the plain route


def test_bf16_study_main_on_the_cpu(tmp_path):
    """``main`` with ``--tiny --epochs 1 --modes f32,bf16 --device cpu`` on
    48 generated structures: results.json under the JAX tool's keys (a
    mode's test metrics per property), finite, with the run's extras."""
    tgen.main([str(tmp_path / "db"), "--n", "48", "--atoms", "8", "10", "--device", "cpu"])
    out = tmp_path / "study"
    tbf16.main([str(tmp_path / "db"), "--tiny", "--epochs", "1", "--modes", "f32,bf16",
                "--device", "cpu", "--out", str(out)])
    res = json.loads((out / "results.json").read_text())
    for mode in ("f32", "bf16"):
        assert sorted(res[mode]) == ["energy", "energy/atom", "forces"]
        for m in res[mode].values():
            assert sorted(m) == ["count", "mae", "rmse"] and m["count"] > 0
            assert np.isfinite([m["mae"], m["rmse"]]).all()
        assert (out / mode / f"bf16study-{mode}_last.ckpt").exists()
        assert res["wall_s"][mode] > 0 and res["step_ms_mean"][mode] > 0
        assert not any(res["kernel_launches"][mode].values())
    assert res["card"] == "CPU" and res["device"] == "cpu" and res["epochs"] == 1
    assert res["dataset"]["n_structures"] == 48
    assert res["f32"] != res["bf16"]
    with pytest.raises(SystemExit):  # an unknown mode, before any training
        tbf16.main([str(tmp_path / "db"), "--modes", "f32,fp8", "--device", "cpu",
                    "--out", str(tmp_path / "bad")])
    assert not (tmp_path / "bad").exists()


def test_parse_curve_reads_the_trainers_validation(tmp_path, monkeypatch):
    from xequinet_torch.run.train import run_train

    tgen.use_extended_elements()
    tgen.main([str(tmp_path / "db"), "--n", "20", "--atoms", "8", "10", "--device", "cpu"])
    cfg = tstudy.make_config(str(tmp_path / "db"), str(tmp_path / "out"), 2, node_dim=16,
                             num_basis=8, batch_size=4, device="cpu")
    cfg.model.model_kwargs["action_blocks"] = 1
    seen = []
    validate = ttrainer.Trainer.validate

    def kept(self):
        res = validate(self)
        seen.append(res["forces"]["mae"])
        return res

    monkeypatch.setattr(ttrainer.Trainer, "validate", kept)
    ledger = tstudy.TrainLaunches()
    with ledger.active():
        run_train(cfg)
    log = tmp_path / "out" / cfg.trainer.log_file
    curve = tstudy.parse_curve(log)
    assert [e for e, _ in curve] == [0, 1]
    np.testing.assert_allclose([m for _, m in curve], seen, rtol=0, atol=5e-7)
    epochs = tstudy.parse_epochs(log)
    assert all(e["seconds"] >= 0 and e["step_ms"] > 0 for e in epochs)
    # the JAX parser reads the forces row that precedes a done line: on
    # this log (no step record inside an epoch) it labels each epoch's
    # validation MAE with the next epoch's number, i.e. counts epochs from 1
    assert jstudy.parse_curve(log) == [(1, curve[0][1])]
    # the launch ledger saw both epochs, their steps and validation batches
    # (no launch on the CPU)
    counted = ledger.summary()
    assert counted["steps_counted"] == {"float32": 8} and counted["valid_batches_counted"] == 2
    assert counted["launches_per_train_step"]["float32"] == {k: 0.0 for k in
                                                            tstudy.MESSAGE_KERNELS}
    assert counted["f32_switch"] == [] and all(e["f32_switch"] is None for e in epochs)


def test_ledger_and_f32_switches_across_a_resume(tmp_path):
    """A bf16 run whose last epoch switches to f32 in mid-run, then a
    resumed process that rebuilds f32 at its start: the log marks each
    switch, and the resumed ledger adds its counts to the first
    process's summary (as ``convergence.json`` carries it over)."""
    from xequinet_torch.run.train import run_train

    tgen.use_extended_elements()
    tgen.main([str(tmp_path / "db"), "--n", "20", "--atoms", "8", "10", "--device", "cpu"])
    saved = []

    def run(epochs, f32_epochs, previous=None, resume=False):
        cfg = tstudy.make_config(str(tmp_path / "db"), str(tmp_path / "out"), epochs,
                                 node_dim=16, num_basis=8, batch_size=4, device="cpu",
                                 compute_dtype="bfloat16", f32_finetune_epochs=f32_epochs)
        cfg.model.model_kwargs["action_blocks"] = 1
        if resume:
            cfg.trainer.ckpt_file = str(tmp_path / "out" / "converge_last.ckpt")
            cfg.trainer.resume = True
        ledger = tstudy.TrainLaunches(previous,
                                      on_epoch=lambda: saved.append(ledger.summary()))
        with ledger.active():
            run_train(cfg)
        return cfg, ledger.summary()

    _cfg, first = run(2, 1)
    assert saved[-1] == first and len(saved) == 2  # written after each epoch
    assert first["epochs_counted"] == {"bfloat16": 1, "float32": 1}
    assert [sw["mid_run"] for sw in first["f32_switch"]] == [True]
    cfg, both = run(3, 2, previous=json.loads(json.dumps(first)), resume=True)
    assert both["epochs_counted"] == {"bfloat16": 1, "float32": 2}
    assert both["steps_counted"] == {"bfloat16": 4, "float32": 8}
    assert both["valid_batches_counted"] == 3
    assert [(sw["epoch"], sw["mid_run"]) for sw in both["f32_switch"]] == [(1, True),
                                                                            (2, False)]
    assert all(sw["optimizer_holds_module_params"] and sw["ema_rebuilt"]
               for sw in both["f32_switch"])
    epochs = tstudy.parse_epochs(tmp_path / "out" / cfg.trainer.log_file)
    assert [(e["epoch"], e["f32_switch"]) for e in epochs] == [(0, None), (1, "mid-run"),
                                                               (2, "at resume")]
    # the last checkpoint's forces are -dE/dR of its energy, and its EMA
    # weights read the validation split under both compute dtypes
    ckpt = str(tmp_path / "out" / "converge_last.ckpt")
    fd = tstudy.force_check(ckpt, np.random.default_rng(7), device="cpu")
    assert fd["route"] == "plain" and fd["force_norm"] > 0 and fd["energy_spread"] >= 0
    assert max(fd["rel_err_along_F"], fd["rel_err_random"]) <= 1e-2
    gap = tstudy.dtype_gap(cfg, ckpt, ("bfloat16", "float32"), device="cpu")
    assert gap["n_structures"] == 2 and gap["split"] == "valid"
    assert gap["energy_diff_mean"] == pytest.approx(
        gap["bfloat16"]["energy_mean_error"] - gap["float32"]["energy_mean_error"], abs=1e-9)
    assert np.isfinite([gap[d]["energy_mae"] for d in ("bfloat16", "float32")]).all()


def test_nve_protocol_on_the_pes():
    """The JAX tool's protocol (FIRE, Langevin, 400 NVE steps of 0.5 fs)
    on the synthetic PES of the seed-7 cluster conserves energy within the
    study's 1 meV/atom/ps."""
    tgen.use_extended_elements()
    got = tstudy.pes_nve_drift(400, 0.5, 300.0, np.random.default_rng(7), device="cpu")
    # a force call per step, the integrator's first, and an energy every 20
    assert got["n_atoms"] == 24 and got["steps"] == 400 and got["calls"] == 400 + 1 + 20
    assert got["drift_meV_per_atom_per_ps"] <= 1.0
    assert got["max_abs_dev_meV_per_atom"] <= 1.0


def test_nve_drift_fit_against_jax_formula():
    rng = np.random.default_rng(3)
    t_ps = np.arange(1, 201) * 20 * 0.5 / 1000.0
    etot = -40.0 + 2.4e-3 * t_ps + 1e-4 * np.sin(40 * t_ps) + 1e-6 * rng.normal(size=200)
    e0 = -40.0
    got = tstudy.drift_fit(t_ps, etot, e0, 24)
    # tools/convergence_study.py:156-168, the same series
    slope = np.polyfit(t_ps, etot - e0, 1)[0]
    want = {"t_ps": float(t_ps[-1]),
            "max_abs_dev_meV_per_atom": float(np.abs(etot - e0).max() / 24 * 1e3),
            "drift_meV_per_atom_per_ps": float(abs(slope) / 24 * 1e3)}
    assert got == want
    assert got["drift_meV_per_atom_per_ps"] == pytest.approx(0.1, rel=1e-2)


def test_device_put_sharded_batch_defaults_to_the_card(monkeypatch):
    stacked = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdp.device_put_sharded_batch(stacked)
    got = tdp.device_put_sharded_batch(stacked, None, "cpu")
    np.testing.assert_array_equal(got["x"].numpy(), stacked["x"][0])
