"""Converged-accuracy and NVE energy-conservation study of flagship XPaiNN.

Port of the JAX package's ``tools/convergence_study.py``.  Trains XPaiNN
on the synthetic many-body PES (exact force labels,
``xequinet_torch/tools/make_synthetic_dataset.py``) through ``run_train``
for a fixed epoch budget, records the validation force-MAE curve,
evaluates the held-out test split with ``run_test``, then runs NVE from
the trained checkpoint with ``run/dynamics.py``'s integrators and measures
the total-energy drift.

Usage (on the card; ``--device cpu`` for the CPU):
    python -m xequinet_torch.tools.make_synthetic_dataset synth6k --n 6000 \\
        --atoms 8 32 --elements extended
    python -m xequinet_torch.tools.convergence_study synth6k --epochs 400 \\
        --node-dim 128 --irreps 128x0e+64x1o+32x2e --num-basis 20 \\
        --compute-dtype bfloat16 --f32-finetune-epochs 40 --mega --out study

Writes <out>/convergence.json (the MAE curve, the test metrics, the
energy of the validation split under the bf16 and the f32 compute dtype
on the same EMA weights, the NVE drift in meV/atom/ps of the trained
model and of the synthetic PES itself, the device and the card's power
limit, the wall time, the train step's times, the message-kernel launches
per train step and per validation batch, and the f32 switches) and
<out>/convergence_flagship.json (the same run under the keys of the JAX
package's ``tools/convergence_flagship.json``).  The launch counts are
written after every epoch.  Exits non-zero if the model's drift exceeds
``--drift-bound`` (default 1 meV/atom/ps).  ``--resume`` continues a run
from <out>/<run-name>_last.ckpt (a preemption checkpoint: SIGTERM stops
the trainer at a step boundary) and adds its counts to those of
<out>/convergence.json.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .. import keys
from ..utils.config import XequiConfig

MESSAGE_KERNELS = ("message_fwd", "message_bwd", "message_bwd2")


def make_config(db_path: str, save_dir: str, epochs: int,
                node_dim: int = 64, irreps: str = None,
                num_basis: int = 16, compute_dtype: str = "float32",
                f32_finetune_epochs: int = 0, mega: bool = False,
                batch_size: int = 64,
                run_name: str = "converge", device=None, seed: int = 42) -> XequiConfig:
    """The JAX tool's config on the port's schema; ``device`` is the
    port's ``trainer.device`` (None: the card); ``seed`` the trainer's
    (the JAX tool's 42 by default)."""
    cfg = XequiConfig()
    cfg.model.model_name = "xpainn"
    cfg.model.model_kwargs = dict(
        node_dim=node_dim,
        node_irreps=irreps or (
            f"{node_dim}x0e+{node_dim // 2}x1o+{node_dim // 4}x2e"
        ),
        embed_basis="one-hot",
        num_basis=num_basis,
        action_blocks=3,
        output_modes=["energy"],
        remat=False,
        compute_dtype=compute_dtype,
        update_compute_dtype=compute_dtype,
    )
    if mega:
        cfg.model.model_kwargs["use_pallas_scatter"] = "mega"
        cfg.model.model_kwargs["pallas_layout"] = (512, 512, 32, 64)
    cfg.data.db_path = db_path
    cfg.data.cutoff = 5.0
    cfg.data.targets = [keys.TOTAL_ENERGY, keys.FORCES]
    cfg.data.batch_size = batch_size
    cfg.data.valid_batch_size = 2 * batch_size
    cfg.data.node_shift = True
    cfg.trainer.run_name = run_name
    cfg.trainer.save_dir = save_dir
    cfg.trainer.max_epochs = epochs
    cfg.trainer.warmup_epochs = 5
    cfg.trainer.max_lr = 1e-3
    cfg.trainer.lossfn = "l2"
    cfg.trainer.losses_weight = {keys.TOTAL_ENERGY: 1.0, keys.FORCES: 25.0}
    cfg.trainer.ema_decay = 0.999
    cfg.trainer.seed = seed
    cfg.trainer.log_epochs = 1
    cfg.trainer.best_k = 3
    cfg.trainer.f32_finetune_epochs = f32_finetune_epochs
    cfg.trainer.device = device
    return cfg


# a log record's first line starts with its timestamp
_RECORD = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")
_DONE = re.compile(r"== epoch\s+(\d+)\s+done in\s+([\d.]+)s(?: step ([\d.]+)ms)?")


def parse_epochs(logfile: Path):
    """One dict per logged epoch of the trainer log: ``epoch`` (the
    trainer's, from 0), ``seconds`` (the epoch's wall), ``step_ms`` (the
    trainer's mean step time, host clock), ``valid`` ({property: MAE}
    from the validation table that the '== epoch N done' record carries)
    and ``f32_switch``: None, or where the trainer logged the f32 switch
    before this epoch, "mid-run" or "at resume" (the rebuild of a process
    that resumed from a checkpoint)."""
    epochs = []
    current = switch = None
    resumed = False
    for line in Path(logfile).read_text().splitlines():
        m = _DONE.search(line)
        if m:
            current = {"epoch": int(m.group(1)), "seconds": float(m.group(2)),
                       "step_ms": float(m.group(3)) if m.group(3) else None, "valid": {},
                       "f32_switch": switch}
            epochs.append(current)
            switch, resumed = None, False
            continue
        if _RECORD.match(line):  # the next record: the table has ended
            current = None
            if "] resumed from " in line:
                resumed = True
            elif "] f32 fine-tune: " in line:
                switch = "at resume" if resumed else "mid-run"
            continue
        parts = line.split()
        if current is not None and len(parts) == 4 and parts[0] != "property":
            current["valid"][parts[0]] = float(parts[1])
    return epochs


def parse_curve(logfile: Path):
    """Validation force MAE per epoch, [(epoch, MAE)], from the table rows
    that follow each '== epoch N done' line of the trainer log (the step
    records' tables, of training batches, are not read)."""
    return [(e["epoch"], e["valid"][keys.FORCES]) for e in parse_epochs(logfile)
            if keys.FORCES in e["valid"]]


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except Exception as e:
        return f"nvidia-smi unavailable ({e})"


class TrainLaunches:
    """While active, counts the message-kernel launches of every
    ``Trainer`` epoch: per train step (split by the model's compute dtype,
    so the epochs before and after the f32 switch stand apart) and per
    validation batch.  At each f32 switch it also records whether the
    switch came in the middle of this process's run or as the rebuild of
    a resumed one, whether the optimizer still holds the module's
    parameter tensors and whether the EMA copy was rebuilt on separate
    tensors.

    ``previous`` is an earlier process's :meth:`summary` (a resumed run's
    ``convergence.json``): its counts are added to this process's.
    ``on_epoch`` is called after every counted epoch, so that a run cut
    short keeps what it counted."""

    def __init__(self, previous=None, on_epoch=None):
        prev = previous or {}
        self.steps = dict(prev.get("steps_counted") or {})
        self.epochs = dict(prev.get("epochs_counted") or {})
        # the summary keeps launches per step and per batch: back to counts
        self.train = {d: {k: round(v * self.steps[d]) for k, v in per.items()}
                      for d, per in (prev.get("launches_per_train_step") or {}).items()}
        self.valid_batches = prev.get("valid_batches_counted") or 0
        self.valid = {k: round((v or 0) * self.valid_batches) for k, v in
                      (prev.get("launches_per_valid_batch") or {}).items()}
        switches = prev.get("f32_switch") or []
        # a file of the tool's first version holds one switch, not a list
        self.switches = [switches] if isinstance(switches, dict) else list(switches)
        self.on_epoch = on_epoch

    @contextlib.contextmanager
    def active(self):
        from ..ops import cuda_build
        from ..training import trainer as trainer_mod

        T = trainer_mod.Trainer
        train1epoch, validate, switch = T.train1epoch, T.validate, T._maybe_switch_to_f32
        ledger, counted_here = self, [0]

        def counts():
            return {k: cuda_build.LAUNCHES[k] for k in MESSAGE_KERNELS}

        def add(acc, before):
            for k in MESSAGE_KERNELS:
                acc[k] = acc.get(k, 0) + cuda_build.LAUNCHES[k] - before[k]

        def counted_switch(self_, epoch):
            was = self_._f32_switched
            switch(self_, epoch)
            if self_._f32_switched and not was:
                ledger.switches.append(dict(ledger.check_switch(self_, epoch),
                                            mid_run=counted_here[0] > 0))

        def counted_train(self_):
            before, step0 = counts(), self_.step
            loss = train1epoch(self_)
            dtype = str(self_.config.model.model_kwargs.get("compute_dtype", "float32"))
            ledger.steps[dtype] = ledger.steps.get(dtype, 0) + self_.step - step0
            ledger.epochs[dtype] = ledger.epochs.get(dtype, 0) + 1
            add(ledger.train.setdefault(dtype, {}), before)
            counted_here[0] += 1
            return loss

        def counted_validate(self_):
            inner, n = self_.eval_step, [0]

            def eval_step(batch):
                n[0] += 1
                return inner(batch)

            before = counts()
            self_.eval_step = eval_step
            try:
                results = validate(self_)
            finally:
                self_.eval_step = inner
            ledger.valid_batches += n[0]
            add(ledger.valid, before)
            if ledger.on_epoch is not None:
                ledger.on_epoch()
            return results

        T.train1epoch, T.validate, T._maybe_switch_to_f32 = (counted_train, counted_validate,
                                                             counted_switch)
        try:
            yield self
        finally:
            T.train1epoch, T.validate, T._maybe_switch_to_f32 = train1epoch, validate, switch

    @staticmethod
    def check_switch(trainer, epoch):
        opt_ids = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
        mod_ids = [id(p) for p in trainer.module.parameters()]
        ema = trainer.ema_module
        ema_ids = {id(p) for p in ema.parameters()} if ema is not None else set()
        return {
            "epoch": epoch,
            "compute_dtype": trainer.config.model.model_kwargs.get("compute_dtype"),
            "optimizer_holds_module_params": opt_ids <= set(mod_ids) and bool(opt_ids),
            "step_params_are_module_params": [id(p) for p in trainer.params] == mod_ids,
            "ema_rebuilt": ema is not None and not (ema_ids & set(mod_ids))
            and type(ema) is type(trainer.module),
        }

    def summary(self):
        """The counts as ``convergence.json`` keeps them: launches per train
        step by dtype and per validation batch (None where nothing was
        counted), the steps, epochs and validation batches counted, and the
        f32 switches (``epoch`` is the trainer's, from 0)."""
        ratio = lambda a, b: (a / b if b else None)
        return {
            "launches_per_train_step": {d: {k: ratio(acc.get(k, 0), self.steps[d])
                                            for k in MESSAGE_KERNELS}
                                        for d, acc in self.train.items()},
            "launches_per_valid_batch": {k: ratio(self.valid.get(k, 0), self.valid_batches)
                                         for k in MESSAGE_KERNELS},
            "steps_counted": dict(self.steps), "epochs_counted": dict(self.epochs),
            "valid_batches_counted": self.valid_batches, "f32_switch": list(self.switches),
        }


def dataset_checksum(db_path) -> str:
    """sha256 over the dataset directory's files (data, info, split)."""
    h = hashlib.sha256()
    for f in sorted(Path(db_path).iterdir()):
        if f.is_file():
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()


def nve_protocol(ff, dp, steps: int, timestep_fs: float, temperature: float,
                 rng: np.random.Generator):
    """The JAX tool's NVE protocol on the force field ``ff`` (``ff(pos) ->
    (E, F)`` in eV and A) from the structure ``dp``: FIRE up to 800 steps,
    600 Langevin steps from Maxwell-Boltzmann velocities, then ``steps``
    of velocity Verlet with E_tot logged every 20 steps.  Returns the drift
    fit (:func:`drift_fit`), the force calls of the NVE part and their ms
    per call."""
    from ..run.dynamics import FIREStage, Langevin, MDState, VelocityVerlet, maxwell_boltzmann
    from ..utils.qc import ATOM_MASS

    masses = ATOM_MASS[dp.atomic_numbers]
    # standard protocol: relax on the PES that is integrated (the
    # generator's crude true-PES descent leaves several eV of strain),
    # then thermalize with Langevin, THEN measure NVE
    state = MDState(dp.pos.copy(), np.zeros_like(dp.pos), masses)
    fire = FIREStage(ff, timestep_fs, fmax=0.05)
    for _ in range(800):
        state = fire.step(state, rng)
        if fire.converged:
            break
    state = MDState(state.pos, maxwell_boltzmann(masses, temperature, rng), masses)
    lang = Langevin(ff, timestep_fs, temperature, friction_fs=0.02)
    for _ in range(600):
        state = lang.step(state, rng)
    state = MDState(state.pos, state.vel, masses)
    calls = [0]

    def counted(pos):
        calls[0] += 1
        return ff(pos)

    integ = VelocityVerlet(counted, timestep_fs)
    e0_pot, _ = ff(state.pos)
    e0 = e0_pot + state.kinetic_energy()
    etot = []
    t0 = time.perf_counter()
    for i in range(steps):
        state = integ.step(state, rng)
        if (i + 1) % 20 == 0:
            e_pot, _ = counted(state.pos)
            etot.append(e_pot + state.kinetic_energy())
    wall = time.perf_counter() - t0
    etot = np.asarray(etot)
    t_ps = (np.arange(1, len(etot) + 1) * 20 * timestep_fs) / 1000.0
    n_atoms = len(dp.atomic_numbers)
    out = drift_fit(t_ps, etot, e0, n_atoms)
    out.update({"n_atoms": n_atoms, "steps": steps, "timestep_fs": timestep_fs,
                "calls": calls[0], "ms_per_call": 1e3 * wall / max(calls[0], 1)})
    return out


def nve_drift(ckpt: str, out_dir: Path, steps: int, timestep_fs: float,
              temperature: float, rng: np.random.Generator, device=None):
    """NVE total-energy drift (meV/atom/ps) of a 24-atom cluster on the
    trained model (:func:`nve_protocol`).  The Calculator takes the route
    its own rules pick (no ``pallas=``); the route and the message
    launches per force call are returned with the drift."""
    from ..interface.calculator import Calculator
    from ..ops import cuda_build
    from ..run.dynamics import ForceField
    from .make_synthetic_dataset import sample_structure

    dp = sample_structure(rng, n_atoms=24, device=device)
    # exact f32 matmuls: reduced-precision force noise is non-conservative
    # and shows up directly as NVE drift
    calc = Calculator(ckpt, use_ema=True, matmul_precision="float32", device=device)
    ff, calls = ForceField(calc, dp.atomic_numbers), [0]

    def counted(pos):
        calls[0] += 1
        return ff(pos)

    launches0 = {k: cuda_build.LAUNCHES[k] for k in MESSAGE_KERNELS}
    out = nve_protocol(counted, dp, steps, timestep_fs, temperature, rng)
    out.update({"matmul_precision": "float32", "route": calc.last_route,
                "launches_per_call": {k: (cuda_build.LAUNCHES[k] - launches0[k]) / calls[0]
                                      for k in MESSAGE_KERNELS}})
    return out


def pes_nve_drift(steps: int, timestep_fs: float, temperature: float,
                  rng: np.random.Generator, device=None):
    """:func:`nve_protocol` on the synthetic PES itself (the labels'
    function, on ``device``), from the cluster :func:`nve_drift` samples
    with the same ``rng``: the drift of the integrators and the protocol
    with exact forces, the yardstick for the model's."""
    from .make_synthetic_dataset import make_energy_fn, sample_structure

    dp = sample_structure(rng, n_atoms=24, device=device)
    efn = make_energy_fn(device)

    def ff(pos):
        e, g = efn(pos, dp.atomic_numbers)
        return float(e), -g.double().cpu().numpy()

    return nve_protocol(ff, dp, steps, timestep_fs, temperature, rng)


def force_check(ckpt: str, rng: np.random.Generator, h: float = 2e-3, device=None):
    """The checkpoint's forces (EMA weights, the Calculator's own route,
    f32 matmuls) against central differences of its energy on a 24-atom
    cluster, along the unit direction of F and one random unit direction
    d: |(E(R - h d) - E(R + h d)) / 2h - F.d| over |F| (Frobenius) for
    each, and the route.  The step's truncation error is (k h)^2 / 6 of
    the force for an energy of wave number k along d (a flagship-width
    model of one epoch: about 5e-4 at h = 2e-3 A, 6e-3 at 5e-3 A); the
    energy's own call-to-call spread at R (three calls; float-atomic sums
    on the card) over h |F| bounds what the differences add
    (``spread_rel``)."""
    from ..interface.calculator import Calculator
    from ..run.dynamics import ForceField
    from .make_synthetic_dataset import sample_structure

    dp = sample_structure(rng, n_atoms=24, device=device)
    calc = Calculator(ckpt, use_ema=True, matmul_precision="float32", device=device)
    ff = ForceField(calc, dp.atomic_numbers)
    _, f = ff(dp.pos)
    norm = float(np.linalg.norm(f))
    energies = [float(ff(dp.pos)[0]) for _ in range(3)]
    spread = max(energies) - min(energies)
    rand = rng.normal(size=f.shape)
    errs = []
    for d in (f / norm, rand / np.linalg.norm(rand)):
        fd = (float(ff(dp.pos - h * d)[0]) - float(ff(dp.pos + h * d)[0])) / (2 * h)
        errs.append(abs(fd - float(np.sum(f * d))) / norm)
    return {"rel_err_along_F": errs[0], "rel_err_random": errs[1], "force_norm": norm,
            "energy_spread": spread, "spread_rel": spread / (h * norm), "h_A": h,
            "route": calc.last_route}


def drift_fit(t_ps, etot, e0, n_atoms):
    """The NVE record's drift numbers: the linear fit's slope of E_tot -
    E_0 against time (robust to bounded oscillation) and the largest
    excursion, per atom."""
    slope = np.polyfit(t_ps, etot - e0, 1)[0]  # eV/ps
    return {
        "t_ps": float(t_ps[-1]),
        "max_abs_dev_meV_per_atom": float(np.abs(etot - e0).max() / n_atoms * 1e3),
        "drift_meV_per_atom_per_ps": float(abs(slope) / n_atoms * 1e3),
    }


def dtype_gap(config: XequiConfig, ckpt: str, dtypes, device=None):
    """The checkpoint's EMA weights on the validation split under each
    compute dtype of ``dtypes``, the module rebuilt around the same
    parameters as ``Trainer._maybe_switch_to_f32`` rebuilds it: per dtype
    the energy MAE and mean signed error, and the mean and spread over the
    structures of the first dtype's energy minus the last's (energy unit
    of the model)."""
    import torch

    from ..data.batching import kernel_layout_from_model_kwargs
    from ..data.dataset import DataLoader
    from ..models.model import resolve_model
    from ..models.properties import make_forward
    from ..run.inference import batch_to_device, load_model_from_checkpoint, resolve_device
    from ..run.train import build_datasets
    from ..training.trainer import _adopt_parameters

    dev = resolve_device(device)
    module, extra, _cutoff, _blob, mc = load_model_from_checkpoint(ckpt, use_ema=True)
    module = module.to(dev)
    _train, valid, _test = build_datasets(config)
    loader = DataLoader(valid, config.data.valid_batch_size,
                        kernel_layout=kernel_layout_from_model_kwargs(mc["model_kwargs"]))
    pred, target = {}, []
    for dt in dtypes:
        mk = dict(mc["model_kwargs"], compute_dtype=dt, update_compute_dtype=dt)
        rebuilt = _adopt_parameters(resolve_model(mc["model_name"], **mk)[0].to(dev), module)
        forward = make_forward(rebuilt.eval(), extra)
        got = []
        with torch.no_grad():
            for raw in loader:
                mask = np.asarray(raw[keys.GRAPH_MASK]).astype(bool)
                out = forward(batch_to_device(raw, dev), False, False)
                got.append(out[keys.TOTAL_ENERGY].double().cpu().numpy()[mask])
                if not pred:
                    target.append(np.asarray(raw[keys.TOTAL_ENERGY], np.float64)[mask])
        pred[dt] = np.concatenate(got)
    target = np.concatenate(target)
    res = {dt: {"energy_mae": float(np.abs(e - target).mean()),
                "energy_mean_error": float((e - target).mean())} for dt, e in pred.items()}
    diff = pred[dtypes[0]] - pred[dtypes[-1]]
    res.update(energy_diff_mean=float(diff.mean()), energy_diff_std=float(diff.std()),
               n_structures=len(target), split="valid")
    return res


def flagship_report(report, epochs):
    """The run under the keys of the JAX package's
    ``tools/convergence_flagship.json``, from ``convergence.json``'s
    ``report`` (which also holds the run's planned epochs, f32 epochs,
    compute dtype and seed) and the trainer log's ``epochs``
    (:func:`parse_epochs`)."""
    planned, f32_epochs, dtype = (report["epochs"], report["f32_finetune_epochs"],
                                  report["compute_dtype"])
    # epochs are counted from 1 there (epoch k is the trainer's epoch
    # k - 1), as here; an epoch a preemption cut short has no validation
    # record and is listed
    curve = [(e["epoch"] + 1, e["valid"].get(keys.FORCES)) for e in epochs]
    by_epoch = dict(curve)
    n_done = max(by_epoch) if by_epoch else 0
    first_f32 = planned - f32_epochs + 1 if f32_epochs else None
    test_e = report["test"].get(keys.TOTAL_ENERGY, {})
    test_f = report["test"].get(keys.FORCES, {})
    mk = report["model"]
    every8 = [c for c in curve if (c[0] - 1) % 8 == 0 or c[0] >= n_done - 3]
    # each switch the log records, with the checks of the process that
    # counted it (the trainer's epoch + 1, as above)
    checks = {c["epoch"] + 1: c for c in report.get("f32_switch") or []}
    switches = [dict(epoch=e["epoch"] + 1, when=e["f32_switch"],
                     checks={k: v for k, v in checks.get(e["epoch"] + 1, {}).items()
                             if k not in ("epoch", "mid_run")} or None)
                for e in epochs if e["f32_switch"]]
    return {
        "what": "Flagship-scale converged-accuracy study of the PyTorch / CUDA port",
        "dataset": {"name": Path(report["dataset"]["path"]).name,
                    "n_structures": report["dataset"]["n_structures"],
                    "sha256": report["dataset"]["sha256"], "split": "80/10/10"},
        "model": {"model_name": "xpainn", **{key: mk.get(key) for key in (
            "node_dim", "node_irreps", "num_basis", "action_blocks", "use_pallas_scatter")},
                  "compute_dtype": dtype, "update_compute_dtype": dtype,
                  "params_M": report.get("params_M")},
        "training": {
            "epochs_completed": n_done, "epochs_planned": planned,
            "epochs_without_validation": sorted(set(range(1, n_done + 1)) - set(by_epoch)),
            "f32_finetune_from_epoch": first_f32, "seed": report["seed"],
            "step_ms_trainer_median": report.get("step_ms_median"),
            "epoch_wall_s_median": report.get("epoch_s_median"),
            "epochs_wall_s_sum": report.get("epochs_wall_s_sum"),
            "launches_per_train_step": report.get("launches_per_train_step"),
            "launches_per_valid_batch": report.get("launches_per_valid_batch"),
            "launches_counted_over": {key: report.get(key) for key in (
                "steps_counted", "epochs_counted", "valid_batches_counted")},
            "f32_switches": switches,
        },
        f"heldout_test_ep{n_done}_ema": {
            "energy_mae_eV": test_e.get("mae"), "energy_rmse_eV": test_e.get("rmse"),
            "forces_mae_eV_per_A": test_f.get("mae"),
            "forces_rmse_eV_per_A": test_f.get("rmse"),
            "count_structures": test_e.get("count"),
            "count_force_components": test_f.get("count"),
        },
        "bf16_vs_f32_at_convergence": {} if not first_f32 else {
            f"valid_force_mae_bf16_epoch_{first_f32 - 1}": by_epoch.get(first_f32 - 1),
            f"valid_force_mae_f32_epoch_{first_f32}": by_epoch.get(first_f32),
            "valid_force_mae_f32_finetune_epoch_368": by_epoch.get(368),
            f"valid_force_mae_f32_finetune_epoch_{n_done}": by_epoch.get(n_done),
            f"valid_energy_by_dtype_ep{n_done}_ema": report.get("dtype_gap"),
        },
        "nve_from_flagship_checkpoint": report.get("nve"),
        "nve_on_the_synthetic_pes": report.get("nve_pes"),
        "valid_force_mae_curve_every_8_epochs": every8,
        "card": report.get("card"), "device": report.get("device"),
    }


def write_flagship_report(out: Path, log_file="loss.log") -> dict:
    """<out>/convergence_flagship.json from <out>/convergence.json and the
    trainer log (which also gives the parameter count); returns it."""
    report = json.loads((out / "convergence.json").read_text())
    m = re.search(r"model \S+: ([\d.]+)M parameters", (out / log_file).read_text())
    report.setdefault("params_M", float(m.group(1)) if m else None)
    flagship = flagship_report(report, parse_epochs(out / log_file))
    (out / "convergence_flagship.json").write_text(json.dumps(flagship, indent=1))
    return flagship


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("db_path")
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--out", default="converge_study")
    ap.add_argument("--md-steps", type=int, default=4000)
    ap.add_argument("--timestep", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=300.0)
    ap.add_argument("--drift-bound", type=float, default=1.0,
                    help="meV/atom/ps")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--node-dim", type=int, default=64)
    ap.add_argument("--irreps", default=None)
    ap.add_argument("--num-basis", type=int, default=16)
    ap.add_argument("--compute-dtype", default="float32")
    ap.add_argument("--f32-finetune-epochs", type=int, default=0)
    ap.add_argument("--mega", action="store_true")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--run-name", default="converge")
    ap.add_argument("--skip-md", action="store_true",
                    help="no NVE runs (a resumed study keeps the earlier ones)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <out>/<run-name>_last.ckpt and <out>/convergence.json")
    ap.add_argument("--seed", type=int, default=42,
                    help="the trainer's seed (weights and shuffling)")
    args = ap.parse_args(argv)

    import torch

    from ..ops import cuda_build
    from ..run.inference import resolve_device
    from ..run.test import run_test
    from ..run.train import run_train

    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "CPU"
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cfg = make_config(
        args.db_path, str(out), args.epochs,
        node_dim=args.node_dim, irreps=args.irreps,
        num_basis=args.num_basis, compute_dtype=args.compute_dtype,
        f32_finetune_epochs=args.f32_finetune_epochs, mega=args.mega,
        batch_size=args.batch_size, run_name=args.run_name, device=args.device,
        seed=args.seed,
    )
    ckpt = str(out / f"{args.run_name}_last.ckpt")
    conv = out / "convergence.json"
    previous = {}
    if args.resume:
        cfg.trainer.ckpt_file, cfg.trainer.resume = ckpt, True
        previous = json.loads(conv.read_text()) if conv.exists() else {}
    info = json.loads((Path(args.db_path) / "info.json").read_text())
    report = dict(previous)
    report.update({
        "epochs": args.epochs, "f32_finetune_epochs": args.f32_finetune_epochs,
        "compute_dtype": args.compute_dtype, "run_name": args.run_name, "seed": args.seed,
        "device": str(dev), "card": card,
        "dataset": {"path": str(args.db_path), "n_structures": info.get("num_records"),
                    "sha256": dataset_checksum(args.db_path)}})

    def save():
        conv.write_text(json.dumps({**report, **ledger.summary()}, default=float, indent=1))

    # written after every epoch: a run cut short keeps its counts, and a
    # resumed one adds its own to them
    ledger = TrainLaunches(previous, on_epoch=save)
    t0 = time.perf_counter()
    if not args.skip_train:
        print(f"=== training {args.epochs} epochs on {dev} ({card}) ===", flush=True)
        with ledger.active():
            trainer = run_train(cfg)
        report["n_dropped"] = {"train": trainer.train_loader.n_dropped,
                               "valid": trainer.valid_loader.n_dropped}
        if dev.type == "cuda":
            torch.cuda.synchronize()
    # this process's training wall (a resumed study: since the resume)
    report["wall_s"] = time.perf_counter() - t0
    metrics = run_test(cfg, ckpt_file=ckpt, use_ema=True, device=args.device)
    print("test metrics:", json.dumps(metrics, default=float), flush=True)
    if args.compute_dtype != "float32":
        report["dtype_gap"] = dtype_gap(cfg, ckpt, (args.compute_dtype, "float32"),
                                        device=args.device)
        print("energy by compute dtype:", json.dumps(report["dtype_gap"]), flush=True)

    epochs = parse_epochs(out / cfg.trainer.log_file)
    step_ms = [e["step_ms"] for e in epochs if e["step_ms"] is not None]
    if not args.skip_md:
        report["nve"] = nve_drift(ckpt, out, args.md_steps, args.timestep,
                                  args.temperature, np.random.default_rng(7),
                                  device=args.device)
        print("NVE:", json.dumps(report["nve"]), flush=True)
        report["nve_pes"] = pes_nve_drift(args.md_steps, args.timestep, args.temperature,
                                          np.random.default_rng(7), device=args.device)
        print("NVE on the synthetic PES:", json.dumps(report["nve_pes"]), flush=True)

    report.update({
        "model": dict(cfg.model.model_kwargs), "test": metrics,
        "valid_force_mae_curve": parse_curve(out / cfg.trainer.log_file)[-50:],
        "step_ms_median": float(np.median(step_ms)) if step_ms else None,
        "epoch_s_median": float(np.median([e["seconds"] for e in epochs])) if epochs else None,
        # every logged epoch's wall, over all runs of a resumed study
        "epochs_wall_s_sum": float(sum(e["seconds"] for e in epochs)),
        "kernel_launches_total": {k: cuda_build.LAUNCHES[k] for k in MESSAGE_KERNELS}})
    save()
    write_flagship_report(out, cfg.trainer.log_file)
    drift = report.get("nve")
    if drift is None:
        return 0
    if drift["drift_meV_per_atom_per_ps"] > args.drift_bound:
        print(f"FAIL: NVE drift {drift['drift_meV_per_atom_per_ps']:.3f} "
              f"> bound {args.drift_bound}")
        return 1
    print("NVE drift within bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
