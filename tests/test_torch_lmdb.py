"""The port's data and checkpoint paths that reach back to existing files,
against the JAX package on the CPU: the pure-Python LMDB page walker and
writer (byte for byte), reference XequiNet records (torch tensors inside
``torch_geometric`` classes, read without torch_geometric),
``XDBDataset`` on a ``data.lmdb`` directory, the LMDB-to-XDB converter
(``xequinet_torch/tools/convert_lmdb_dataset.py``) against the JAX tool
and the in-place datasets, and the trainer's two
resume paths: a preemption checkpoint (a ``train`` subprocess sent
SIGTERM, then ``train --resume``) and a JAX trainer's checkpoint whose
optimizer state carries over (end to end, and for each optimizer and a
``multi_transform`` chain on their own).

Tolerances: the LMDB files and records exactly; the resumed step's
parameters per parameter within 1e-4 of the step's largest change plus
twice the port's own change when the positions move by one f32 ulp
(x (1 + 1e-7)), measured in the test (chip_smoke.py's GRAD_TOL and
GRAD_ULP_FACTOR: at random weights a force loss's gradient is that
ill-conditioned).
"""

import copy
import json
import os
import pickle
import signal
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from xequinet_tpu.data import lmdb_pure as jpure
from xequinet_tpu.data import lmdb_reader as jreader
from xequinet_tpu.data.store import XDBDataset as JXDBDataset
from xequinet_tpu.utils import config as jconfig
from xequinet_tpu.utils import qc as jqc
from xequinet_torch import cli
from xequinet_torch.convert import load_checkpoint, load_params
from xequinet_torch.data import lmdb_pure as tpure
from xequinet_torch.data import lmdb_reader as treader
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.store import XDBDataset, create_dataset
from xequinet_torch.models.model import resolve_model
from xequinet_torch.run.train import run_train
from xequinet_torch.utils import qc as tqc
from xequinet_torch.utils.config import load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
          cutoff=5.0, action_blocks=1, output_modes=["energy"])
GRAD_TOL, GRAD_ULP_FACTOR = 1e-4, 2.0
SPLIT = {"train": list(range(12)), "valid": [12, 13], "test": [14, 15]}


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


# ---------------------------------------------------------------------------
# LMDB
# ---------------------------------------------------------------------------
def _records(kind):
    rng = np.random.default_rng(0)
    if kind == "small":
        return {int(i).to_bytes(8, "little"): f"value-{i}".encode() for i in range(10)}, 4096
    if kind == "deep":  # several branch levels and a page size other than 4096
        return {int(i).to_bytes(8, "little"): rng.bytes(20) for i in range(2000)}, 512
    return {b"big-0": rng.bytes(10000), b"big-1": rng.bytes(4096), b"tiny": b"x"}, 4096


@pytest.mark.parametrize("kind", ["small", "deep", "overflow"])
def test_pure_lmdb_matches_jax(kind, tmp_path):
    recs, psize = _records(kind)
    tpure.write_lmdb(tmp_path / "t.lmdb", recs, psize=psize)
    jpure.write_lmdb(tmp_path / "j.lmdb", recs, psize=psize)
    assert (tmp_path / "t.lmdb").read_bytes() == (tmp_path / "j.lmdb").read_bytes()
    for path in ("t.lmdb", "j.lmdb"):
        r, rj = tpure.PureLMDBReader(tmp_path / path), jpure.PureLMDBReader(tmp_path / path)
        assert r.stat() == rj.stat() and r.entries == len(recs) and r.psize == psize
        for k, v in recs.items():
            assert r.get(k) == v
        assert r.get(b"\xff" * 8) is None
        assert list(r.items()) == list(rj.items()) == sorted(recs.items())
        r.close()
        rj.close()


def _payload(i, periodic=False):
    rng = np.random.default_rng(i)
    n = 3 + i % 3
    out = {"atomic_numbers": torch.tensor(rng.integers(1, 9, n)),
           "pos": torch.tensor(rng.normal(size=(n, 3)).astype(np.float32)),
           "energy": torch.tensor([float(rng.normal())]),
           "forces": torch.tensor(rng.normal(size=(n, 3)).astype(np.float32)),
           "charge": torch.tensor([i % 2]), "spin": torch.tensor([0]),
           "dipole": torch.tensor(rng.normal(size=(1, 3)).astype(np.float32))}
    if periodic:
        out.update(cell=torch.eye(3).unsqueeze(0) * 9.0, pbc=torch.tensor([[True] * 3]),
                   virial=torch.tensor(rng.normal(size=(1, 3, 3)).astype(np.float32)))
    return out


def _same_datapoint(a, b):
    for f in ("atomic_numbers", "pos", "cell", "pbc", "forces", "virial", "dipole"):
        va, vb = getattr(a, f), getattr(b, f)
        assert (va is None) == (vb is None), f
        if va is not None:
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=f)
    for f in ("energy", "charge", "spin"):
        assert getattr(a, f) == getattr(b, f), f


def test_reference_records_match_jax(monkeypatch):
    """torch tensors inside torch_geometric classes, read without
    torch_geometric: the same datapoint as the JAX reader's."""
    for i, periodic in ((0, False), (1, True)):
        blob = treader.pyg_dumps(_payload(i, periodic))
        with pytest.raises(ImportError):
            import torch_geometric  # noqa: F401
        got = treader.record_to_datapoint(treader.tolerant_loads(blob))
        want = jreader.record_to_datapoint(jreader.tolerant_loads(blob))
        _same_datapoint(got, want)
        assert got.cell is None or (got.cell.shape, got.virial.shape) == ((3, 3), (3, 3))
        assert isinstance(got.energy, float) and got.dipole.shape == (3,)


def test_lmdb_dataset_matches_jax_store(tmp_path, monkeypatch):
    """A reference-format ``data.lmdb`` directory read in place by
    ``XDBDataset``: the JAX store's datapoints, split and transform
    applied."""
    blobs = {int(i).to_bytes(8, "little"): treader.pyg_dumps(_payload(i, i == 2))
             for i in range(5)}
    tpure.write_lmdb(tmp_path / "data.lmdb", blobs)
    (tmp_path / "info.json").write_text('{"units": {"energy": "eV"}}')
    (tmp_path / "split.json").write_text('{"train": [4, 0, 2], "test": [1]}')
    for split in ("train", "test"):
        got = XDBDataset(tmp_path, split=split)
        want = JXDBDataset(tmp_path, split=split)
        assert len(got) == len(want) and got.units == want.units == {"energy": "eV"}
        for i in range(len(got)):
            _same_datapoint(got[i], want[i])
        got.reader.close()
    os.remove(tmp_path / "data.lmdb")
    with pytest.raises(FileNotFoundError, match="data.xdb or data.lmdb"):
        XDBDataset(tmp_path)


# ---------------------------------------------------------------------------
# the LMDB-to-XDB converter
# ---------------------------------------------------------------------------
def _reference_dataset(path, n):
    """A reference XequiNet dataset directory of ``n`` fake-PyG records
    (every third periodic), its units and a seeded split."""
    path.mkdir()
    blobs = {int(i).to_bytes(8, "little"): treader.pyg_dumps(_payload(i, i % 3 == 2))
             for i in range(n)}
    tpure.write_lmdb(path / "data.lmdb", blobs)
    (path / "info.json").write_text('{"units": {"energy": "eV", "pos": "Angstrom"}}')
    idx = np.random.default_rng(n).permutation(n).tolist()
    k = n // 10 or 1
    split = {"train": idx[2 * k:], "valid": idx[:k], "test": idx[k:2 * k]}
    (path / "split.json").write_text(json.dumps(split))
    return split


def _jax_convert(src, dst, monkeypatch):
    """The JAX tool's own ``convert`` under a stand-in ``lmdb`` package (the
    JAX package's page walker behind ``open`` / ``begin`` / ``cursor``),
    removed again before it returns."""
    from tools import convert_lmdb_dataset as jtool

    class Txn:
        def __init__(self, reader):
            self.reader = reader

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.reader.close()

        def cursor(self):
            return self.reader.items()

    lmdb = types.ModuleType("lmdb")
    lmdb.open = lambda path, **kw: types.SimpleNamespace(
        begin=lambda: Txn(jpure.PureLMDBReader(path)))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "lmdb", lmdb)
        jtool.convert(src, dst)


def test_lmdb_converter_matches_jax_tool(tmp_path, monkeypatch):
    """At 5 records the port's tool, with no ``lmdb`` package, writes the
    JAX tool's ``data.xdb``, ``info.json`` and ``split.json`` byte for byte."""
    from xequinet_torch.tools import convert_lmdb_dataset as ttool

    _reference_dataset(tmp_path / "src", 5)
    _jax_convert(tmp_path / "src", tmp_path / "jax", monkeypatch)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "lmdb", None)  # the pure page walker's route
        assert ttool.convert(tmp_path / "src", tmp_path / "port") == 5
    for name in ("data.xdb", "info.json", "split.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert json.loads((tmp_path / "port" / "info.json").read_text())["num_records"] == 5


def test_lmdb_converter_keeps_index_order(tmp_path, monkeypatch):
    """At 300 records the port's XDB holds record i at index i: each split
    equals both packages' in-place ``XDBDataset`` of the LMDB.  The JAX
    tool writes the cursor's order (keys sorted as bytes: 0, 256, 1, 257,
    ...), where its copied split names other records."""
    from xequinet_torch.tools import convert_lmdb_dataset as ttool

    n = 300
    split = _reference_dataset(tmp_path / "src", n)
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "lmdb", None)
        ttool.main([str(tmp_path / "src"), str(tmp_path / "port")])
    for name in split:
        got = XDBDataset(tmp_path / "port", split=name)
        in_place = XDBDataset(tmp_path / "src", split=name)
        jax_in_place = JXDBDataset(tmp_path / "src", split=name)
        assert len(got) == len(in_place) == len(jax_in_place) == len(split[name])
        assert got.units == in_place.units == {"energy": "eV", "pos": "Angstrom"}
        for i in range(len(got)):
            _same_datapoint(got[i], in_place[i])
            _same_datapoint(got[i], jax_in_place[i])
        for ds in (got, in_place, jax_in_place):
            ds.reader.close()
    # the JAX tool: record k of its XDB is the k-th key in byte order
    _jax_convert(tmp_path / "src", tmp_path / "jax", monkeypatch)
    cursor = sorted(range(n), key=lambda i: int(i).to_bytes(8, "little"))
    jax_xdb, port_xdb = XDBDataset(tmp_path / "jax").reader, XDBDataset(tmp_path / "port").reader
    assert cursor[:4] == [0, 256, 1, 257] and sum(c != i for i, c in enumerate(cursor)) == n - 1
    for k in (0, 1, 2, 87, 88, n - 1):
        _same_datapoint(jax_xdb[k], port_xdb[cursor[k]])
    jax_xdb.close()
    port_xdb.close()


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------
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
def db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lmdb") / "db")
    create_dataset(path, _molecules(0, 16), units={}, split=SPLIT)
    return path


def _train_yaml(path, db, save_dir, **trainer):
    """A training config written as text, as a user writes one."""
    t = dict(dict(max_epochs=2, warmup_epochs=1, lossfn="l2", max_lr=2e-3, seed=0,
                  device="cpu"), save_dir=save_dir, **trainer)
    path.write_text(
        "model:\n  model_kwargs:\n" + "".join(f"    {k}: {v}\n" for k, v in KW.items())
        + f"data:\n  db_path: {db}\n  targets: [energy, forces]  # both\n"
        "  batch_size: 4\n  valid_batch_size: 4\n"
        + "trainer:\n" + "".join(f"  {k}: {v}\n" for k, v in t.items()))
    return str(path)


def test_preemption_checkpoint_and_resume(db, tmp_path):
    """``train`` in a subprocess, sent SIGTERM after its first logged step:
    exit code 143 and a resumable last checkpoint; ``train --resume``
    then goes on from the epoch after the one it was in."""
    save = tmp_path / "out"
    cfg = _train_yaml(tmp_path / "c.yaml", db, str(save), max_epochs=1000,
                      log_steps=1)
    proc = subprocess.Popen([sys.executable, "-m", "xequinet_torch", "train", "-C", cfg],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if " step 1 loss " in line:
                break
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 128 + signal.SIGTERM, rest[-2000:]
    blob = load_checkpoint(str(save / "xequinet_last.ckpt"))
    assert {"model", "opt_state", "epoch", "step"} <= set(blob)
    epoch = blob["epoch"]
    cfg2 = _train_yaml(tmp_path / "c2.yaml", db, str(save), max_epochs=epoch + 2,
                       log_steps=1000)
    assert cli.main(["train", "-C", cfg2, "-c", str(save / "xequinet_last.ckpt"), "-r"]) == 0
    log = (save / "loss.log").read_text()
    assert f"resumed from {save / 'xequinet_last.ckpt'} at epoch {epoch + 1}" in log
    assert load_checkpoint(str(save / "xequinet_last.ckpt"))["epoch"] == epoch + 1


def test_resume_from_jax_keeps_the_optimizer_state(db, tmp_path, monkeypatch):
    """Two JAX steps, a save, then one more step in each package from that
    checkpoint: the resumed parameters agree (the optimizer's moments and
    count carried over, the schedule going on from update 2)."""
    import jax
    import jax.numpy as jnp

    from xequinet_tpu.models.properties import compute_edge_data
    from xequinet_tpu.run import train as jtrain

    def jit_init(module, sample_batch, seed=0):
        """The JAX package's ``init_params`` jitted (eager flax init costs
        seconds per batch shape on the CPU)."""
        data = {k: jnp.asarray(v) for k, v in sample_batch.items()}
        return jax.jit(lambda d: module.init(jax.random.PRNGKey(seed),
                                             compute_edge_data(d))["params"])(data)

    monkeypatch.setattr(jtrain, "init_params", jit_init)
    jax_run_train = jtrain.run_train

    # one step per epoch: the whole train split (12 molecules) in one batch
    over = {"model": {"model_kwargs": KW},
            "data": {"db_path": db, "targets": ["energy", "forces"], "batch_size": 12,
                     "valid_batch_size": 4}}
    # dp_devices 1: the JAX trainer on one device, as the port trains
    tr = dict(max_epochs=2, warmup_epochs=1, lossfn="l2", max_lr=5e-3, grad_clip=5.0, dp_devices=1,
              losses_weight={"energy": 1.0, "forces": 10.0}, log_steps=1000, seed=0)
    first = str(tmp_path / "jax0")
    jax_run_train(jconfig.load_config(overrides=dict(over, trainer=dict(tr, save_dir=first))))
    ckpt = os.path.join(first, "xequinet_last.ckpt")
    assert isinstance(pickle.load(open(ckpt, "rb"))["opt_state"], bytes)
    resumed = dict(tr, max_epochs=3, resume=True, ckpt_file=ckpt)
    jax_tr = jax_run_train(jconfig.load_config(overrides=dict(
        over, trainer=dict(resumed, save_dir=str(tmp_path / "jax1")))))
    want = load_checkpoint(os.path.join(str(tmp_path / "jax1"), "xequinet_last.ckpt"))["model"]

    def port_step(db, tag):
        o = copy.deepcopy(over)
        o["data"]["db_path"] = db
        o["trainer"] = dict(resumed, save_dir=str(tmp_path / tag), device="cpu")
        t = run_train(load_config(overrides=o))
        return {n: p.detach().clone() for n, p in t.module.named_parameters()}

    got = port_step(db, "port")
    # the same step with the positions moved by one f32 ulp
    src = XDBDataset(db, split="train")
    nudged = [Datapoint(d.atomic_numbers, d.pos * (1 + 1e-7), energy=d.energy, forces=d.forces)
              for d in (src.reader[i] for i in range(len(src.reader)))]
    create_dataset(str(tmp_path / "db_nudged"), nudged, units={}, split=SPLIT)
    moved = port_step(str(tmp_path / "db_nudged"), "nudged")
    ref = resolve_model("xpainn", **KW)[0]
    load_params(ref, want)
    before = resolve_model("xpainn", **KW)[0]
    load_params(before, load_checkpoint(ckpt)["model"])
    p0 = dict(before.named_parameters())
    assert jax_tr.epoch == 2
    for name, w in ref.named_parameters():
        w = w.detach()
        scale = float((w - p0[name].detach()).abs().max())
        limit = GRAD_TOL * scale + GRAD_ULP_FACTOR * float((moved[name] - got[name]).abs().max())
        err = float((got[name] - w).abs().max())
        assert err <= limit, (name, err, limit, scale)


@pytest.fixture(scope="module")
def jax_tree():
    """The JAX package's parameter tree of the small XPaiNN (jitted init)."""
    import jax
    import jax.numpy as jnp

    from xequinet_tpu.data.batching import collate as jax_collate
    from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
    from xequinet_tpu.models.model import resolve_model as jax_resolve_model
    from xequinet_tpu.models.properties import compute_edge_data
    from xequinet_tpu.ops.radius_graph import radius_graph_np

    d = _molecules(3, 1)[0]
    batch = {k: jnp.asarray(v) for k, v in jax_collate([JDatapoint(
        d.atomic_numbers, d.pos, edge_index=radius_graph_np(d.pos, 5.0)[0])]).items()}
    module = jax_resolve_model("xpainn", **KW)[0]
    return jax.jit(lambda b: module.init(jax.random.PRNGKey(1), compute_edge_data(b))["params"])(
        batch)


@pytest.mark.parametrize("name", ["adam", "adamw", "nadam", "radam", "adamw-finetune"])
def test_optax_state_carries_into_each_optimizer(name, jax_tree):
    """A hundred optax updates, the state handed to the port's optimizer
    (``Trainer._load_optax_state``), then two more updates on identical
    gradients in both: the parameters' change over those two within 1e-5
    of its largest plus two f32 ulps.  optax evaluates the bias
    corrections 1 - b2^t in f32, with a relative error near
    6e-8 x b2^t / (1 - b2^t): 9e-6 at t = 7, 6e-7 at t = 101, which
    is why the hand-over comes late; radam's rectification multiplies it
    by ~2000 in rho (at t = 31 the two packages' steps part by 3.2e-4).
    With ``finetune`` the JAX chain is
    ``multi_transform`` over the trainable ``blocks_3`` (the frozen
    parameters have no moments)."""
    import types

    import jax
    import optax
    from flax import serialization

    from xequinet_tpu.training import lr_schedule as jls
    from xequinet_tpu.training.trainer import _freeze_except
    from xequinet_torch.convert import params_from_flax
    from xequinet_torch.training import lr_schedule as tls
    from xequinet_torch.training.trainer import Trainer, _flax_path

    opt_name, _, finetune = name.partition("-")
    rng = np.random.default_rng(2)
    leaves, treedef = jax.tree_util.tree_flatten(jax_tree)
    grads = [jax.tree_util.tree_unflatten(treedef, [
        (rng.normal(size=x.shape) * 10.0 ** rng.integers(-3, 1, x.shape)).astype(np.float32)
        for x in leaves]) for _ in range(102)]
    lr = 1e-3
    opt = jls.resolve_optimizer(opt_name, lambda count: lr)
    if finetune:
        opt = _freeze_except(opt, ["blocks_3"], jax_tree)
    state, p = opt.init(jax_tree), jax_tree
    update, apply = jax.jit(opt.update), jax.jit(optax.apply_updates)
    for g in grads[:100]:
        upd, state = update(g, state, p)
        p = apply(p, upd)
    as_sd = lambda tree: params_from_flax(jax.tree_util.tree_map(np.asarray, tree))
    module = resolve_model("xpainn", **KW)[0]
    load_params(module, jax.tree_util.tree_map(np.asarray, p))
    named = list(module.named_parameters())
    trainable = [q for n, q in named if not finetune or "blocks_3" in _flax_path(n)]
    topt = tls.resolve_optimizer(opt_name, trainable)
    host = types.SimpleNamespace(module=module, optimizer=topt, _log=lambda msg: None)
    assert Trainer._load_optax_state(host, serialization.to_bytes(state)) == 100
    start = {n: q.detach().clone() for n, q in named}
    for g in grads[100:]:
        upd, state = update(g, state, p)
        p = apply(p, upd)
        gt = as_sd(g)
        for n, q in named:
            q.grad = gt[n].clone()
        tls.set_lr(topt, lr)
        topt.step()
    want = as_sd(p)
    rel = 1e-4 if opt_name == "radam" else 1e-5
    moved = 0
    for n, q in named:
        w = (want[n] - start[n]).double()
        got = (q.detach() - start[n]).double()
        ulps = 2 * float(np.finfo(np.float32).eps) * float(start[n].abs().max())
        err = float((got - w).abs().max())
        assert err <= rel * float(w.abs().max()) + ulps, (n, err, float(w.abs().max()), ulps)
        moved += int(float(w.abs().max()) > 0)
    assert moved == (sum("blocks_3" in _flax_path(n) for n, _ in named) if finetune
                     else len(named))
