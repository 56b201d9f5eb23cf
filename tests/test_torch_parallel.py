"""The port's data parallelism (xequinet_torch.parallel, the sharded loader,
rank-0 checkpoints) and profiling hooks, on the CPU, against the JAX
package where it has the same function.

Two gloo processes (tests/_torch_dp_worker.py, started as torchrun would
start them) run ``run_train`` with ``dp_devices: 2`` on an odd number of
molecules, so that the ranks' shards pack into different numbers of
micro-batches and the lockstep runs, and must end with bit-identical
parameters and EMA; two more run one data-parallel step, held against the
JAX ``make_dp_train_step`` on a 2-device CPU mesh at test_torch_training's
limits (loss 1e-5 relative; the clipped mean gradient 1e-4 of each
parameter's largest element plus twice the port's own change under a
one-ulp move of the positions; resolved parameter updates 1e-6 lr plus two
ulps).  Every worker is waited for with a timeout and killed on expiry, so
a deadlock fails the test instead of hanging it.
"""

import json
import math
import pickle
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate as jax_collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.data.dataset import DataLoader as JaxDataLoader
from xequinet_tpu.data.store import XDBDataset as JaxXDBDataset
from xequinet_tpu.data.transforms import build_transform_pipeline as jax_pipeline
from xequinet_tpu.models.model import make_apply_forward
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.parallel import data_parallel as jdp
from xequinet_tpu.parallel.mesh import make_mesh
from xequinet_tpu.training import loss as jloss
from xequinet_tpu.training import lr_schedule as jls
from xequinet_tpu.training.trainer import make_step_core as jax_make_step_core
from xequinet_torch.convert import load_checkpoint, load_flax_params, params_from_flax
from xequinet_torch.data.batching import collate
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.dataset import DataLoader
from xequinet_torch.data.store import XDBDataset, create_dataset
from xequinet_torch.data.transforms import build_transform_pipeline
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.parallel import data_parallel as dp
from xequinet_torch.parallel.mesh import maybe_init_distributed, world_size
from xequinet_torch.run.inference import batch_to_device
from xequinet_torch.run.train import run_train
from xequinet_torch.training import loss as tloss
from xequinet_torch.training.trainer import loss_and_grads
from xequinet_torch.utils import profiling
from xequinet_torch.utils.config import XequiConfig

WORKER = Path(__file__).parent / "_torch_dp_worker.py"
KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
          action_blocks=2, output_modes=["energy"])
WEIGHTS = {keys.TOTAL_ENERGY: 1.0, keys.FORCES: 10.0}
# a worker's wall limit: a deadlock fails the test within it
WORKER_TIMEOUT = 60


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(mode, work, world=2, check=True):
    """Start ``world`` ranks of the worker and wait for all of them, killing
    every one if any outlives WORKER_TIMEOUT; with ``check``, every one must
    exit with 0.  Returns their exit codes and outputs."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(WORKER), mode, str(r), str(world), port,
                               str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"{mode} workers did not finish within {WORKER_TIMEOUT} s (deadlock)")
    for p, out in zip(procs, outs):
        assert p.returncode == 0 or not check, f"worker failed:\n{out[-3000:]}"
    return [p.returncode for p in procs], outs


def _molecules(rng, n, lo=5, hi=8):
    """(port datapoints, JAX datapoints) with energy and force labels."""
    dps_t, dps_j = [], []
    for _ in range(n):
        k = int(rng.integers(lo, hi + 1))
        z = rng.integers(1, 9, k).astype(np.int32)
        pos = rng.normal(size=(k, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        e, f = float(rng.normal()), rng.normal(size=(k, 3))
        dps_t.append(Datapoint(z, pos, edge_index=ei, energy=e, forces=f))
        dps_j.append(JDatapoint(z, pos, edge_index=ei, energy=e, forces=f))
    return dps_t, dps_j


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    """15 molecules: 11 to train on (odd on purpose) and 4 to validate."""
    dps, _ = _molecules(np.random.default_rng(5), 15, lo=4, hi=7)
    path = tmp_path_factory.mktemp("dpdb") / "db"
    create_dataset(path, dps, units={keys.TOTAL_ENERGY: "eV"},
                   split={"train": list(range(11)), "valid": list(range(11, 15)), "test": []})
    return str(path)


def _config(db_path, dp_devices=2):
    cfg = XequiConfig()
    cfg.model.model_name = "xpainn"
    cfg.model.model_kwargs = dict(KW, use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16))
    cfg.data.db_path = db_path
    cfg.data.targets = [keys.TOTAL_ENERGY, keys.FORCES]
    cfg.data.batch_size = 10  # global: 5 per rank
    cfg.data.valid_batch_size = 4
    cfg.trainer.dp_devices = dp_devices
    cfg.trainer.max_epochs = 2
    cfg.trainer.warmup_epochs = 0
    cfg.trainer.log_steps = 1000
    cfg.trainer.seed = 0
    cfg.trainer.grad_clip = 5.0
    cfg.trainer.ema_decay = 0.99
    cfg.trainer.device = "cpu"
    return cfg


def test_two_process_dp_train_bit_identical_and_rank0_checkpoints(db, tmp_path):
    """``run_train`` in two gloo processes (the mega route's plain versions):
    both finish, with bit-identical parameters and EMA, and only rank 0
    wrote checkpoints.  The 11 molecules shard 6 / 5 and pack into 2 and 1
    micro-batches of 5, so rank 1 steps on an empty batch each epoch."""
    with open(tmp_path / "config.pkl", "wb") as f:
        pickle.dump(_config(db), f)
    _run_workers("train", tmp_path)
    d0 = (tmp_path / "digest_0.txt").read_text().split()
    d1 = (tmp_path / "digest_1.txt").read_text().split()
    assert d0[2] == "2", "the trainer did not see a process group of 2"
    assert d0[0] == d1[0], "the parameters differ between the ranks"
    assert d0[1] == d1[1], "the EMA differs between the ranks"
    assert d0[3] == d1[3] == "4", "the ranks ran different numbers of steps"
    assert (d0[4], d1[4]) == ("2", "1"), "the lockstep did not run"
    assert list((tmp_path / "run0").glob("*.ckpt"))
    assert not list((tmp_path / "run1").glob("*.ckpt"))


@pytest.mark.parametrize("where", ["step", "validation"])
def test_dp_preemption_on_one_rank_stops_both(db, tmp_path, where):
    """SIGTERM reaches rank 1 alone, after its first train step or inside its
    first validation: both ranks stop at the same point (the next step's
    round, or the end of the epoch) and exit with 128 + 15, and rank 0
    writes the resumable last checkpoint at that step (1, or the epoch's 2)
    while rank 1 writes nothing."""
    cfg = _config(db)
    cfg.trainer.max_epochs = 3
    with open(tmp_path / "config.pkl", "wb") as f:
        pickle.dump(cfg, f)
    rcs, outs = _run_workers(f"preempt_{where}", tmp_path, check=False)
    assert rcs == [143, 143], outs
    last = tmp_path / "run0" / "xequinet_last.ckpt"
    blob = load_checkpoint(str(last))
    assert (blob["step"], blob["epoch"]) == ((1, 0) if where == "step" else (2, 0))
    assert not list((tmp_path / "run1").glob("*.ckpt"))


@pytest.fixture(scope="module")
def jax_dp_step():
    """One JAX data-parallel step (plain route, f32) on a 2-device CPU mesh,
    two micro-batches of the same capacities, from one parameter tree:
    AdamW, cosine schedule with linear warmup, clip 5.0, EMA 0.999 (the
    train-step test's recipe, tests/test_torch_training.py)."""
    dps_t, dps_j = _molecules(np.random.default_rng(9), 4)
    caps = (40, 160, 3)
    micro = [jax_collate(dps_j[:2], *caps), jax_collate(dps_j[2:], *caps)]
    m, extra, _ = jax_resolve_model("xpainn", **KW)
    jb = {k: jnp.asarray(v) for k, v in micro[0].items()}
    params = jax.jit(lambda d: m.init(jax.random.PRNGKey(0), compute_edge_data(d)))(jb)["params"]
    sched = jls.resolve_lr_schedule("cosine_annealing", 1e-3, 100, warmup_steps=2)
    opt = jls.resolve_optimizer("adamw", sched)
    core = jax_make_step_core(make_apply_forward(m, extra), jloss.WeightedLoss("l2", **WEIGHTS),
                              opt, True, False, 5.0, 0.999,
                              jloss.ErrorMetric(keys.TOTAL_ENERGY, keys.FORCES))
    mesh = make_mesh(2)
    state = jdp.replicate((params, opt.init(params), params), mesh)
    batch = jdp.device_put_sharded_batch(jdp.stack_device_batches(micro), mesh)
    (new_p, new_opt, new_ema), loss, _ = jdp.make_dp_train_step(core, mesh)(
        state, batch, jnp.asarray(1.0))
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)
    (adam,) = [s for s in jax.tree_util.tree_leaves(new_opt, is_leaf=is_adam) if is_adam(s)]
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, jax.device_get(t))
    return dict(dps=dps_t, caps=caps, params=as_np(params), loss=float(loss),
                new_params=as_np(new_p), mu=as_np(adam.mu), lr0=float(sched(0)))


def test_dp_step_matches_jax_dp_step(jax_dp_step, tmp_path):
    """One port data-parallel step over two gloo processes, each on one
    micro-batch, against the JAX step over a 2-device mesh: the loss (the
    mean of the two), the clipped mean gradient (read from Adam's first
    moment), the resolved parameter updates; the ranks' parameters and EMA
    bit-identical; and the clipped gradient equal to the clip of the mean
    of the two micro-batches' gradients taken in this process."""
    case = jax_dp_step
    module, extra, _ = resolve_model("xpainn", **KW)
    load_flax_params(module, case["params"])
    micro = [case["dps"][:2], case["dps"][2:]]
    job = dict(kw=KW, state=module.state_dict(), weights=WEIGHTS, micro_batches=micro,
               caps=case["caps"])
    with open(tmp_path / "step.pkl", "wb") as f:
        pickle.dump(job, f)
    _run_workers("step", tmp_path)
    r0, r1 = (pickle.load(open(tmp_path / f"step_{r}.pkl", "rb")) for r in (0, 1))
    assert r0["loss"] == r1["loss"]
    for n in r0["params"]:
        assert np.array_equal(r0["params"][n], r1["params"][n]), n
    assert all(np.array_equal(a, b) for a, b in zip(r0["ema"], r1["ema"]))
    assert r0["metric_count"] == sum(3 * sum(d.num_atoms for d in m) for m in micro)
    assert math.isclose(r0["loss"], case["loss"], rel_tol=1e-5)

    # the mean of the micro-batches' gradients here, and its change under a
    # one-ulp move of the positions (the gradient limit's second term)
    named = list(module.named_parameters())
    fwd = make_forward(module, extra, create_graph=True)

    def mean_grads(scale):
        total = None
        for dps in micro:
            b = batch_to_device(collate(dps, *case["caps"]), "cpu")
            b[keys.POSITIONS] = b[keys.POSITIONS] * scale
            _, _, _, g = loss_and_grads(fwd, tloss.WeightedLoss("l2", **WEIGHTS),
                                        [p for _, p in named], b, True, False)
            total = g if total is None else [a + c for a, c in zip(total, g)]
        return {n: t / 2 for (n, _), t in zip(named, total)}

    mean, nudged = mean_grads(1.0), mean_grads(1.0 + 1e-7)
    gnorm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in mean.values()])))
    clip = min(1.0, 5.0 / gnorm)
    want_c = {k: v / 0.1 for k, v in params_from_flax(case["mu"], module).items()}
    want_p = params_from_flax(case["new_params"], module)
    old = params_from_flax(case["params"], module)
    eps32, lr, n_resolved = float(np.finfo(np.float32).eps), case["lr0"], 0
    for name, _ in named:
        got = torch.as_tensor(r0["clipped"][name])
        g = mean[name]
        scale = max(float(g.abs().max()), 1e-30)
        limit = 1e-4 + 2 * float((nudged[name] - g).abs().max()) / scale
        # the all-reduce computes the same sum and division as this mean
        assert float((got - g * clip).abs().max()) <= 1e-6 * scale * clip + 1e-12, name
        c_scale = float(got.abs().max())
        assert float((got - want_c[name]).abs().max()) <= limit * c_scale, name
        new = torch.as_tensor(r0["params"][name])
        resolved = g.abs() > 10 * limit * scale
        n_resolved += int(resolved.sum())
        ulps = 2 * eps32 * max(float(old[name].abs().max()), float(new.abs().max()))
        assert torch.equal(torch.sign((new - old[name])[resolved]), -torch.sign(g[resolved]))
        d = (new - want_p[name]).abs()[resolved]
        assert d.numel() == 0 or float(d.max()) <= 1e-6 * lr + ulps, name
    assert n_resolved > sum(p.numel() for _, p in named) // 2


def test_empty_batch_steps_to_zero(tmp_path):
    """A fully masked batch (``empty_batch_like``) keeps the slot layout and
    gives zero loss, zero gradients and zero metric counts (no 0 / 0) on
    the mega route's plain versions; its JAX twin matches key for key
    (the labels aside)."""
    dps, dps_j = _molecules(np.random.default_rng(3), 3)
    lay = {"block_nodes": 8, "chunk": 8, "pad_nodes": 16, "max_chunks": 16}
    b = collate(dps, 32, 128, 4, kernel_layout=lay)
    e = dp.empty_batch_like(b)
    je = jdp.empty_batch_like(jax_collate(dps_j, 32, 128, 4, kernel_layout=lay))
    assert set(e) == set(je)
    for k in e:
        # the JAX collate lays the nodes out before it adds the labels, so
        # its forces label keeps the unpadded rows (ROADMAP section 3)
        if k != keys.FORCES:
            assert np.array_equal(e[k], je[k]), k
    assert not e[keys.NODE_MASK].any() and not e[keys.GRAPH_MASK].any()
    assert np.array_equal(e[keys.K_NCHUNKS], b[keys.K_NCHUNKS])
    module, extra, _ = resolve_model("xpainn", **dict(KW, use_pallas_scatter="mega",
                                                      pallas_layout=(8, 8, 16, 16)))
    init_params(module, seed=0)
    named = list(module.named_parameters())
    loss, _, out, grads = loss_and_grads(make_forward(module, extra, create_graph=True),
                                         tloss.WeightedLoss("l2", **WEIGHTS),
                                         [p for _, p in named], batch_to_device(e, "cpu"), True,
                                         False)
    assert float(loss.detach()) == 0.0
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)
    metrics = tloss.ErrorMetric(keys.TOTAL_ENERGY, keys.FORCES)(out, batch_to_device(e, "cpu"))
    assert all(int(n) == 0 and float(l1.detach()) == 0.0 for l1, _, n in metrics.values())


def _loaders(db):
    ds = XDBDataset(db, split="train", transform=build_transform_pipeline(cutoff=5.0))
    jds = JaxXDBDataset(db, split="train", transform=jax_pipeline(cutoff=5.0))
    return ds, jds


def test_process_shard_partitions_dataset_as_jax(db):
    """Two shards see disjoint parts whose energies make up the whole set,
    batch for batch the JAX loader's."""
    ds, jds = _loaders(db)

    def energies(loader):
        return [np.asarray(b[keys.TOTAL_ENERGY])[np.asarray(b[keys.GRAPH_MASK])].tolist()
                for b in loader]

    full = sorted(sum(energies(DataLoader(ds, 4, shuffle=True, seed=1)), []))
    shards = []
    for shard in ((0, 2), (1, 2)):
        got = energies(DataLoader(ds, 4, shuffle=True, seed=1, process_shard=shard))
        want = energies(JaxDataLoader(jds, 4, shuffle=True, seed=1, process_shard=shard))
        assert got == want
        shards.append(sum(got, []))
        assert len(DataLoader(ds, 4, process_shard=shard)) == \
            len(JaxDataLoader(jds, 4, process_shard=shard))
    assert len(shards[0]) + len(shards[1]) == len(full)
    assert sorted(shards[0] + shards[1]) == pytest.approx(full)


def test_replica_batcher_lockstep_and_fatal_flag(db):
    """An exhausted rank steps on fully masked batches until every rank is
    done (the other rank simulated through the injected all-gather), the
    real batches first and unchanged; a rank with no batch at all raises on
    every rank.  Without a process group the batcher yields the loader's
    batches as they are."""
    ds, _ = _loaders(db)
    loader = DataLoader(ds, 2)
    local = list(loader)
    assert [b[keys.POSITIONS].tolist() for b in dp.ReplicaBatcher(loader)] == \
        [b[keys.POSITIONS].tolist() for b in local]
    rb = dp.ReplicaBatcher(loader, sync_processes=True)
    n_other = len(local) + 3
    calls = []

    def fake_allgather(flag):
        calls.append(int(flag[0]))
        return np.asarray([flag, [int(len(calls) <= n_other), 0]])

    rb._allgather = fake_allgather
    groups = list(rb)
    assert len(groups) == n_other and len(calls) == n_other + 1
    for g, b in zip(groups, local):
        assert np.array_equal(g[keys.POSITIONS], b[keys.POSITIONS])
    for g in groups[len(local):]:
        assert not g[keys.NODE_MASK].any() and not g[keys.GRAPH_MASK].any()
    assert len(rb) == len(loader)

    empty = dp.ReplicaBatcher(DataLoader(ds, 2), sync_processes=True)
    empty.loader = []
    empty._allgather = lambda flag: np.asarray([flag, [1, 0]])
    with pytest.raises(RuntimeError, match="no batch at all"):
        list(empty)


@pytest.mark.parametrize("who", ["this rank", "the other rank"])
def test_replica_batcher_stops_every_rank_on_one_signal(db, who):
    """A signal pending on either rank (its byte beside the data flag) ends
    the epoch at the same round on both, with ``stop_signal`` set; the
    batches before it are the loader's."""
    ds, _ = _loaders(db)
    loader = DataLoader(ds, 2)
    rb = dp.ReplicaBatcher(loader, sync_processes=True)
    pending = {"this rank": [0], "the other rank": [0]}
    calls = []

    def fake_allgather(flag):
        calls.append(int(flag[1]))
        return np.asarray([flag, [1, pending["the other rank"][0]]])

    rb._allgather = fake_allgather
    rb.stop_request = lambda: pending["this rank"][0]
    got = []
    for b in rb:
        got.append(b)
        if len(got) == 2:
            pending[who][0] = 15
    assert len(got) == 2 and rb.stop_signal == 15
    assert calls == [0, 0, 15 if who == "this rank" else 0]
    assert np.array_equal(got[1][keys.POSITIONS], list(loader)[1][keys.POSITIONS])


def test_dp_devices_overrequest_warns_and_trains_on_one(db, tmp_path):
    """``dp_devices`` above the process group's size warns and trains on the
    group (one process here), as the JAX driver clamps to its devices."""
    cfg = _config(db, dp_devices=8)
    cfg.trainer.max_epochs = 1
    cfg.trainer.save_dir = str(tmp_path / "clamp")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        trainer = run_train(cfg)
    assert any("dp_devices=8" in str(r.message) for r in rec)
    assert trainer.world_size == 1 and trainer.is_main_process
    assert all(torch.isfinite(p).all() for p in trainer.module.parameters())
    assert (tmp_path / "clamp" / "xequinet_last.ckpt").exists()


def test_maybe_init_distributed_keeps_the_callers_group(monkeypatch):
    """Without torchrun's environment nothing starts; a group the caller
    made is left as it is."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not maybe_init_distributed("cpu") and world_size() == 1
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        monkeypatch.setenv("WORLD_SIZE", "2")
        assert not maybe_init_distributed("cpu")
        assert dist.group.WORLD is group and world_size() == 1
    finally:
        dist.destroy_process_group()


def test_profiling_trace_holds_annotations(tmp_path):
    """``trace`` writes a Chrome trace that holds the ``annotate`` names and
    the operators run inside; ``device_memory_stats`` lists no card on the
    CPU; ``StepTimer`` is the logger's."""
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("xeq_collate"):
            x = torch.randn(64, 64)
        with profiling.annotate("xeq_step"):
            (x @ x).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"xeq_collate", "xeq_step"} <= names
    assert any(str(n).startswith("aten::mm") for n in names)
    assert profiling.device_memory_stats() == {}
    timer = profiling.StepTimer()
    timer.start()
    timer.stop()
    assert timer.stats()["count"] == 1
