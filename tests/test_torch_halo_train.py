"""Training on halo-decomposed systems in the port (parallel/halo's train
steps and run/train.py's run_halo_train) against the JAX package, on the
CPU.

One pool of four gloo processes (tests/_torch_halo_worker.py) runs every
case, each rank on its own shard: one ``make_halo_train_step`` on four
shards of a free chain (plain route), and one ``make_halo_dp_train_step``
of dp 2 x gp 2 on two periodic boxes (mega route, the message kernels'
plain versions, so the second order runs through the exchanges), each
against the JAX step on a 4-device CPU mesh (its XLA path) at
test_torch_training's limits: the loss 1e-5 relative, each parameter's
mean gradient within 1e-4 of its largest element plus twice the port's
own change when the positions move by one f32 ulp; then ``run_train``
with ``gp_devices: 2`` and ``dp_devices: 2`` on periodic chains, on the
mega route: the replicas bit-identical, checkpoints from rank 0 alone, the
kernel layout written back equal to the one the JAX host functions size
over the same dataset, and the checkpoint served by HaloCalculator as by
the Calculator.  The v2-route and mixed-dataset refusals are the JAX
run_train's.  Both steps again with remat, bit for bit against the steps
without.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate as jax_collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data as jax_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.parallel import halo as jhalo
from xequinet_tpu.parallel.mesh import GP_AXIS, make_mesh
from xequinet_tpu.run.train import run_train as jax_run_train
from xequinet_tpu.utils.config import XequiConfig as JaxConfig
from xequinet_torch.convert import params_from_flax
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.store import create_dataset
from xequinet_torch.models.model import resolve_model
from xequinet_torch.run.train import run_train
from xequinet_torch.utils.config import XequiConfig

from tests._torch_halo_worker import run_pool

KW = dict(node_dim=16, node_irreps="16x0e+8x1o", embed_basis="one-hot", num_basis=8,
          cutoff=5.0, action_blocks=2, output_modes=["energy"])
BN, CHUNK = 24, 8
WE, WF = 1.0, 10.0
GRAD_TOL, GRAD_ULP_FACTOR = 1e-4, 2.0


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _chain(rng, n, cutoff=5.0):
    x = np.cumsum(rng.uniform(0.8, 1.6, size=n))
    pos = np.column_stack([x, rng.normal(size=(n, 2)) * 1.2])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    ei, _ = radius_graph_np(pos, cutoff)
    return z, pos, ei[:, np.argsort(ei[0], kind="stable")]


def _box(rng, n=96):
    lx = n * 1.1
    cell = np.diag([lx, 11.5, 11.5])
    x = (np.arange(n) * 1.1 + rng.normal(size=n) * 0.05) % lx
    pos = np.column_stack([x, rng.uniform(2.0, 9.5, size=(n, 2))])[rng.permutation(n)]
    z = rng.integers(1, 9, size=n).astype(np.int32)
    return z, pos, cell, np.array([True, True, True])


def _grad_tap():
    """An optax transformation that moves nothing and keeps the gradients
    it is given as its state: the JAX step's exact mean gradient."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _port_names(grads_tree):
    module, _, _ = resolve_model("xpainn", **KW)
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.array, grads_tree), module).items()}


def _check_grads(got, want):
    """test_torch_training's limit: each parameter's gradient within
    GRAD_TOL of its largest element plus twice the port's own change when
    the positions move by one f32 ulp."""
    for name, g_want in want.items():
        scale = max(float(np.abs(g_want).max()), 1e-30)
        ulp = float(np.abs(got["nudged_grads"][name] - got["grads"][name]).max()) / scale
        err = float(np.abs(got["grads"][name] - g_want).max()) / scale
        assert err <= GRAD_TOL + GRAD_ULP_FACTOR * ulp, (name, err, ulp)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    work = tmp_path_factory.mktemp("halo_train")
    rng = np.random.default_rng(1)
    jm, _, _ = jax_resolve_model("xpainn", **KW)
    cases, refs = {}, {}

    # one gp 4 step on a free chain
    z, pos, ei = _chain(rng, 160)
    b = {k: jnp.asarray(v) for k, v in jax_collate([JDatapoint(z, pos, edge_index=ei)]).items()}
    params = jax.jit(lambda d: jm.init(jax.random.PRNGKey(0), jax_edge_data(d)))(b)["params"]
    module, _, _ = resolve_model("xpainn", **KW)
    state = {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.array, params), module).items()}
    stacked, geom = jhalo.halo_partition(z, pos, ei, 4, halo=16)
    e_label = float(rng.normal()) * 5.0
    f_stacked = jhalo.scatter_labels_to_shards(
        stacked, geom, rng.normal(size=(len(z), 3)).astype(np.float32))
    tap = _grad_tap()
    step = jhalo.make_halo_train_step(lambda p, d: jm.apply({"params": p}, d),
                                      make_mesh(4, axis_names=(GP_AXIS,)), geom, tap, WE, WF)
    (_, grads), loss = step((params, tap.init(params)), stacked, jnp.asarray(e_label),
                            jnp.asarray(f_stacked))
    refs["gp"] = dict(loss=float(loss), grads=_port_names(grads))
    cases["gp"] = dict(kind="train_step", kw=KW, state=state, stacked=stacked, geom=geom,
                       e_label=e_label, f_label=f_stacked, we=WE, wf=WF)

    # one dp 2 x gp 2 step on two periodic boxes, the port on the mega route
    parts = []
    for _ in range(2):
        zb, posb, cell, pbc = _box(rng)
        st, g, perm, ws, _, _ = jhalo.prepare_halo_system(zb, posb, 5.0, 2, cell=cell, pbc=pbc,
                                                          halo=16, edge_cap=2048)
        f = rng.normal(size=(len(zb), 3)).astype(np.float32)[perm]
        parts.append((st, g, ws, jhalo.scatter_labels_to_shards(st, g, f)))
    sd, gd = jhalo.stack_halo_systems([p[0] for p in parts], [p[1] for p in parts])
    e_labels = rng.normal(size=2).astype(np.float32) * 5.0
    f_d = np.stack([p[3] for p in parts])
    wss = np.stack([p[2] for p in parts]).astype(np.float32)
    dstep = jhalo.make_halo_dp_train_step(
        lambda p, d: jm.apply({"params": p}, d),
        make_mesh(4, axis_names=("dp", GP_AXIS), shape=(2, 2)), gd, tap, WE, WF)
    (_, grads), loss = dstep((params, tap.init(params)), sd, e_labels, jnp.asarray(f_d), wss)
    refs["dp"] = dict(loss=float(loss), grads=_port_names(grads))
    flat = {k: v.reshape((4,) + v.shape[2:]) for k, v in sd.items()}
    flat_m, _, mxc = jhalo.apply_halo_kernel_layout(flat, gd, {"block_nodes": BN,
                                                               "chunk": CHUNK})
    sd_m = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in flat_m.items()}
    cases["dp"] = dict(kind="train_step", gp=2, stacked=sd_m, geom=gd, state=state,
                       kw=dict(KW, use_pallas_scatter="mega",
                               pallas_layout=(BN, CHUNK, gd["halo"], mxc)),
                       e_label=e_labels, f_label=f_d, wrap_shift=wss, we=WE, wf=WF)

    # the same two steps with remat (the gp 4 step under save_edge_agg, the
    # dp 2 x gp 2 step on the mega route recomputing everything)
    cases["gp_remat"] = dict(cases["gp"], kw=dict(KW, remat=True, remat_policy="save_edge_agg"))
    cases["dp_remat"] = dict(cases["dp"], kw=dict(cases["dp"]["kw"], remat=True))

    # run_train with gp_devices 2 x dp_devices 2 on periodic chains, mega
    db = str(work / "db")
    _make_db(db, rng, n_sys=6, n_atoms=80, periodic=True)
    refs["db"] = db
    cases["train"] = dict(kind="halo_train", config=_config(db, dp=2, gp=2, mega=True))
    return refs, run_pool(cases, work, 4)


def _make_db(path, rng, n_sys, n_atoms, periodic=False, mixed=False):
    """tests/test_train_halo.py's chains, periodic along x: 2 to validate."""
    dps = []
    for k in range(n_sys):
        xs = np.cumsum(rng.uniform(0.9, 1.5, size=n_atoms))
        pos = np.column_stack([xs, rng.normal(size=(n_atoms, 2)) * 1.1])
        z = rng.integers(1, 9, size=n_atoms).astype(np.int32)
        kw = {}
        if periodic or (mixed and k % 2 == 0):
            lx = float(pos[:, 0].max() + 1.2)
            kw = {"cell": np.diag([lx, 14.0, 14.0]), "pbc": np.array([True, False, False])}
            pos[:, 0] %= lx
            pos[:, 1:] += 7.0
        dps.append(Datapoint(z, pos, energy=float(rng.normal()) * 3.0,
                             forces=rng.normal(size=(n_atoms, 3)) * 0.1, **kw))
    create_dataset(path, dps, units={keys.TOTAL_ENERGY: "eV"},
                   split={"train": list(range(n_sys - 2)),
                          "valid": [n_sys - 2, n_sys - 1], "test": []})


def _config(db, dp, gp, mega=False, cls=XequiConfig):
    cfg = cls()
    cfg.model.model_name = "xpainn"
    cfg.model.model_kwargs = dict(KW, action_blocks=1, node_irreps="16x0e+8x1o+4x2e")
    if mega:
        cfg.model.model_kwargs.update(use_pallas_scatter="mega", pallas_layout=(24, 8, 0, 0))
    cfg.data.db_path = db
    cfg.data.targets = [keys.TOTAL_ENERGY, keys.FORCES]
    cfg.data.cutoff = 5.0
    t = cfg.trainer
    t.dp_devices, t.gp_devices = dp, gp
    t.max_epochs, t.warmup_epochs, t.max_lr, t.seed = 2, 0, 1e-3, 0
    t.run_name = "halo"
    t.losses_weight = {"energy": WE, "forces": WF}
    if cls is XequiConfig:
        t.device = "cpu"
    else:
        t.compile_cache = False
    return cfg


@pytest.mark.parametrize("case", ["gp", "dp"])
def test_halo_train_step_matches_jax(pool, case):
    """The loss (the same on every rank) and the mean gradient of one halo
    step (gp 4, plain route) and one dp 2 x gp 2 step (mega route) against
    the JAX steps' on 4-device meshes."""
    refs, outs = pool
    ref = refs[case]
    losses = {o[case]["loss"] for o in outs}
    assert len(losses) == 1, losses
    np.testing.assert_allclose(outs[0][case]["loss"], ref["loss"], rtol=1e-5)
    for o in outs[1:]:
        for n, g in o[case]["grads"].items():
            np.testing.assert_array_equal(g, outs[0][case]["grads"][n])
    _check_grads(outs[0][case], ref["grads"])


@pytest.mark.parametrize("case", ["gp", "dp"])
def test_halo_train_step_remat_bit_identical(pool, case):
    """The same halo steps with remat (the JAX halo train step takes the
    model's remat as it is): each rank's loss and mean gradients equal the
    step's without remat bit for bit.  The recomputed message blocks
    replay their halo exchanges in the same order on every rank."""
    _, outs = pool
    for o in outs:
        assert o[case + "_remat"]["loss"] == o[case]["loss"]
        for tag in ("grads", "nudged_grads"):
            for n, g in o[case][tag].items():
                np.testing.assert_array_equal(o[case + "_remat"][tag][n], g)


def _jax_layout(db, dp, gp):
    """The kernel layout the JAX run_halo_train's host sizing (run/train.py:222-302)
    derives over the dataset: JAX host functions only."""
    from xequinet_tpu.data.store import XDBDataset

    sets = [XDBDataset(db, split=s) for s in ("train", "valid")]
    dps = [ds[i] for ds in sets for i in range(len(ds))]
    nl = jhalo._ceil_to((max(len(d.atomic_numbers) for d in dps) + gp - 1) // gp, 8)
    bn = min(24, nl)
    halo = cap = sc = mx = None
    for _ in range(4):
        sig0 = (halo, cap, sc, mx)
        for d in dps:
            st, g, _, _, halo, cap = jhalo.prepare_halo_system(
                d.atomic_numbers, d.pos, 5.0, gp, cell=d.cell, pbc=d.pbc, margin=1.3,
                nl_exact=nl, min_halo=halo, min_edge_cap=cap)
            _, sc, mx = jhalo.apply_halo_kernel_layout(st, g, {"block_nodes": bn, "chunk": 8},
                                                       min_slot_cap=sc, min_max_chunks=mx)
        if (halo, cap, sc, mx) == sig0:
            break
    return (bn, 8, halo, mx)


def test_run_halo_train_dp_gp(pool, tmp_path):
    """run_train with gp_devices 2, dp_devices 2 on periodic chains on the
    mega route: the ranks end bit-identical, rank 0 alone wrote the last
    and best checkpoints, the written-back kernel layout is the JAX host
    sizing's, and the checkpoint served by a single-shard HaloCalculator
    (mega) equals the Calculator."""
    from xequinet_torch.interface.calculator import Calculator
    from xequinet_torch.parallel.halo import HaloCalculator

    refs, outs = pool
    res = [o["train"] for o in outs]
    for r in res[1:]:
        for n, p in r["params"].items():
            np.testing.assert_array_equal(p, res[0]["params"][n])
    assert all(np.isfinite(p).all() for p in res[0]["params"].values())
    assert {"halo_last.ckpt", "halo_best.ckpt"} <= set(res[0]["files"])
    assert not any(f.endswith(".ckpt") for r in res[1:] for f in r["files"])
    assert tuple(res[0]["model_kwargs"]["pallas_layout"]) == _jax_layout(refs["db"], 2, 2)
    ckpt = f"{res[0]['save_dir']}/halo_last.ckpt"
    rng = np.random.default_rng(7)
    x = np.cumsum(rng.uniform(0.9, 1.5, size=60))
    pos = np.column_stack([x, rng.normal(size=(60, 2)) * 1.1])
    z = rng.integers(1, 9, size=60).astype(np.int32)
    got = HaloCalculator(ckpt, pallas="mega", pallas_layout=(24, 8), use_ema=False,
                         device="cpu").calculate(z, pos)
    want = Calculator(ckpt, use_ema=False, device="cpu").calculate(z, pos)
    np.testing.assert_allclose(got[keys.TOTAL_ENERGY], want[keys.TOTAL_ENERGY], rtol=1e-5)
    err = np.abs(got[keys.FORCES] - want[keys.FORCES]).max()
    assert err <= 1e-4 * np.abs(want[keys.FORCES]).max()


@pytest.mark.parametrize("refusal", ["v2", "mixed"])
def test_halo_train_refusals_match_jax(tmp_path, refusal):
    """The v2 kernel route and a dataset mixing periodic and free systems
    are refused with the JAX run_train's errors, before any process group."""
    db = str(tmp_path / "db")
    _make_db(db, np.random.default_rng(2), n_sys=4, n_atoms=48, mixed=refusal == "mixed")
    msgs = []
    for cls, fn in ((JaxConfig, jax_run_train), (XequiConfig, run_train)):
        cfg = _config(db, dp=1, gp=2, cls=cls)
        cfg.trainer.save_dir = str(tmp_path / cls.__module__)
        if refusal == "v2":
            cfg.model.model_kwargs["use_pallas_scatter"] = "v2"
        with pytest.raises(ValueError, match="mega" if refusal == "v2" else
                           "homogeneous dataset") as err:
            fn(cfg)
        msgs.append(str(err.value))
    assert msgs[0].split(" or ")[0] == msgs[1].split(" or ")[0]
