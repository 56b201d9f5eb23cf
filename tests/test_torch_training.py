"""The port's training layer (xequinet_torch.training, run/train.py,
utils/config.py) against the JAX package on the CPU: schedules and
warmups against the optax ones, the optimizers against optax on identical
gradients, the loss and metrics, one whole train step from one parameter
tree and one batch, the force-loss gradient through the fused message
op's second order, and the entry point end to end (train, checkpoint,
resume, serve).

Tolerances (stated with each test): schedules 1e-6 of the base lr and
optimizer updates 1e-6 relative (f32 against f64 arithmetic); loss terms
1e-5 relative;
parameter gradients of a force loss 1e-4 of their largest element (a
gradient of a gradient through stacked blocks whose sums run in another
order, as the whole-model forces in test_torch_model.py).
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate as jax_collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models.model import make_apply_forward
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from xequinet_tpu.training import loss as jloss
from xequinet_tpu.training import lr_schedule as jls
from xequinet_tpu.training.trainer import make_step_core as jax_make_step_core
from xequinet_tpu.utils.config import XequiConfig as JXequiConfig
from xequinet_torch.convert import load_checkpoint, load_flax_params, params_from_flax
from xequinet_torch.data.batching import collate
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.store import create_dataset
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.run.inference import InferenceEngine, batch_to_device
from xequinet_torch.run.train import run_train
from xequinet_torch.training import loss as tloss
from xequinet_torch.training import lr_schedule as tls
from xequinet_torch.training.trainer import clip_by_global_norm, loss_and_grads, make_step_core
from xequinet_torch.utils.config import XequiConfig, load_config

IRREPS, NB, SD = "16x0e+8x1o+4x2e", 8, 16
WEIGHTS = {keys.TOTAL_ENERGY: 1.0, keys.FORCES: 10.0}


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _kw(**extra):
    kw = dict(node_dim=SD, node_irreps=IRREPS, embed_basis="one-hot", num_basis=NB,
              action_blocks=2, output_modes=["energy"])
    kw.update(extra)
    return kw


def _labelled(rng, n_mols=3, lo=5, hi=8):
    """(port datapoints, JAX datapoints) with energy and force labels."""
    dps_t, dps_j = [], []
    for _ in range(n_mols):
        n = int(rng.integers(lo, hi + 1))
        z = rng.integers(1, 9, n).astype(np.int32)
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        e, f = float(rng.normal()), rng.normal(size=(n, 3))
        dps_t.append(Datapoint(z, pos, edge_index=ei, energy=e, forces=f))
        dps_j.append(JDatapoint(z, pos, edge_index=ei, energy=e, forces=f))
    return dps_t, dps_j


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
def test_load_config_overrides_without_yaml(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "yaml", None)  # importing yaml now fails
    cfg = load_config(overrides={"model": {"model_kwargs": {"node_dim": 32}},
                                 "trainer": {"max_epochs": 2, "device": "cpu"},
                                 "data": {"targets": ["energy", "forces"]}})
    assert cfg.model.model_kwargs == {"node_dim": 32}
    assert cfg.trainer.max_epochs == 2 and cfg.trainer.device == "cpu"
    assert cfg.data.targets == ["energy", "forces"]
    with pytest.raises(KeyError, match="trainer.nonexistent_key"):
        load_config(overrides={"trainer": {"nonexistent_key": 3}})
    # YAML files are read by the port's own reader: no PyYAML needed
    path = tmp_path / "c.yaml"
    path.write_text("trainer:\n  max_epochs: 3  # three\ndata:\n  targets: [energy]\n")
    cfg = load_config(str(path))
    assert cfg.trainer.max_epochs == 3 and cfg.data.targets == ["energy"]
    with pytest.raises(FileNotFoundError):
        load_config(str(tmp_path / "missing.yaml"))
    # the JAX package's schema, field for field (the port adds trainer.device)
    import dataclasses

    for sec in ("model", "trainer", "data"):
        want = {f.name: f.default for f in dataclasses.fields(getattr(JXequiConfig(), sec))}
        got = {f.name: f.default for f in dataclasses.fields(getattr(XequiConfig(), sec))}
        got.pop("device", None)
        assert got == want, sec


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------
SCHEDULES = [
    ("cosine_annealing", {}), ("cosine_annealing", {"T_max": 30, "eta_min": 1e-5}),
    ("cosine_restarts", {"T_0": 7, "T_mult": 2}), ("exponential", {"gamma": 0.97}),
    ("step", {"step_size": 9, "gamma": 0.5}), ("linear_decay", {"power": 2.0, "end_lr": 1e-5}),
    ("plateau", {}),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULES)
@pytest.mark.parametrize("warmup", ["linear", "untuned_linear", "exponential", "none"])
def test_schedules_match_optax(name, kwargs, warmup):
    """Every schedule after every warmup over 50 steps, including
    join_schedules' offset after the boundary; within 1e-6 of the base lr
    (optax evaluates in f32, so its small late values carry f32 rounding
    of the cosine)."""
    args = (name, 1e-3, 40)
    got = tls.resolve_lr_schedule(*args, warmup_scheduler=warmup, warmup_steps=5, **kwargs)
    want = jls.resolve_lr_schedule(*args, warmup_scheduler=warmup, warmup_steps=5, **kwargs)
    for step in range(50):
        assert abs(got(step) - float(want(step))) <= 1e-6 * args[1], step


def test_plateau_scheduler_matches():
    got = tls.PlateauScheduler(factor=0.5, patience=2, smoothing_factor=0.3)
    want = jls.PlateauScheduler(factor=0.5, patience=2, smoothing_factor=0.3)
    rng = np.random.default_rng(0)
    for m in np.concatenate([np.linspace(1.0, 0.5, 5), 0.5 + 0.01 * rng.random(12)]):
        assert got.step(float(m)) == want.step(float(m))
    assert got.state_dict() == want.state_dict()


@pytest.mark.parametrize("name", ["adam", "adamw", "nadam", "radam"])
def test_optimizers_match_optax(name):
    """The torch optimizer against the optax one on identical gradients
    (magnitudes 1e-6 to 1), 8 steps at a scheduled lr (radam rectifies
    from step 6): the parameters' change within 1e-6 of the largest change,
    plus two f32 ulps of the stored parameters.  For radam 1e-4: optax
    evaluates rho = rho_inf - 2 t b2^t / (1 - b2^t) in f32, a difference of
    two numbers near 2000 that leaves rho (about 5 at the first rectified
    steps) with an absolute error near 1e-4, and r grows as sqrt(rho - 4)."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(4, 5)).astype(np.float32),
          "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 10.0 ** rng.integers(-6, 1, v.shape))
              .astype(np.float32) for k, v in p0.items()} for _ in range(8)]
    sched = jls.resolve_lr_schedule("cosine_annealing", 1e-2, 8, warmup_steps=2)
    opt = jls.resolve_optimizer(name, sched)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = tls.resolve_optimizer(name, list(tp.values()))
    tsched = tls.resolve_lr_schedule("cosine_annealing", 1e-2, 8, warmup_steps=2)
    for step, g in enumerate(grads):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in g.items():
            tp[k].grad = torch.as_tensor(v)
        tls.set_lr(topt, tsched(step))
        topt.step()
    rel = 1e-4 if name == "radam" else 1e-6
    for k in p0:
        want = np.asarray(jp[k], np.float64) - p0[k]
        got = tp[k].detach().double().numpy() - p0[k]
        ulps = 2 * np.finfo(np.float32).eps * float(np.abs(p0[k]).max())
        assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max()) + ulps, k


@pytest.mark.parametrize("norm", [1e-14, 1e-7, 0.5, 5.0, 6.6e3])
def test_clip_matches_jax_formula(norm):
    """``clip_by_global_norm`` against the JAX step's clip
    (``optax.global_norm`` and min(1, clip / max(norm, 1e-12))) within two
    f32 ulps, at norms below the floor, near 1e-6 (where
    ``clip_grad_norm_``'s clip / (norm + 1e-6) would differ by ~10x), under,
    at and above the clip.  Clips at 5.0 and at 1e-8."""
    rng = np.random.default_rng(1)
    raw = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    scale = norm / math.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in raw))
    raw = [(g * scale).astype(np.float32) for g in raw]
    for clip in (5.0, 1e-8):
        got = [torch.as_tensor(g).clone() for g in raw]
        clip_by_global_norm(got, clip)
        jg = [jnp.asarray(g) for g in raw]
        js = jnp.minimum(1.0, clip / jnp.maximum(optax.global_norm(jg), 1e-12))
        for a, b in zip(got, jg):
            want = np.asarray(b * js)
            tol = 2 * np.finfo(np.float32).eps * float(np.abs(want).max())
            assert float(np.abs(a.numpy() - want).max()) <= tol, (norm, clip)


# ---------------------------------------------------------------------------
# loss and metrics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lossfn", ["l1", "l2", "smoothl1", "matloss"])
def test_loss_and_metric_match_jax(rng, lossfn):
    """WeightedLoss and ErrorMetric on one crystal batch with invented
    predictions: energy, energy per atom, forces, virial and stress."""
    dps = []
    for _ in range(3):
        n = int(rng.integers(3, 6))
        cell = np.diag(rng.uniform(3.0, 4.0, 3)) + rng.normal(size=(3, 3)) * 0.1
        pos = rng.uniform(0, 1, size=(n, 3)) @ cell
        pbc = np.array([True] * 3)
        ei, offs = radius_graph_pbc_np(pos, cell, pbc, 3.0)
        dps.append(JDatapoint(rng.integers(1, 9, n), pos, cell=cell, pbc=pbc, edge_index=ei,
                              cell_offsets=offs, energy=float(rng.normal()),
                              forces=rng.normal(size=(n, 3)), virial=rng.normal(size=(3, 3))))
    batch = jax_collate(dps)
    pred = {keys.TOTAL_ENERGY: rng.normal(size=batch[keys.TOTAL_ENERGY].shape),
            keys.FORCES: rng.normal(size=batch[keys.FORCES].shape),
            keys.VIRIAL: rng.normal(size=batch[keys.VIRIAL].shape)}
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    w = {keys.TOTAL_ENERGY: 1.0, keys.ENERGY_PER_ATOM: 0.5, keys.FORCES: 10.0,
         keys.VIRIAL: 0.1, keys.STRESS: 2.0}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = batch_to_device(batch, "cpu")
    jpred = {k: jnp.asarray(v) for k, v in pred.items()}
    tpred = {k: torch.as_tensor(v) for k, v in pred.items()}
    want_total, want = jloss.WeightedLoss(lossfn, **w)(jpred, jb)
    got_total, got = tloss.WeightedLoss(lossfn, **w)(tpred, tb)
    _close(got_total, want_total, 1e-5)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], 1e-5, k)
    props = (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL)
    want_m = jloss.ErrorMetric(*props)(jpred, jb)
    got_m = tloss.ErrorMetric(*props)(tpred, tb)
    assert sorted(got_m) == sorted(want_m)
    acc_t, acc_j = tloss.MetricAccumulator(), jloss.MetricAccumulator()
    acc_t.update(got_m)
    acc_j.update(want_m)
    for k, r in acc_j.compute().items():
        assert acc_t.compute()[k]["count"] == r["count"], k
        for m in ("mae", "rmse"):
            assert math.isclose(acc_t.compute()[k][m], r[m], rel_tol=1e-5), (k, m)


# ---------------------------------------------------------------------------
# one train step against the JAX package
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_step():
    """One JAX train step (plain route, f32) from one parameter tree on one
    batch: loss terms and gradients by jax.value_and_grad, the updated
    parameters and EMA by the JAX trainer's own step core (AdamW, cosine
    schedule with linear warmup, grad clip 5.0, EMA 0.999, bench.py's
    recipe)."""
    dps_t, dps_j = _labelled(np.random.default_rng(5))
    batch = jax_collate(dps_j)
    m, extra, _ = jax_resolve_model("xpainn", **_kw())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(lambda d: m.init(jax.random.PRNGKey(0), compute_edge_data(d)))(jb)["params"]
    apply_forward = make_apply_forward(m, extra)
    lossfn = jloss.WeightedLoss("l2", **WEIGHTS)

    def loss_of(p):
        total, losses = lossfn(apply_forward(p, jb, True, False), jb)
        return total, losses

    (loss, losses), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    sched = jls.resolve_lr_schedule("cosine_annealing", 1e-3, 100, warmup_steps=2)
    opt = jls.resolve_optimizer("adamw", sched)
    core = jax_make_step_core(apply_forward, lossfn, opt, True, False, 5.0, 0.999,
                              jloss.ErrorMetric(keys.TOTAL_ENERGY, keys.FORCES))
    state = (params, opt.init(params), jax.tree_util.tree_map(jnp.copy, params))
    (new_p, new_opt, new_ema), step_loss, _ = jax.jit(core)(state, jb, jnp.asarray(1.0))
    is_adam = lambda s: isinstance(s, optax.ScaleByAdamState)
    (adam,) = [s for s in jax.tree_util.tree_leaves(new_opt, is_leaf=is_adam) if is_adam(s)]
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(dps=dps_t, params=as_np(params), loss=float(loss),
                losses={k: float(v) for k, v in losses.items()}, grads=as_np(grads),
                new_params=as_np(new_p), new_ema=as_np(new_ema), mu=as_np(adam.mu),
                step_loss=float(step_loss), lr0=float(sched(0)))


def _port_model(params):
    module, extra, _ = resolve_model("xpainn", **_kw())
    load_flax_params(module, params)
    return module, extra


def _port_grads(module, extra, batch, pos_scale=1.0):
    b = dict(batch)
    b[keys.POSITIONS] = b[keys.POSITIONS] * pos_scale
    named = list(module.named_parameters())
    loss, losses, _, grads = loss_and_grads(
        make_forward(module, extra, create_graph=True), tloss.WeightedLoss("l2", **WEIGHTS),
        [p for _, p in named], b, True, False)
    return loss.detach(), losses, {n: g for (n, _), g in zip(named, grads)}


def test_train_step_matches_jax(jax_step):
    """One step from JAX's weights on JAX's batch, plain route, f32.

    Loss and its energy and force terms within 1e-5 relative.  Parameter
    gradients: within 1e-4 of each one's largest element plus twice the
    port's own change of that gradient when the positions move by one f32
    ulp (x (1 + 1e-7)).  At random weights the force loss's gradient is
    that ill-conditioned: the equivariant LayerNorm of the first update
    block divides by the small RMS of the first messages' equivariant
    features, so every f32 rounding of the forward moves some gradients by
    up to 1e-3 of their largest element, JAX's roundings as much as the
    port's (the measured JAX gap is about 0.65 of that change).

    Then one AdamW + clip + EMA step.  The clip: the gradient's global
    norm (about 6.6e3) is above 5.0, so both packages' clipped gradients,
    read from Adam's first moment ((1 - b1) g after one step), have norm
    5.0 within 1e-5, and each parameter's agrees with JAX's within the
    gradient limit above.  Adam's first step is lr g / (|g| + eps), so an
    element whose gradient the limit does not resolve can move anywhere in
    [-lr, lr]; where it is resolved (|g| above 10 times the limit) the
    port's update has the sign of -g and the parameters agree with JAX's
    within 1e-6 lr plus two f32 ulps of the old or new parameter.  The EMA is
    0.999 e + 0.001 p of the port's own new parameters within two ulps,
    and equals JAX's EMA within two ulps where the update is resolved."""
    module, extra = _port_model(jax_step["params"])
    batch = batch_to_device(collate(jax_step["dps"]), "cpu")
    loss, losses, grads = _port_grads(module, extra, batch)
    assert math.isclose(float(loss), jax_step["loss"], rel_tol=1e-5)
    for k, v in jax_step["losses"].items():
        assert math.isclose(float(losses[k].detach()), v, rel_tol=1e-5), k
    _, _, nudged = _port_grads(module, extra, batch, 1.0 + 1e-7)
    want_g = params_from_flax(jax_step["grads"], module)
    limit = {}
    for name, g in grads.items():
        scale = max(float(g.abs().max()), 1e-30)
        limit[name] = 1e-4 + 2 * float((nudged[name] - g).abs().max()) / scale
        assert float((g - want_g[name]).abs().max()) <= limit[name] * scale, name

    named = list(module.named_parameters())
    params = [p for _, p in named]
    sched = tls.resolve_lr_schedule("cosine_annealing", 1e-3, 100, warmup_steps=2)
    opt = tls.resolve_optimizer("adamw", params)
    ema = [p.detach().clone() for p in params]
    core = make_step_core(make_forward(module, extra, create_graph=True),
                          tloss.WeightedLoss("l2", **WEIGHTS), params, opt, sched, True, False,
                          5.0, 0.999, tloss.ErrorMetric(keys.TOTAL_ENERGY, keys.FORCES))
    step_loss, _ = core(batch, 0, 1.0, ema)
    assert math.isclose(float(step_loss), jax_step["step_loss"], rel_tol=1e-5)
    lr = jax_step["lr0"]
    want_p = params_from_flax(jax_step["new_params"], module)
    want_e = params_from_flax(jax_step["new_ema"], module)
    old = params_from_flax(jax_step["params"], module)
    b1 = opt.defaults["betas"][0]
    clipped = {name: opt.state[p]["exp_avg"] / (1 - b1) for name, p in named}
    want_c = {k: v / (1 - b1) for k, v in params_from_flax(jax_step["mu"], module).items()}
    norm = lambda d: float(torch.linalg.vector_norm(torch.stack([v.norm() for v in d.values()])))
    assert math.isclose(norm(clipped), 5.0, rel_tol=1e-5)
    assert math.isclose(norm(want_c), 5.0, rel_tol=1e-5)
    eps32, n_resolved = float(np.finfo(np.float32).eps), 0
    for (name, p), e in zip(named, ema):
        c = clipped[name]
        assert float((c - want_c[name]).abs().max()) <= limit[name] * float(c.abs().max()), name
        ulps = 2 * eps32 * max(float(old[name].abs().max()), float(p.detach().abs().max()))
        step_p = p.detach() - old[name]
        ema_of_port = (0.999 * old[name].double() + 0.001 * p.detach().double()).float()
        assert float((e - ema_of_port).abs().max()) <= ulps, name
        g = want_g[name]
        resolved = g.abs() > 10 * limit[name] * g.abs().max()
        n_resolved += int(resolved.sum())
        assert torch.equal(torch.sign(step_p[resolved]), -torch.sign(g[resolved])), name
        d = (p.detach() - want_p[name]).abs()[resolved]
        assert d.numel() == 0 or float(d.max()) <= 1e-6 * lr + ulps, name
        d = (e - want_e[name]).abs()[resolved]
        assert d.numel() == 0 or float(d.max()) <= ulps, name
    assert n_resolved > sum(p.numel() for _, p in named) // 2


def test_mega_route_force_loss_gradients_match_plain_route(jax_step):
    """The force loss's parameter gradient through the fused message op's
    nested autograd (FusedMessage -> FusedMessageBwd -> plain second order
    on the CPU) equals the plain message route's, 1e-4 of the largest
    element."""
    layout = {"block_nodes": 8, "chunk": 8, "pad_nodes": 16, "max_chunks": 16}
    lossfn = tloss.WeightedLoss("l2", **WEIGHTS)
    out = []
    for mega in (False, True):
        kw = _kw(use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16)) if mega else _kw()
        module, extra, _ = resolve_model("xpainn", **kw)
        load_flax_params(module, jax_step["params"])
        batch = batch_to_device(collate(jax_step["dps"], kernel_layout=layout if mega else None),
                                "cpu")
        named = list(module.named_parameters())
        loss, _, _, grads = loss_and_grads(make_forward(module, extra, create_graph=True),
                                           lossfn, [p for _, p in named], batch, True, False)
        out.append((float(loss.detach()), dict(zip([n for n, _ in named], grads))))
    assert math.isclose(out[0][0], out[1][0], rel_tol=1e-5)
    for name, g in out[0][1].items():
        _close(out[1][1][name], g, 1e-4, name)


def test_train_step_runs_each_message_stage_as_often_as_jax(monkeypatch):
    """One energy + force train step of a 3-block mega model: the port calls
    the op's forward, first-order and second-order stages (the dispatch
    that takes the kernels on the card) as often as the
    JAX package's step runs its three kernels (counted as pallas_calls in
    its jaxpr by their outputs: 1 forward, 3 backward, 4 second order),
    3 + 6 + 3: each block's backward runs for the forces and again in the
    parameter-gradient pass."""
    import collections

    from xequinet_torch.ops import fused_message as fm
    from xequinet_tpu.data.batching import collate as jcollate

    layout = {"block_nodes": 8, "chunk": 8, "pad_nodes": 16, "max_chunks": 16}
    kw = _kw(action_blocks=3, use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16))
    dps_t, dps_j = _labelled(np.random.default_rng(2), n_mols=2)
    jb = {k: jnp.asarray(v) for k, v in jcollate(dps_j, n_nodes=40, kernel_layout=layout).items()}
    m, extra, _ = jax_resolve_model("xpainn", **kw)
    params = jax.eval_shape(lambda d: m.init(jax.random.PRNGKey(0), compute_edge_data(d)),
                            jb)["params"]
    lossfn = jloss.WeightedLoss("l2", **WEIGHTS)
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p: lossfn(make_apply_forward(m, extra)(p, jb, True, False), jb)[0]))(params)
    want = collections.Counter()

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "pallas_call":
                want[{1: "message_fwd", 3: "message_bwd", 4: "message_bwd2"}[len(e.outvars)]] += 1
            for v in e.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr.jaxpr)
    got = collections.Counter()
    for stage, fn in (("message_fwd", "message_forward"), ("message_bwd", "message_backward"),
                      ("message_bwd2", "plain_message_bwd2")):
        orig = getattr(fm, fn)

        def counted(*a, _orig=orig, _stage=stage, **k):
            got[_stage] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(fm, fn, counted)
    module, extra_t, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    batch = batch_to_device(collate(dps_t, n_nodes=40, kernel_layout=layout), "cpu")
    named = list(module.named_parameters())
    loss_and_grads(make_forward(module, extra_t, create_graph=True),
                   tloss.WeightedLoss("l2", **WEIGHTS), [p for _, p in named], batch, True,
                   False)
    assert dict(want) == {"message_fwd": 3, "message_bwd": 6, "message_bwd2": 3}
    assert dict(got) == dict(want)


def test_force_loss_second_derivative_finite_on_padding_edges(rng):
    """The double-where guard of compute_edge_data: padding edges (zero
    vectors between one padding node and itself) keep the force loss's
    parameter gradient finite."""
    dps, _ = _labelled(rng, n_mols=2)
    batch = collate(dps, n_nodes=32, n_edges=256, n_graphs=4)
    assert not batch[keys.EDGE_MASK].all()
    module, extra, _ = resolve_model("xpainn", **_kw())
    init_params(module, seed=1)
    named = list(module.named_parameters())
    loss, _, out, grads = loss_and_grads(
        make_forward(module, extra, create_graph=True), tloss.WeightedLoss("l2", **WEIGHTS),
        [p for _, p in named], batch_to_device(batch, "cpu"), True, False)
    assert torch.isfinite(loss) and torch.isfinite(out[keys.FORCES]).all()
    for (name, _), g in zip(named, grads):
        assert torch.isfinite(g).all(), name


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------
def _dataset(path, rng, n=24):
    dps = []
    for _ in range(n):
        k = int(rng.integers(4, 8))
        pos = rng.normal(size=(k, 3)) * 1.5
        dps.append(Datapoint(rng.integers(1, 5, k), pos, energy=float(rng.normal()),
                             forces=rng.normal(size=(k, 3))))
    create_dataset(path, dps, units={})
    return dps


def test_run_train_cpu_trains_checkpoints_resumes_serves(tmp_path, rng):
    dps = _dataset(tmp_path / "db", rng)
    over = {
        "model": {"model_kwargs": _kw(use_pallas_scatter="mega", pallas_layout=(8, 8, 16, 16))},
        "data": {"db_path": str(tmp_path / "db"), "targets": ["energy", "forces"],
                 "batch_size": 4, "valid_batch_size": 4, "max_nodes": 40, "max_edges": 256},
        "trainer": {"max_epochs": 2, "warmup_epochs": 1, "lossfn": "l2",
                    "losses_weight": WEIGHTS, "ema_decay": 0.9, "grad_clip": 5.0,
                    "max_lr": 2e-3, "save_dir": str(tmp_path / "out"), "best_k": 2,
                    "log_steps": 1000, "seed": 0},
    }
    tr = run_train(load_config(overrides=over), device="cpu")
    out = tmp_path / "out"
    last = load_checkpoint(str(out / "xequinet_last.ckpt"))
    assert last["epoch"] == 1
    assert set(last) >= {"model", "ema_model", "opt_state", "config", "epoch", "loss",
                         "loss2file", "plateau", "stoppings"}
    assert len(list(out.glob("xequinet_ep*.ckpt"))) == 2  # best_k
    # the training loss fell from the first epoch to the second
    log = (out / "loss.log").read_text()
    train_loss = [float(x.split()[0]) for x in log.split("train-loss ")[1:]]
    assert len(train_loss) == 2 and train_loss[1] < train_loss[0], train_loss
    # resume: one more epoch from the last checkpoint
    over["trainer"].update(max_epochs=3, resume=True, ckpt_file=str(out / "xequinet_last.ckpt"))
    tr2 = run_train(load_config(overrides=over), device="cpu")
    assert tr2.epoch == 2 and tr2.step > tr.step
    assert "resumed from" in (out / "loss.log").read_text()
    # served from the last checkpoint (its EMA weights)
    eng = InferenceEngine(str(tmp_path / "out" / "xequinet_last.ckpt"), device="cpu")
    res = eng.predict(dps[:3])
    assert all(np.isfinite(r[keys.FORCES]).all() for r in res)


def test_trainer_freezing_f32_switch_early_stop_and_jax_checkpoint(tmp_path, rng):
    """``finetune_modules`` freezes everything else (the output head alone
    moves), ``f32_finetune_epochs`` switches a bf16 model to f32 for the
    last epoch (its config and later checkpoints embed f32), an early
    stopping lower bound ends the run after one epoch, and a checkpoint
    written by the JAX trainer starts the port's Trainer (``ckpt_file``
    without ``resume``)."""
    from xequinet_tpu.training.trainer import save_checkpoint as jax_save

    _dataset(tmp_path / "db", rng, n=12)
    kw = _kw(compute_dtype="bfloat16", update_compute_dtype="bfloat16")
    over = {
        "model": {"model_kwargs": kw},
        "data": {"db_path": str(tmp_path / "db"), "targets": ["energy", "forces"],
                 "batch_size": 4, "valid_batch_size": 4},
        "trainer": {"max_epochs": 2, "warmup_epochs": 1, "lossfn": "l2", "max_lr": 1e-2,
                    "save_dir": str(tmp_path / "a"), "log_steps": 1000, "seed": 0,
                    "finetune_modules": ["blocks_5"], "f32_finetune_epochs": 1},
    }
    tr = run_train(load_config(overrides=over), device="cpu")
    start, _, _ = resolve_model("xpainn", **kw)
    init_params(start, seed=0)
    for name, p0 in start.state_dict().items():
        moved = not torch.equal(tr.module.state_dict()[name], p0)
        assert moved == name.startswith("blocks.5."), name
    assert tr.config.model.model_kwargs["compute_dtype"] == "float32"
    last = load_checkpoint(str(tmp_path / "a" / "xequinet_last.ckpt"))
    assert last["config"]["model_kwargs"]["update_compute_dtype"] == "float32"

    m, _, _ = jax_resolve_model("xpainn", **_kw())
    b = {k: jnp.asarray(v) for k, v in jax_collate(_labelled(rng, 2)[1]).items()}
    params = jax.jit(lambda d: m.init(jax.random.PRNGKey(3), compute_edge_data(d)))(b)["params"]
    ckpt = str(tmp_path / "jax.ckpt")
    jax_save(ckpt, params, {"model_name": "xpainn", "model_kwargs": _kw()})
    over["model"]["model_kwargs"] = _kw()
    over["trainer"] = {"max_epochs": 3, "save_dir": str(tmp_path / "b"), "log_steps": 1000,
                       "ckpt_file": ckpt, "max_lr": 0.0, "warmup_scheduler": "none",
                       "early_stoppings": {"energy": {"lower_bound": 1e9}}}
    tr = run_train(load_config(overrides=over), device="cpu")
    assert tr.epoch == 0  # stopped after the first epoch
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params), tr.module)
    for name, t in tr.module.state_dict().items():  # lr 0: still JAX's weights
        assert torch.equal(t, want[name]), name


def test_run_train_refusals(tmp_path, rng):
    """Halo training (gp_devices > 1) refuses the v2 route, which is not
    halo-aware (here through run_train_from_args and a YAML config), and a
    process group smaller than dp x gp; the default device raises without
    a card.  Data-parallel and halo training run in
    tests/test_torch_parallel.py and tests/test_torch_halo_train.py."""
    import argparse

    from xequinet_torch.run.train import run_train_from_args

    (tmp_path / "c.yaml").write_text(
        "model:\n  model_kwargs:\n    use_pallas_scatter: v2\n"
        "trainer:\n  gp_devices: 2\n  device: cpu\n")
    with pytest.raises(ValueError, match="not halo-aware"):
        run_train_from_args(argparse.Namespace(config=str(tmp_path / "c.yaml")))
    _dataset(tmp_path / "db", rng, n=6)
    cfg = XequiConfig()
    cfg.data.db_path = str(tmp_path / "db")
    cfg.trainer.gp_devices = 4
    cfg.trainer.save_dir = str(tmp_path / "out")
    with pytest.raises(ValueError, match="process group has 1"):
        run_train(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_train(XequiConfig())
