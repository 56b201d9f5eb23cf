"""Rematerialization (``remat``, ``remat_policy``; xequinet_torch/models/
remat.py) against the JAX package's ``nn.remat`` on the CPU, at 16
channels of ``16x0e+8x1o+4x2e``.

* The port with remat against the JAX package with the same remat, on the
  plain, v2 and mega routes under both policies: energy and forces within
  1e-5 of the largest magnitude, the force loss's parameter gradients
  within test_torch_training.py's limit (1e-4 of each gradient's largest
  element plus twice the port's own change under a one-ulp move of the
  positions).  JAX's Pallas kernels cannot run under ``jax.checkpoint``
  in interpret mode (its callbacks carry effects that remat refuses), so
  the JAX routes run through their own XLA references here
  (``xla_reference``, ``reference_impl``), whose derivatives are the
  kernels' custom VJPs.
* The port with remat against itself without remat: energies, forces and
  the force loss's parameter gradients bit for bit, XMatNet too.
* The message stages per force call and per train step (the dispatch that
  launches the kernels on the card) against the ``pallas_call``s of the
  JAX program with the same remat, read from its jaxpr; a plain
  ``torch.utils.checkpoint`` around each block runs other counts.
* XPaiNN-Ewald with remat (the Ewald blocks are not wrapped) against JAX,
  and a JAX checkpoint trained with ``remat: true`` served by the port.
"""

import collections
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate as jcollate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models.model import make_apply_forward
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops import pallas_message as jpm
from xequinet_tpu.ops import pallas_scatter_v2 as jps
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.training import loss as jloss
from xequinet_tpu.training.trainer import save_checkpoint
from xequinet_tpu.utils.config import ModelConfig, config_to_dict
from xequinet_torch.convert import load_flax_params
from xequinet_torch.data.batching import collate
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models import remat as tremat
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.models.properties import compute_edge_data as compute_edge_data_t
from xequinet_torch.models.properties import make_forward
from xequinet_torch.ops import fused_message as fm
from xequinet_torch.ops import gather_scatter_v2 as gs2
from xequinet_torch.run.inference import InferenceEngine, batch_to_device
from xequinet_torch.training import loss as tloss
from xequinet_torch.training.trainer import loss_and_grads

from .test_torch_model import _crystals

IRREPS, NB, SD = "16x0e+8x1o+4x2e", 8, 16
LAYOUT = {"block_nodes": 8, "chunk": 8, "pad_nodes": 16, "max_chunks": 16}
WEIGHTS = {keys.TOTAL_ENERGY: 1.0, keys.FORCES: 10.0}
ROUTES = {"plain": {}, "v2": {"use_pallas_scatter": "v2", "pallas_layout": (8, 8, 16, 16)},
          "mega": {"use_pallas_scatter": "mega", "pallas_layout": (8, 8, 16, 16)}}
POLICIES = ("full", "save_edge_agg")


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture
def one_thread():
    """The bit-for-bit comparisons run on one CPU thread: with more, MKL may
    pick the threads of a product at run time from the machine's load, and
    then two identical calls can sum in another order."""
    torch.set_num_threads(1)


def _kw(route="plain", policy=None, blocks=2, **extra):
    kw = dict(node_dim=SD, node_irreps=IRREPS, embed_basis="one-hot", num_basis=NB,
              action_blocks=blocks, output_modes=["energy"], **ROUTES[route], **extra)
    if policy is not None:
        kw.update(remat=True, remat_policy=policy)
    return kw


def _labelled(seed, n_mols=3):
    """(port datapoints, JAX datapoints) with energy and force labels."""
    rng = np.random.default_rng(seed)
    dps_t, dps_j = [], []
    for _ in range(n_mols):
        n = int(rng.integers(5, 9))
        z = rng.integers(1, 9, n).astype(np.int32)
        pos = rng.normal(size=(n, 3)) * 1.5
        ei, _ = radius_graph_np(pos, 5.0)
        e, f = float(rng.normal()), rng.normal(size=(n, 3))
        dps_t.append(Datapoint(z, pos, edge_index=ei, energy=e, forces=f))
        dps_j.append(JDatapoint(z, pos, edge_index=ei, energy=e, forces=f))
    return dps_t, dps_j


def _layout(route):
    return None if route == "plain" else LAYOUT


def _jax_references(monkeypatch):
    """The JAX message routes through their XLA references (the kernels'
    own test oracles; their autodiff is the kernels' custom VJPs)."""

    def message(x_cat, edge_feat, wf_aug, slot_meta, edge_mask, irreps_str, num_basis,
                node_dim, n_out, block_nodes, chunk, window, max_chunks, mm_dtype,
                kernel_bwd=True):
        return jpm.xla_reference(x_cat, edge_feat, wf_aug, slot_meta[2], slot_meta[3],
                                 edge_mask, irreps_str, num_basis, node_dim, n_out,
                                 compute_dtype=mm_dtype)

    def gather_scatter(x, w, src_g, slot_meta, n_out, *layout):
        return jps.reference_impl(x, src_g, slot_meta[2], w, n_out)

    monkeypatch.setattr(jpm, "fused_message", message)
    monkeypatch.setattr(jps, "fused_gather_scale_scatter", gather_scatter)


def _flax_params(model, kw, jb, seed=3):
    """A flax parameter tree of ``model`` holding the port's seeded weights
    (``init_params``): the tree's structure from ``jax.eval_shape``, each
    leaf mapped as ``convert.params_from_flax`` maps it (a jitted flax
    init takes seconds more)."""
    from xequinet_torch.convert import _flatten

    m, _, _ = jax_resolve_model(model, **kw)
    template = jax.eval_shape(lambda d: m.init(jax.random.PRNGKey(0), compute_edge_data(d)),
                              jb)["params"]
    module, _, _ = resolve_model(model, **kw)
    sd = init_params(module, seed=seed).state_dict()
    tree: dict = {}
    for path, leaf in _flatten(template):
        parts = list(path)
        if parts[0].startswith("blocks_"):
            parts[0:1] = ["blocks", parts[0][len("blocks_"):]]
        dense = parts[-1] == "kernel" and parts[-2].startswith("Dense_")
        if dense or (parts[-1] == "scale" and parts[-2].startswith("LayerNorm_")):
            parts[-1] = "weight"
        arr = sd[".".join(parts)].numpy()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if dense else arr).astype(leaf.dtype)
    return tree


@pytest.fixture(scope="module")
def jax_params():
    """One flax parameter tree of the two-block model (every route and
    policy shares its structure)."""
    _, dps_j = _labelled(5)
    jb = {k: jnp.asarray(v) for k, v in jcollate(dps_j, n_nodes=40).items()}
    return _flax_params("xpainn", _kw(), jb)


_JAX_RUNS: dict = {}


def _jax_run(kw, params, dps_j, route, model="xpainn", virial=False, grads=True):
    """(params, outputs, force-loss gradients) of the JAX program, in one
    jit (``params`` None: :func:`_flax_params`)."""
    jb = {k: jnp.asarray(v) for k, v in
          jcollate(dps_j, n_nodes=40, kernel_layout=_layout(route)).items()}
    m, extra, _ = jax_resolve_model(model, **kw)
    if params is None:
        params = _flax_params(model, kw, jb)
    fwd = make_apply_forward(m, extra)
    lossfn = jloss.WeightedLoss("l2", **WEIGHTS)

    def loss(p):
        out = fwd(p, jb, True, virial)
        return lossfn(out, jb)[0], out

    if grads:
        (_, out), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    else:
        out, g = jax.jit(lambda p: fwd(p, jb, True, virial))(params), None
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return as_np(params), as_np(out), None if g is None else as_np(g)


def _port_run(kw, params, dps_t, route, model="xpainn", pos_scale=1.0, virial=False):
    """(outputs, {name: force-loss gradient}) of the port."""
    module, extra, _ = resolve_model(model, **kw)
    if params is None:
        init_params(module, seed=3)
    else:
        load_flax_params(module, params)
    batch = batch_to_device(collate(dps_t, n_nodes=40, kernel_layout=_layout(route)), "cpu")
    batch[keys.POSITIONS] = batch[keys.POSITIONS] * pos_scale
    out = make_forward(module, extra)(batch, True, virial)
    named = list(module.named_parameters())
    _, _, _, grads = loss_and_grads(make_forward(module, extra, create_graph=True),
                                    tloss.WeightedLoss("l2", **WEIGHTS),
                                    [p for _, p in named], batch, True, virial)
    return out, {n: g for (n, _), g in zip(named, grads)}


def _close(got, want, rel, what=""):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_matches_jax_remat(monkeypatch, jax_params, route):
    """The port with remat against the JAX package with remat, under both
    policies: energy and forces within 1e-5, the force loss's gradients
    within the training tests' limit.  The JAX program is the same under
    both policies (``test_remat_stages_match_jax_pallas_calls`` compares
    its jaxprs: no backward reads the named aggregate, so it is never a
    residual), so it runs once."""
    from xequinet_torch.convert import params_from_flax

    _jax_references(monkeypatch)
    dps_t, dps_j = _labelled(5)
    _, want, want_g = _JAX_RUNS[route] = _jax_run(_kw(route, "full"), jax_params, dps_j, route)
    module, _, _ = resolve_model("xpainn", **_kw(route))
    want_g = params_from_flax(want_g, module)
    n_g = len(dps_t)
    for policy in POLICIES:
        kw = _kw(route, policy)
        got, grads = _port_run(kw, jax_params, dps_t, route)
        _close(got[keys.TOTAL_ENERGY][:n_g], want[keys.TOTAL_ENERGY][:n_g], 1e-5, "energy")
        _close(got[keys.FORCES], want[keys.FORCES], 1e-5, "forces")
        _, nudged = _port_run(kw, jax_params, dps_t, route, pos_scale=1.0 + 1e-7)
        for name, g in grads.items():
            scale = max(float(g.abs().max()), 1e-30)
            limit = 1e-4 + 2 * float((nudged[name] - g).abs().max()) / scale
            assert float((g - want_g[name]).abs().max()) <= limit * scale, (policy, name)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("route", list(ROUTES))
def test_remat_bit_identical_to_no_remat(one_thread, route, policy):
    """Remat changes what is kept, not what is computed: energies, forces
    and the force loss's parameter gradients equal the model's without
    remat bit for bit (three blocks)."""
    dps_t, _ = _labelled(7)
    (o0, g0), (o1, g1) = [_port_run(_kw(route, pol, blocks=3), None, dps_t, route)
                          for pol in (None, policy)]
    for k in (keys.TOTAL_ENERGY, keys.FORCES):
        assert torch.equal(o0[k], o1[k]), k
    assert sorted(g0) == sorted(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    stack = resolve_model("xpainn", **_kw(route, policy))[0]
    marked = [type(b).__name__ for b in stack.blocks if getattr(b, "remat_policy", None)]
    assert marked == ["XPainnMessage", "XPainnUpdate"] * 2


def test_remat_xmatnet_bit_identical_to_no_remat(one_thread):
    """XMatNet takes the option through its XPaiNN backbone (mega route):
    its matrix blocks and their loss's parameter gradients equal those
    without remat bit for bit."""
    from .test_torch_xe3net_xmatnet import MEGA, XMAT, _molecules

    batch = batch_to_device(collate(_molecules(4, port=True), kernel_layout=LAYOUT), "cpu")
    runs = []
    for extra in ({}, {"remat": True}):
        module, _, _ = resolve_model("xmatnet", **XMAT, **MEGA, **extra)
        init_params(module, seed=1)
        out = module(compute_edge_data_t(dict(batch)))
        mats = (out[keys.NODE_MAT_BLOCKS], out[keys.EDGE_MAT_BLOCKS])
        loss = sum((m.double() ** 2).sum() for m in mats)
        runs.append((mats, torch.autograd.grad(loss, list(module.parameters()))))
        marked = [b for b in module.blocks if getattr(b, "remat_policy", None)]
        assert len(marked) == (2 if extra else 0)
    for a, b in zip(runs[0][0] + runs[0][1], runs[1][0] + runs[1][1]):
        assert torch.equal(a, b)


def _jaxprs(kw, jb, params):
    """The jaxprs of the JAX forces-only call and train step."""
    m, extra, _ = jax_resolve_model("xpainn", **kw)
    fwd = make_apply_forward(m, extra)
    lossfn = jloss.WeightedLoss("l2", **WEIGHTS)
    return [jax.make_jaxpr(f)(params).jaxpr for f in (
        lambda p: fwd(p, jb, True, False),
        jax.grad(lambda p: lossfn(fwd(p, jb, True, False), jb)[0]))]


def _pallas_calls(jaxpr, mega):
    """{stage: pallas_calls} of a jaxpr, the message kernels told apart by
    their outputs (1 forward, 3 backward, 4 second order)."""
    n = collections.Counter()

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "pallas_call":
                stage = {1: "message_fwd", 3: "message_bwd", 4: "message_bwd2"}[
                    len(e.outvars)] if mega else "v2"
                n[stage] += 1
            for v in e.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    inner = getattr(sub, "jaxpr", sub)
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr)
    return dict(n)


@pytest.fixture(scope="module")
def jax_template():
    """The parameter shapes of the three-block model on the count tests'
    batch (tracing needs no values)."""
    _, dps_j = _labelled(2, n_mols=2)
    jb = {k: jnp.asarray(v) for k, v in jcollate(dps_j, n_nodes=40).items()}
    m, _, _ = jax_resolve_model("xpainn", **_kw(blocks=3))
    return jax.eval_shape(lambda d: m.init(jax.random.PRNGKey(0), compute_edge_data(d)),
                          jb)["params"]


def _counted(monkeypatch):
    """Counts each call of the stages that launch a kernel on the card."""
    got = collections.Counter()
    for stage, mod, fn in (("message_fwd", fm, "message_forward"),
                           ("message_bwd", fm, "message_backward"),
                           ("message_bwd2", fm, "plain_message_bwd2"),
                           ("v2", gs2, "gather_scale_scatter_v2")):
        orig = getattr(mod, fn)

        def counted(*a, _orig=orig, _stage=stage, **k):
            got[_stage] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(mod, fn, counted)
    return got


def _port_counts(kw, dps_t, route, got, wrap=None):
    module, extra, _ = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    if wrap is not None:
        wrap(module)
    batch = batch_to_device(collate(dps_t, n_nodes=40, kernel_layout=_layout(route)), "cpu")
    got.clear()
    make_forward(module.requires_grad_(False), extra)(batch, True, False)
    force = dict(got)
    got.clear()
    module.requires_grad_(True)
    loss_and_grads(make_forward(module, extra, create_graph=True),
                   tloss.WeightedLoss("l2", **WEIGHTS), list(module.parameters()), batch,
                   True, False)
    return force, dict(got)


@pytest.mark.parametrize("route,policies", [("mega", POLICIES), ("v2", ("full",))])
def test_remat_stages_match_jax_pallas_calls(monkeypatch, jax_template, route, policies):
    """At three blocks the port calls each kernel stage as often per
    forces-only call and per train step as the JAX program with the same
    remat runs its pallas_calls: on the mega route 3 + 3 and 3 + 8 + 3 (the
    second and third blocks' first-order VJPs rerun in the
    parameter-gradient pass; the first block's does not, its node inputs
    do not depend on the positions), on the v2 route 3 and 3.  On the mega
    route the JAX jaxprs of the two policies are equal but for the policy
    itself."""
    import re

    dps_t, dps_j = _labelled(2, n_mols=2)
    jb = {k: jnp.asarray(v) for k, v in
          jcollate(dps_j, n_nodes=40, kernel_layout=_layout(route)).items()}
    texts = []
    got = _counted(monkeypatch)
    for policy in policies:
        kw = _kw(route, policy, blocks=3)
        jaxprs = _jaxprs(kw, jb, jax_template)
        want = [_pallas_calls(j, route == "mega") for j in jaxprs]
        texts.append([re.sub(r"policy=(None|<function .*? at 0x[0-9a-f]+>)", "", str(j))
                      for j in jaxprs])
        if route == "mega":
            assert want == [{"message_fwd": 3, "message_bwd": 3},
                            {"message_fwd": 3, "message_bwd": 8, "message_bwd2": 3}]
        assert list(_port_counts(kw, dps_t, route, got)) == want, policy
    assert all(t == texts[0] for t in texts)


def test_plain_checkpoint_runs_other_stage_counts(monkeypatch):
    """The negative control of the count: ``torch.utils.checkpoint`` around
    each block (no remat in the model) reruns the forward kernel, 6 + 3 per
    force call and 9 + 6 + 3 per train step, not the JAX program's."""
    import torch.utils.checkpoint as cp

    def wrap(module):
        for b in module.blocks:
            if type(b).__name__ in ("XPainnMessage", "XPainnUpdate"):
                plain = b.forward
                b.forward = lambda d, _f=plain: cp.checkpoint(lambda x: _f(dict(x)), d,
                                                              use_reentrant=False)

    dps_t, _ = _labelled(2, n_mols=2)
    got = _counted(monkeypatch)
    counts = _port_counts(_kw("mega", blocks=3), dps_t, "mega", got, wrap)
    assert counts == ({"message_fwd": 6, "message_bwd": 3},
                      {"message_fwd": 9, "message_bwd": 6, "message_bwd2": 3})


def test_remat_ewald_matches_jax_and_no_remat(one_thread):
    """Periodic XPaiNN-Ewald with remat (message and update blocks wrapped,
    the Ewald blocks not): energy, forces and virial against JAX's remat
    within 1e-5, and bit for bit against the port without remat, the
    force loss's gradients too."""
    kw = dict(node_dim=SD, node_irreps=IRREPS, embed_basis="one-hot", num_basis=NB,
              action_blocks=2, output_modes=["energy"], projection_dim=4, cutoff=3.0,
              use_pbc=True, num_k_points=[2, 2, 2])
    rng = np.random.default_rng(21)
    dps_j = _crystals(rng, n_cells=2)
    for d in dps_j:
        d.energy = float(rng.normal())
        d.forces = rng.normal(size=(d.num_atoms, 3))
    dps_t = [Datapoint(d.atomic_numbers, d.pos, cell=d.cell, pbc=d.pbc, edge_index=d.edge_index,
                       cell_offsets=d.cell_offsets, energy=d.energy, forces=d.forces)
             for d in dps_j]
    rk = dict(kw, remat=True, remat_policy="full")
    params, want, _ = _jax_run(rk, None, dps_j, "plain", model="xpainn-ewald", virial=True,
                               grads=False)
    got, grads = _port_run(rk, params, dps_t, "plain", model="xpainn-ewald", virial=True)
    _close(got[keys.TOTAL_ENERGY][:2], want[keys.TOTAL_ENERGY][:2], 1e-5, "energy")
    _close(got[keys.FORCES], want[keys.FORCES], 1e-5, "forces")
    _close(got[keys.VIRIAL][:2], want[keys.VIRIAL][:2], 1e-5, "virial")
    base, base_g = _port_run(kw, params, dps_t, "plain", model="xpainn-ewald", virial=True)
    for k in (keys.TOTAL_ENERGY, keys.FORCES, keys.VIRIAL):
        assert torch.equal(got[k], base[k]), k
    for name in grads:
        assert torch.equal(grads[name], base_g[name]), name
    stack = resolve_model("xpainn-ewald", **rk)[0]
    assert not any(getattr(b, "remat_policy", None) for b in stack.blocks
                   if "Ewald" in type(b).__name__)


def test_jax_remat_checkpoint_serves(tmp_path, jax_params):
    """A JAX trainer checkpoint with ``remat: true`` and ``save_edge_agg``
    loads into the port (the parameter names do not change) and serves
    energies and forces within 1e-5 of the JAX model's."""
    kw = _kw("plain", "save_edge_agg", cutoff=5.0)
    dps_t, dps_j = _labelled(5)
    # the JAX program with remat is the same under either policy
    # (test_remat_stages_match_jax_pallas_calls)
    if "plain" not in _JAX_RUNS:
        _JAX_RUNS["plain"] = _jax_run(_kw("plain", "full"), jax_params, dps_j, "plain")
    params, want, _ = _JAX_RUNS["plain"]
    path = str(tmp_path / "remat.ckpt")
    save_checkpoint(path, params, config_to_dict(ModelConfig(model_name="xpainn",
                                                             model_kwargs=kw)))
    engine = InferenceEngine(path, device="cpu")
    assert all(getattr(b, "remat_policy", None) == "save_edge_agg"
               for b in engine.module.blocks if type(b).__name__ == "XPainnMessage")
    res = engine.predict(dps_t, compute_forces=True)
    for i, r in enumerate(res):
        assert math.isclose(float(r[keys.TOTAL_ENERGY]), float(want[keys.TOTAL_ENERGY][i]),
                            rel_tol=1e-5)
    n = [d.num_atoms for d in dps_t]
    f = np.concatenate([np.asarray(r[keys.FORCES]) for r in res])
    _close(f, np.asarray(want[keys.FORCES])[: sum(n)], 1e-5, "forces")
    assert tremat.recomputing() is False
