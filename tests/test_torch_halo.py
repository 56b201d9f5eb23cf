"""The port's halo decomposition (xequinet_torch.parallel.halo and the
exchange of ops/scatter) against the JAX package's, on the CPU.

The host functions (partition, kernel layout, labels, stacking) must equal
the JAX ones bit for bit.  The device paths run in one pool of four gloo
processes (tests/_torch_halo_worker.py), started once for the module and
running every case, each rank on its own shard: the halo forward and
forces on the plain route and on the mega route (the message kernels'
plain versions) of a free chain and a periodic box, against the JAX
``make_halo_forward`` on a 4-device CPU mesh (its XLA path, the same
function) and the port's single-process forward (energy 1e-5 relative,
forces 1e-4 of the largest |F|); the exchange
Function under gradcheck and gradgradcheck; PaiNN, SO3krates and
XPaiNN-Ewald with a charge under halo against a single process; the
HaloCalculator on the mega route over two geometries; and ``run_md`` with
``halo_devices: 4`` against the JAX ``run_md`` halo and the single-process
port, with bit-identical replicas.  Every worker is waited for with a
timeout and killed on expiry, so a deadlock fails instead of hanging.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate as jax_collate
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.models.model import resolve_model as jax_resolve_model
from xequinet_tpu.models.properties import compute_edge_data as jax_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np, radius_graph_pbc_np
from xequinet_tpu.parallel import halo as jhalo
from xequinet_tpu.parallel.mesh import GP_AXIS, make_mesh
from xequinet_tpu.training.trainer import save_checkpoint
from xequinet_tpu.utils.config import ModelConfig, config_to_dict
from xequinet_torch.convert import params_from_flax
from xequinet_torch.data.batching import collate
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.models.properties import make_forward
from xequinet_torch.ops.scatter import RingExchange, make_halo_spec
from xequinet_torch.parallel import halo as thalo
from xequinet_torch.run.inference import batch_to_device

from tests._torch_halo_worker import run_pool
from tests._torch_jax_native import module_fixture

KW = dict(node_dim=16, node_irreps="16x0e+8x1o", embed_basis="one-hot", num_basis=8,
          cutoff=5.0, action_blocks=2, output_modes=["energy"])
BN, CHUNK = 24, 8
N_SHARDS = 4


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def _jax_native_order(tmp_path_factory):
    """The JAX package's cell lists built into a private path, so that its
    edge order is the one the port reproduces whatever other workers do to
    the shared library (tests/_torch_jax_native.py)."""
    yield from module_fixture(tmp_path_factory)


def _chain(rng, n=160, cutoff=5.0, lo=0.8, hi=1.6):
    """A quasi-1D free system sorted along x, edges center-sorted."""
    x = np.cumsum(rng.uniform(lo, hi, size=n))
    pos = np.column_stack([x, rng.normal(size=(n, 2)) * 1.2])
    z = rng.integers(1, 9, size=n).astype(np.int32)
    ei, _ = radius_graph_np(pos, cutoff)
    return z, pos, ei[:, np.argsort(ei[0], kind="stable")]


def _box(rng, n=144):
    """tests/test_halo_mega.py's periodic box, unsorted input."""
    lx = n * 1.1
    cell = np.diag([lx, 11.5, 11.5])
    x = (np.arange(n) * 1.1 + rng.normal(size=n) * 0.05) % lx
    pos = np.column_stack([x, rng.uniform(2.0, 9.5, size=(n, 2))])[rng.permutation(n)]
    z = rng.integers(1, 9, size=n).astype(np.int32)
    return z, pos, cell, np.array([True, True, True])


def _jax_params(model_name, kw, batch, seed=0):
    m, _, _ = jax_resolve_model(model_name, **kw)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(lambda d: m.init(jax.random.PRNGKey(seed), jax_edge_data(d)))(b)["params"]


def _state(model_name, kw, params):
    module, _, _ = resolve_model(model_name, **kw)
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.array, params), module).items()}


def _jax_halo(params, stacked, geom, wrap_shift=None, forces=True, kw=KW):
    module, _, _ = jax_resolve_model("xpainn", **kw)
    fwd = jhalo.make_halo_forward(lambda d: module.apply({"params": params}, d),
                                  make_mesh(N_SHARDS, axis_names=(GP_AXIS,)), geom, GP_AXIS)
    e, f = fwd(stacked, compute_forces=forces, wrap_shift=wrap_shift)
    return float(e), (None if f is None else np.asarray(f))


def _port_single(model_name, kw, state, dp):
    """The port's single-process forward of one whole system: (energy,
    forces of the real atoms)."""
    module, extra, _ = resolve_model(model_name, **kw)
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
    out = make_forward(module.requires_grad_(False), extra)(
        batch_to_device(collate([dp]), "cpu"), True, False)
    return float(out[keys.TOTAL_ENERGY][0]), out[keys.FORCES][:dp.num_atoms].numpy()


def _owned(f, stacked, geom, perm=None):
    """Forces in padded-global shard order -> the real atoms, in input
    order when ``perm`` (input -> sorted) is given."""
    nl, h = geom["n_local"], geom["halo"]
    nm = stacked[keys.NODE_MASK][:, h:h + nl].reshape(-1)
    fs = np.asarray(f).reshape(-1, 3)[nm]
    if perm is None:
        return fs
    out = np.empty_like(fs)
    out[perm] = fs
    return out


def _mega_kw(geom, mxc, kw=KW):
    return dict(kw, use_pallas_scatter="mega", pallas_layout=(BN, CHUNK, geom["halo"], mxc))


# ---------------------------------------------------------------------------
# host functions: bit for bit
# ---------------------------------------------------------------------------
def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("case", ["free", "periodic", "balanced", "edge_cap"])
def test_halo_partition_matches_jax(case):
    rng = np.random.default_rng(3)
    if case == "periodic":
        z, pos, cell, pbc = _box(rng)
        want = jhalo.prepare_halo_system(z, pos, 5.0, N_SHARDS, cell=cell, pbc=pbc)
        got = thalo.prepare_halo_system(z, pos, 5.0, N_SHARDS, cell=cell, pbc=pbc)
        _same(got[0], want[0])
        assert got[1] == want[1] and got[4:] == want[4:]
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_array_equal(got[3], want[3])
        return
    if case == "balanced":
        gaps = np.concatenate([rng.uniform(0.35, 0.6, 60), rng.uniform(1.2, 1.8, 120)])
        pos = np.column_stack([np.cumsum(gaps), rng.normal(size=(180, 2)) * 1.2])
        z = rng.integers(1, 9, 180).astype(np.int32)
        ei, _ = radius_graph_np(pos, 5.0)
        ei = ei[:, np.argsort(ei[0], kind="stable")]
        args, kw = (z, pos, ei, 8, 48), dict(balance_edges=True)
    else:
        z, pos, ei = _chain(rng, n=180)
        args, kw = (z, pos, ei, 8, 24), ({} if case == "free" else dict(edge_cap=1024))
    want = jhalo.halo_partition(*args, **kw)
    got = thalo.halo_partition(*args, **kw)
    _same(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("case", ["reach", "halo_wider_than_shard", "edge_cap"])
def test_halo_partition_errors_match_jax(case):
    rng = np.random.default_rng(4)
    if case == "reach":
        args = (np.ones(64, np.int32), rng.normal(size=(64, 3)),
                np.array([[0, 63], [63, 0]], dtype=np.int32), 8, 8)
        kw = {}
    else:
        z, pos, ei = _chain(rng, n=96)
        args = (z, pos, ei, 8, 24) if case == "halo_wider_than_shard" else (z, pos, ei, 4, 24)
        kw = {} if case == "halo_wider_than_shard" else dict(edge_cap=128)
    msgs = []
    for fn in (jhalo.halo_partition, thalo.halo_partition):
        with pytest.raises(ValueError) as err:
            fn(*args, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_prepare_halo_system_free_matches_jax():
    rng = np.random.default_rng(5)
    z, pos, _ = _chain(rng, n=200)
    pos = pos[rng.permutation(200)]
    for kw in ({}, dict(halo=32, edge_cap=2048, nl_exact=56),
               dict(min_halo=40, min_edge_cap=4096)):
        want = jhalo.prepare_halo_system(z, pos, 5.0, N_SHARDS, **kw)
        got = thalo.prepare_halo_system(z, pos, 5.0, N_SHARDS, **kw)
        _same(got[0], want[0])
        assert got[1] == want[1] and got[3] is want[3] is None and got[4:] == want[4:]
        np.testing.assert_array_equal(got[2], want[2])


def test_kernel_layout_labels_stacking_match_jax():
    rng = np.random.default_rng(6)
    z, pos, cell, pbc = _box(rng)
    stacked, geom, perm, *_ = jhalo.prepare_halo_system(z, pos, 5.0, N_SHARDS, cell=cell,
                                                        pbc=pbc)
    lay = {"block_nodes": BN, "chunk": CHUNK}
    for kw in ({}, dict(margin=1.3), dict(min_slot_cap=4096, min_max_chunks=64)):
        want = jhalo.apply_halo_kernel_layout(stacked, geom, lay, **kw)
        got = thalo.apply_halo_kernel_layout(stacked, geom, lay, **kw)
        _same(got[0], want[0])
        assert got[1:] == want[1:]
    msgs = []
    for fn in (jhalo.apply_halo_kernel_layout, thalo.apply_halo_kernel_layout):
        with pytest.raises(ValueError) as err:
            fn(stacked, geom, lay, slot_cap=8)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    f = rng.normal(size=(len(z), 3)).astype(np.float32)[perm]
    np.testing.assert_array_equal(thalo.scatter_labels_to_shards(stacked, geom, f),
                                  jhalo.scatter_labels_to_shards(stacked, geom, f))
    parts = [jhalo.halo_partition(*_chain(rng, n=96), N_SHARDS, 16, edge_cap=1024)
             for _ in range(2)]
    want = jhalo.stack_halo_systems([p[0] for p in parts], [p[1] for p in parts])
    got = thalo.stack_halo_systems([p[0] for p in parts], [p[1] for p in parts])
    _same(got[0], want[0])
    assert got[1] == want[1]
    geom = {"n_local": 128, "halo": 24, "window": 176}
    assert thalo.comm_bytes_per_block(geom, 512, 1024) == jhalo.comm_bytes_per_block(
        geom, 512, 1024)


def test_exchange_gradcheck_single_periodic_shard():
    """One shard on a periodic ring: the exchange is a local copy of the
    tail to the left halo and the head to the right one, twice
    differentiable."""
    spec = make_halo_spec(None, 4, 2, periodic=True)
    a = torch.randn(2, 3, dtype=torch.float64, requires_grad=True)
    b = torch.randn(2, 3, dtype=torch.float64, requires_grad=True)

    def f(a, b):
        left, right = RingExchange.apply(a, b, spec)
        return RingExchange.apply(torch.sin(right), left * left, spec)

    assert torch.autograd.gradcheck(f, (a, b))
    assert torch.autograd.gradgradcheck(f, (a, b))
    left, right = RingExchange.apply(a, b, spec)
    assert torch.equal(left, a) and torch.equal(right, b)


# ---------------------------------------------------------------------------
# device paths, in one pool of four processes
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    """Builds every case, runs them in one pool of four ranks, and returns
    (cases' references, every rank's outputs)."""
    work = tmp_path_factory.mktemp("halo")
    rng = np.random.default_rng(0)
    cases, refs = {}, {}

    # a free chain and a periodic box, one JAX parameter tree
    z, pos, ei = _chain(rng, n=160)
    params = _jax_params("xpainn", KW, jax_collate([JDatapoint(z, pos, edge_index=ei)]))
    state = _state("xpainn", KW, params)
    stacked, geom = jhalo.halo_partition(z, pos, ei, N_SHARDS, halo=24)
    stacked_m, _, mxc = jhalo.apply_halo_kernel_layout(stacked, geom,
                                                       {"block_nodes": BN, "chunk": CHUNK})
    e_j, f_j = _jax_halo(params, stacked, geom)
    e_j0, _ = _jax_halo(params, stacked, geom, forces=False)
    refs["free"] = dict(jax=(e_j, _owned(f_j, stacked, geom)), jax_energy_only=e_j0,
                        single=_port_single("xpainn", KW, state,
                                            Datapoint(z, pos, edge_index=ei)),
                        stacked=stacked, geom=geom)
    cases["free_plain"] = dict(kind="forward", kw=KW, state=state, stacked=stacked, geom=geom)
    cases["free_energy"] = dict(cases["free_plain"], forces=False)
    cases["free_mega"] = dict(kind="forward", kw=_mega_kw(geom, mxc), state=state,
                              stacked=stacked_m, geom=geom)

    zb, posb, cell, pbc = _box(rng)
    sb, gb, perm, ws, _, _ = jhalo.prepare_halo_system(zb, posb, 5.0, N_SHARDS, cell=cell,
                                                       pbc=pbc)
    sb_m, _, mxb = jhalo.apply_halo_kernel_layout(sb, gb, {"block_nodes": BN, "chunk": CHUNK})
    e_b, f_b = _jax_halo(params, sb, gb, wrap_shift=ws)
    eib, offs = radius_graph_pbc_np(posb, cell, pbc, 5.0)
    box_dp = Datapoint(zb, posb, edge_index=eib, cell_offsets=offs, cell=cell, pbc=pbc)
    refs["box"] = dict(jax=(e_b, _owned(f_b, sb, gb, perm)),
                       single=_port_single("xpainn", KW, state, box_dp),
                       stacked=sb, geom=gb, perm=perm)
    cases["box_plain"] = dict(kind="forward", kw=KW, state=state, stacked=sb, geom=gb,
                              wrap_shift=ws)
    cases["box_mega"] = dict(kind="forward", kw=_mega_kw(gb, mxb), state=state, stacked=sb_m,
                             geom=gb, wrap_shift=ws)
    for periodic in (False, True):
        cases[f"gradcheck_{periodic}"] = dict(kind="gradcheck", periodic=periodic)

    # the other families under halo, against the port's single process
    # (seeded port weights): PaiNN and SO3krates on the chain, XPaiNN-Ewald
    # with a charge on the box
    for name, kw, system in (
            ("painn", dict(KW, node_irreps="16x0e+8x1o"), "free"),
            ("so3krates", dict(KW, node_dim=24, node_channel=4, max_l=2, num_heads=2), "free"),
            ("xpainn-ewald", dict(KW, charge_embed=True, use_pbc=True, num_k_points=[2, 2, 2],
                                  projection_dim=4), "box")):
        module, _, _ = resolve_model(name, **kw)
        init_params(module, seed=1)
        st = {k: v.numpy() for k, v in module.state_dict().items()}
        if system == "free":
            s, g, ref = stacked, geom, _port_single(name, kw, st, Datapoint(z, pos,
                                                                           edge_index=ei))
            extra = {}
        else:
            s = dict(sb, **{keys.TOTAL_CHARGE: np.full((N_SHARDS, 1), 2, np.int32)})
            g = gb
            ref = _port_single(name, kw, st, Datapoint(zb, posb, edge_index=eib,
                                                       cell_offsets=offs, cell=cell, pbc=pbc,
                                                       charge=2))
            extra = dict(wrap_shift=ws)
        refs[name] = dict(single=ref, stacked=s, geom=g, perm=None if system == "free" else perm)
        cases[name] = dict(kind="forward", model=name, kw=kw, state=st, stacked=s, geom=g,
                           **extra)

    # the calculator and MD over one JAX checkpoint
    mk = dict(KW, action_blocks=1)
    zc, posc, eic = _chain(rng, n=120, lo=0.9, hi=1.5)
    zc = rng.integers(1, 5, size=120).astype(np.int32)
    cp = _jax_params("xpainn", mk, jax_collate([JDatapoint(zc, posc, edge_index=eic)]))
    ckpt = str(work / "m.ckpt")
    save_checkpoint(ckpt, cp, config_to_dict(ModelConfig(model_name="xpainn",
                                                         model_kwargs=mk)))
    moved = [posc[rng.permutation(120)] if i == 0 else None for i in range(2)]
    moved[1] = moved[0] + 0.02 * rng.normal(size=moved[0].shape)
    cases["calculator_mega"] = dict(kind="calculator", ckpt=ckpt, z=zc, positions=moved,
                                    pallas="mega", layout=(BN, CHUNK))
    refs["calculator"] = dict(ckpt=ckpt, z=zc, positions=moved)
    from xequinet_torch.data.fmt_conversion import write_xyz
    from xequinet_torch.utils.config import MDConfig

    xyz = work / "in.xyz"
    write_xyz(str(xyz), [Datapoint(zc, posc)])

    def md_config(tag, halo_devices, **extra):
        return MDConfig(ensembles=[{"name": "nve", "timestep": 0.5, "steps": 4,
                                    "log_interval": 2}],
                        input_file=str(xyz), model_file=ckpt,
                        logfile=str(work / f"{tag}.log"), xyz_traj=str(work / f"{tag}.xyz"),
                        seed=5, init_temperature=30.0, halo_devices=halo_devices, **extra)

    cases["md"] = dict(kind="md", config=md_config("halo", N_SHARDS, device="cpu"))
    refs["md"] = dict(config=md_config, work=work)

    outs = run_pool(cases, work, N_SHARDS)
    return refs, outs


def _close_e(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _close_f(got, want):
    """max |dF| within 1e-4 of the largest |F|: f32 sums in another order
    move single small components by more than 1e-4 of themselves."""
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= 1e-4 * scale, (err, scale)


@pytest.mark.parametrize("route", ["plain", "mega"])
@pytest.mark.parametrize("system", ["free", "box"])
def test_halo_forward_matches_jax_and_single_process(pool, system, route):
    """Energy and forces of the port's halo forward on four ranks against
    the JAX halo forward on a 4-device mesh and the port's single process;
    every rank returns the same energy."""
    refs, outs = pool
    ref = refs[system]
    res = [o[f"{system}_{route}"] for o in outs]
    assert len({r["energy"] for r in res}) == 1
    f = _owned(res[0]["forces"], ref["stacked"], ref["geom"], ref.get("perm"))
    for e_want, f_want in (ref["jax"], ref["single"]):
        _close_e(res[0]["energy"], e_want)
        _close_f(f, f_want)


def test_halo_energy_only_matches_jax(pool):
    refs, outs = pool
    assert outs[0]["free_energy"]["forces"] is None
    _close_e(outs[0]["free_energy"]["energy"], refs["free"]["jax_energy_only"])


@pytest.mark.parametrize("periodic", [False, True])
def test_exchange_gradcheck_four_ranks(pool, periodic):
    """gradcheck and gradgradcheck of a round trip through the exchange on
    every rank of an open and a periodic ring of four."""
    _, outs = pool
    for o in outs:
        assert o[f"gradcheck_{periodic}"] == {"gradcheck": True, "gradgradcheck": True}


@pytest.mark.parametrize("name", ["painn", "so3krates", "xpainn-ewald"])
def test_other_families_under_halo_match_single_process(pool, name):
    """PaiNN and SO3krates (scope="edges" sums) on the free chain, and
    XPaiNN-Ewald with a charge embedding on the periodic box (the structure
    factors and the attention normaliser all-reduced) against the port's
    single-process forward of the same weights."""
    refs, outs = pool
    ref = refs[name]
    _close_e(outs[0][name]["energy"], ref["single"][0])
    _close_f(_owned(outs[0][name]["forces"], ref["stacked"], ref["geom"], ref["perm"]),
             ref["single"][1])


def test_halo_calculator_mega_matches_calculator(pool):
    """HaloCalculator(pallas="mega") on four ranks, unsorted input, two
    geometries with one model: every rank returns the whole result, equal
    to the port's single-process Calculator."""
    from xequinet_torch.interface.calculator import Calculator

    refs, outs = pool
    ref = refs["calculator"]
    calc = Calculator(ref["ckpt"], use_ema=False, device="cpu")
    for i, p in enumerate(ref["positions"]):
        want = calc.calculate(ref["z"], p)
        for o in outs:
            got = o["calculator_mega"]["results"][i]
            _close_e(got[keys.TOTAL_ENERGY], want[keys.TOTAL_ENERGY])
            _close_f(got[keys.FORCES], want[keys.FORCES])
    assert all(o["calculator_mega"]["programs"] == 1 for o in outs)


def test_run_md_halo_matches_jax_and_single_process(pool):
    """``run_md`` with halo_devices 4: the four replicas bit-identical, rank
    0 alone writing the trajectory, the last frame against the JAX
    ``run_md`` halo on a 4-device mesh and the port's single-process run."""
    from xequinet_tpu.run.dynamics import run_md as jax_run_md
    from xequinet_tpu.utils.config import MDConfig as JaxMDConfig
    from xequinet_torch.data.fmt_conversion import read_xyz
    from xequinet_torch.run.dynamics import run_md

    refs, outs = pool
    for o in outs[1:]:
        np.testing.assert_array_equal(o["md"]["pos"], outs[0]["md"]["pos"])
        np.testing.assert_array_equal(o["md"]["vel"], outs[0]["md"]["vel"])
    cfg, work = refs["md"]["config"], refs["md"]["work"]
    halo = read_xyz(str(work / "halo.xyz"))
    single = cfg("single", 0, device="cpu")
    run_md(single)
    jcfg = cfg("jax", N_SHARDS)
    jax_run_md(JaxMDConfig(**{k: getattr(jcfg, k) for k in (
        "ensembles", "input_file", "model_file", "logfile", "xyz_traj", "seed",
        "init_temperature", "halo_devices")}))
    for tag in ("single", "jax"):
        want = read_xyz(str(work / f"{tag}.xyz"))
        assert len(want) == len(halo) >= 2
        np.testing.assert_allclose(halo[-1].pos, want[-1].pos, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(halo[-1].pos, outs[0]["md"]["pos"], rtol=1e-6, atol=1e-6)
