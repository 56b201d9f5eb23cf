"""The port's Calculator (xequinet_torch.interface.calculator) against the
JAX package's, on the CPU.

One JAX checkpoint (small XPaiNN: node_dim 16, 16x0e+8x1o+4x2e, 2 blocks,
f32) serves both packages.  The oracle is the JAX Calculator on its XLA
path (``pallas=None``), which computes the same function as its mega
path; the port's mega route runs the plain versions of the message
kernels on the CPU.  Tolerances are the JAX tests' (tests/test_pbc_mega.py,
tests/test_mega_production.py): energy 2e-5 relative, forces and virial
1e-3 of their largest magnitude (positions span ~800 A, so f32 edge
vectors round at ~5e-5 A; a layout fault shows at the wrap-edge fraction,
far above 1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.data.datapoint import Datapoint
from xequinet_tpu.interface.calculator import Calculator as JaxCalculator
from xequinet_tpu.models.model import resolve_model
from xequinet_tpu.models.properties import compute_edge_data
from xequinet_tpu.ops.radius_graph import radius_graph_np
from xequinet_tpu.training.trainer import save_checkpoint
from xequinet_tpu.utils.config import ModelConfig, config_to_dict
from xequinet_torch.interface.calculator import Calculator

CUTOFF = 5.0
KW = dict(node_dim=16, node_irreps="16x0e+8x1o+4x2e", embed_basis="one-hot", num_basis=8,
          cutoff=CUTOFF, action_blocks=2, output_modes=["energy"])
FREE_CAPS = dict(max_atoms=1024, max_edges=8192)
PBC_CAPS = dict(max_atoms=1024, max_edges=16384)


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def write_ckpt(path, kw, seed=0):
    """A JAX trainer checkpoint of XPaiNN ``kw`` at seeded weights (the
    initialisation jitted: eager flax init takes seconds more)."""
    module, _, _ = resolve_model("xpainn", **kw)
    rng = np.random.default_rng(seed)
    z = rng.integers(1, 5, 6).astype(np.int32)
    pos = rng.normal(size=(6, 3)) * 1.5
    ei, _ = radius_graph_np(pos, CUTOFF)
    batch = {k: jnp.asarray(v) for k, v in collate([Datapoint(z, pos, edge_index=ei)]).items()}
    params = jax.jit(lambda d: module.init(jax.random.PRNGKey(seed),
                                           compute_edge_data(d))["params"])(batch)
    save_checkpoint(path, params, config_to_dict(ModelConfig(model_name="xpainn",
                                                             model_kwargs=kw)))
    return path


def jax_calculator(path, **kw):
    """The JAX Calculator on its XLA path, without the on-disk XLA cache."""
    return JaxCalculator(path, compile_cache=False, **kw)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return write_ckpt(str(tmp_path_factory.mktemp("calc") / "small.ckpt"), KW)


def _free_chain(seed=11, n=700):
    """tests/test_mega_production.py's quasi-1D chain, deliberately not
    sorted along its axis."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.uniform(0.9, 1.5, size=n))
    pos = np.column_stack([x, rng.normal(size=(n, 2)) * 1.0])
    pos = pos[rng.permutation(n)]
    return rng.integers(1, 5, size=n).astype(np.int32), pos


def _pbc_chain(seed=5, n=700):
    """tests/test_pbc_mega.py's periodic chain: long x cell, y / z
    periodic but wider than 2 cutoffs, wrap edges on every axis."""
    rng = np.random.default_rng(seed)
    lx = n * 1.15
    cell = np.diag([lx, 11.0, 11.0])
    x = (np.arange(n) * 1.15 + rng.normal(size=n) * 0.05) % lx
    pos = np.column_stack([x, rng.uniform(0, 11.0, size=(n, 2))])
    return rng.integers(1, 5, size=n).astype(np.int32), pos, cell, np.array([True] * 3)


@pytest.fixture(scope="module")
def jax_free(ckpt):
    return jax_calculator(ckpt, **FREE_CAPS)


@pytest.fixture(scope="module")
def jax_pbc(ckpt):
    return jax_calculator(ckpt, compute_virial=True, **PBC_CAPS)


def _check(got, want, virial=False):
    np.testing.assert_allclose(got[keys.TOTAL_ENERGY], want[keys.TOTAL_ENERGY],
                               rtol=2e-5, atol=2e-5)
    assert got[keys.FORCES].shape == want[keys.FORCES].shape
    f_scale = np.abs(want[keys.FORCES]).max()
    assert np.abs(got[keys.FORCES] - want[keys.FORCES]).max() <= 1e-3 * f_scale + 1e-4
    if virial:
        v_scale = np.abs(want[keys.VIRIAL]).max()
        assert np.abs(got[keys.VIRIAL] - want[keys.VIRIAL]).max() <= 1e-3 * v_scale + 1e-3


def test_free_chain_mega_matches_jax(ckpt, jax_free):
    """The unsorted free chain takes the mega route (sorted, then unsorted
    back to the caller's order) on a first and a perturbed second call."""
    rng = np.random.default_rng(1)
    z, pos = _free_chain()
    calc = Calculator(ckpt, pallas="mega", device="cpu", **FREE_CAPS)
    for _ in range(2):
        got = calc.calculate(z, pos)
        assert calc.last_route == "mega"
        _check(got, jax_free.calculate(z, pos))
        pos = pos + rng.normal(size=pos.shape) * 0.01
    # the slot layout of the JAX MD host build: chunk 1024, 256-row blocks
    # below 2048 node rows, no max_chunks cap
    bn, chunk, pad, cap = calc._mega["layout"]
    assert (bn, chunk, cap) == (256, 1024, 0) and pad % 8 == 0


def test_pbc_chain_mega_matches_jax(ckpt, jax_pbc):
    """The periodic chain through the ghost layout, with the virial."""
    rng = np.random.default_rng(2)
    z, pos, cell, pbc = _pbc_chain()
    calc = Calculator(ckpt, compute_virial=True, pallas="mega", device="cpu", **PBC_CAPS)
    for _ in range(2):
        got = calc.calculate(z, pos, cell=cell, pbc=pbc)
        assert calc.last_route == "mega"
        _check(got, jax_pbc.calculate(z, pos, cell=cell, pbc=pbc), virial=True)
        pos = pos + rng.normal(size=pos.shape) * 0.02


def test_pbc_chain_plain_matches_jax(ckpt, jax_pbc):
    """The periodic plain route (host list, pallas=None)."""
    z, pos, cell, pbc = _pbc_chain()
    calc = Calculator(ckpt, compute_virial=True, device="cpu", **PBC_CAPS)
    got = calc.calculate(z, pos, cell=cell, pbc=pbc)
    assert calc.last_route == "plain"
    _check(got, jax_pbc.calculate(z, pos, cell=cell, pbc=pbc), virial=True)


def test_small_molecule_takes_plain_route(ckpt):
    """A 6-atom molecule is below the mega route's sizes: with
    pallas="mega" the port takes the plain route (the device neighbour
    search), as the JAX Calculator takes its XLA path, and gives what the
    plain Calculator gives (held to JAX in
    test_default_embedding_checkpoint_serves)."""
    rng = np.random.default_rng(3)
    z = rng.integers(1, 5, 6).astype(np.int32)
    pos = rng.normal(size=(6, 3)) * 1.5
    calc = Calculator(ckpt, pallas="mega", device="cpu")
    got = calc.calculate(z, pos)
    assert calc.last_route == "plain"
    want = Calculator(ckpt, device="cpu").calculate(z, pos)
    assert got[keys.TOTAL_ENERGY] == want[keys.TOTAL_ENERGY]
    np.testing.assert_array_equal(got[keys.FORCES], want[keys.FORCES])


def test_skin_matches_jax_each_call(ckpt, jax_pbc):
    """Verlet skin 0.5 on the mega route over 6 calls drifting 0.01 A
    each, then calls drifting 0.05 A that pass the prefetch threshold:
    every call matches the JAX Calculator, the list is reused between
    rebuilds, and a background rebuild is swapped in."""
    rng = np.random.default_rng(4)
    z, pos, cell, pbc = _pbc_chain()
    calc = Calculator(ckpt, compute_virial=True, pallas="mega", skin=0.5, device="cpu",
                      **PBC_CAPS)
    for step in range(9):
        got = calc.calculate(z, pos, cell=cell, pbc=pbc)
        assert calc.last_route == "mega"
        _check(got, jax_pbc.calculate(z, pos, cell=cell, pbc=pbc), virial=True)
        if step == 5:
            assert calc.n_rebuilds == 1  # 6 calls on one list
        if calc._skin_pending is not None:
            calc._skin_pending[0].result()  # let the worker finish first
        pos = pos + rng.normal(size=pos.shape) * (0.01 if step < 5 else 0.05)
    assert calc.n_async_swaps >= 1 and calc.n_rebuilds >= 2
    calc.close()
    assert calc._skin_executor is None


def test_edge_capacity_rules(ckpt):
    """48 atoms all within the cutoff of each other (2256 edges, past the
    default capacity of 40 per atom, 2048): a pinned max_edges raises, the
    default capacity grows and gives what a large enough pinned one gives."""
    rng = np.random.default_rng(6)
    z = rng.integers(1, 5, 48).astype(np.int32)
    pos = rng.uniform(-1.2, 1.2, size=(48, 3))
    with pytest.raises(ValueError, match="edge overflow"):
        Calculator(ckpt, max_edges=2048, device="cpu").calculate(z, pos)
    calc = Calculator(ckpt, device="cpu")
    assert calc._capacities(48)[1] < 48 * 47
    got = calc.calculate(z, pos)
    want = Calculator(ckpt, max_edges=3072, device="cpu").calculate(z, pos)
    # the capacities differ, so do the padded sums' orders: f32 op tolerance
    np.testing.assert_allclose(got[keys.TOTAL_ENERGY], want[keys.TOTAL_ENERGY], rtol=1e-5)
    np.testing.assert_allclose(got[keys.FORCES], want[keys.FORCES], rtol=0,
                               atol=1e-5 * np.abs(want[keys.FORCES]).max())


def test_default_embedding_checkpoint_serves(tmp_path):
    """A checkpoint of the JAX package's default embedding (gfn2-xtb
    tables) serves in the port's Calculator and matches the JAX one."""
    kw = {k: v for k, v in KW.items() if k != "embed_basis"}
    path = write_ckpt(str(tmp_path / "gfn2.ckpt"), kw, seed=1)
    rng = np.random.default_rng(7)
    z = rng.integers(1, 9, 8).astype(np.int32)
    pos = rng.normal(size=(8, 3)) * 1.5
    got = Calculator(path, device="cpu").calculate(z, pos)
    want = jax_calculator(path).calculate(z, pos)
    np.testing.assert_allclose(got[keys.TOTAL_ENERGY], want[keys.TOTAL_ENERGY], rtol=1e-4)
    np.testing.assert_allclose(got[keys.FORCES], want[keys.FORCES], rtol=0,
                               atol=1e-4 * np.abs(want[keys.FORCES]).max())
