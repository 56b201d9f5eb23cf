"""The port's o3 core (xequinet_torch.ops) against the JAX package on
seeded random inputs: Wigner-3j tables, spherical harmonics (l <= 3, with
a zero vector), the G/S structure ops and the equivariant layers (l <= 3:
SO3krates' ``max_l``).
Tolerance: f32 1e-5 relative to the largest reference magnitude."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu.models.o3layer import O3Linear as JO3Linear
from xequinet_tpu.ops import o3ops as jo3
from xequinet_tpu.ops.spherical import spherical_harmonics as jsh
from xequinet_tpu.ops.wigner import wigner_3j as jw3j
from xequinet_torch.models.o3layer import EquivariantLayerNorm, O3Linear
from xequinet_torch.ops import o3ops
from xequinet_torch.ops.irreps import Irreps, cat_flat, split_flat
from xequinet_torch.ops.spherical import spherical_harmonics
from xequinet_torch.ops.wigner import wigner_3j

IRREPS = ["128x0e+64x1o+32x2e", "16x0e+8x1o+4x2e", "3x1o+2x0e+1x2e+4x0e",
          "8x0e+8x1o+8x2e+8x3o"]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _close(got, want, rel=1e-5):
    got = np.asarray(got.detach() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("ls", [(1, 1, 0), (1, 1, 2), (2, 1, 2), (1, 2, 1), (2, 2, 2),
                                (2, 1, 3), (3, 3, 2)])
def test_wigner_3j_matches_jax(ls):
    np.testing.assert_allclose(wigner_3j(*ls), jw3j(*ls), atol=1e-12)


@pytest.mark.parametrize("irreps", IRREPS + ["1x0e+1x1o+1x2e", "1x0e+1x1o+1x2e+1x3o"])
def test_spherical_harmonics_match_jax(rng, irreps):
    vec = rng.normal(size=(7, 3)).astype(np.float32)
    vec[3] = 0.0  # padding edge: zero harmonics for l >= 1
    got = spherical_harmonics(irreps, torch.as_tensor(vec))
    _close(got, jsh(irreps, jnp.asarray(vec)))


@pytest.mark.parametrize("irreps", IRREPS)
def test_structure_ops_match_jax(rng, irreps):
    ir = Irreps(irreps)
    x1 = rng.normal(size=(5, ir.dim)).astype(np.float32)
    x2 = rng.normal(size=(5, ir.dim)).astype(np.float32)
    s = rng.normal(size=(5, ir.num_irreps)).astype(np.float32)
    t = torch.as_tensor
    _close(o3ops.scalar_gate(t(x1), t(s), irreps),
           jo3.scalar_gate(jnp.asarray(x1), jnp.asarray(s), irreps))
    _close(o3ops.equivariant_dot(t(x1), t(x2), irreps),
           jo3.equivariant_dot(jnp.asarray(x1), jnp.asarray(x2), irreps))
    _close(o3ops.invariant(t(x1), irreps), jo3.invariant(jnp.asarray(x1), irreps))
    g, sm, (mask, idx, gates) = o3ops.structure(ir)
    jg, js, (jmask, jidx, jgates) = jo3._structure(jo3.Irreps(irreps))
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(sm, js)
    np.testing.assert_array_equal(idx, jidx)
    w = rng.normal(size=(ir.num_irreps,)).astype(np.float32)
    n_s = max(sum(m for m, i in ir if i.l == 0 and i.p == 1), 1)
    b = rng.normal(size=(n_s,)).astype(np.float32)
    _close(o3ops.equivariant_layer_norm(t(x1), irreps, t(w), t(b)),
           jo3.equivariant_layer_norm(jnp.asarray(x1), irreps, jnp.asarray(w),
                                      jnp.asarray(b)))
    chunks = split_flat(t(x1), ir)
    assert torch.equal(cat_flat(chunks, ir), t(x1))


@pytest.mark.parametrize("irreps", IRREPS[1:])
def test_o3_layers_match_jax(rng, irreps):
    ir = Irreps(irreps)
    x = rng.normal(size=(6, ir.dim)).astype(np.float32)
    jm = JO3Linear(jo3.Irreps(irreps), jo3.Irreps(irreps), biases=True)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32), params)
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = O3Linear(ir, ir, biases=True)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()})
    _close(tm(torch.as_tensor(x)), want)
    ln = EquivariantLayerNorm(ir)
    w = rng.normal(size=ln.weight.shape).astype(np.float32)
    b = rng.normal(size=ln.bias.shape).astype(np.float32)
    ln.load_state_dict({"weight": torch.as_tensor(w), "bias": torch.as_tensor(b)})
    _close(ln(torch.as_tensor(x)),
           jo3.equivariant_layer_norm(jnp.asarray(x), irreps, jnp.asarray(w), jnp.asarray(b)))
