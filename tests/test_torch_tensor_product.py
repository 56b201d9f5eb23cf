"""The port's tensor products, Cartesian change of basis and Wigner-D
matrices (xequinet_torch.ops.tensor_product / cartesian / wigner) against
the JAX package on seeded inputs, and the equivariance of the port's o3
stack on its own.

Against JAX: every mode (uvw, uvu, uvv, uuw, uuu, uvuv) with and without
weights (uvw has none without), shared [numel] and per-sample [...,
numel] weights, under the three irrep and the three path normalisations;
``get_feasible_tp``'s irreps and instructions; ``reduced_tensor_basis``
for ``"ij"``, ``"ij=ji"`` and a rank-3 formula (the same irreps, Q within
1e-12); ``wigner_D`` and ``geometric_rotation_to_irrep_basis``.

On the port alone, with its own ``wigner_D``: the spherical harmonics up
to l = 4, O3Linear, Gate and tensor products commute with a random
rotation.  Tolerance: f32 1e-5 relative to the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xequinet_tpu.ops import cartesian as jcart
from xequinet_tpu.ops import tensor_product as jtp
from xequinet_tpu.ops import wigner as jw
from xequinet_torch.models.o3layer import Gate, O3Linear
from xequinet_torch.models.model import init_params
from xequinet_torch.ops import cartesian as tcart
from xequinet_torch.ops import tensor_product as ttp
from xequinet_torch.ops.irreps import Irreps
from xequinet_torch.ops.spherical import spherical_harmonics
from xequinet_torch.ops.wigner import geometric_rotation_to_irrep_basis, wigner_D

from .helpers import random_rotation

# uv modes pair any multiplicities; uu modes need equal ones, and their
# paths (0e x 1o -> 1o, 1o x 0e -> 1o, 1o x 1o -> 2e) take each of the three
# first products.  Small, so that the JAX package compiles few einsums
IN_UV = ("2x0e+2x1o", "1x0e+2x1e")
IN_UU = ("2x0e+2x1o", "2x0e+2x1o")
FILTER = "2x0e+2x1o+1x2e+1x1e"
MODES = [(m, w) for m in ttp.MODES for w in (True, False) if (m, w) != ("uvw", False)]


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _rel(got, want, tol):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-12), err


@pytest.mark.parametrize("mode,weighted", MODES)
def test_tensor_product_matches_jax(mode, weighted):
    rng = np.random.default_rng(len(mode) + weighted)
    in1, in2 = IN_UU if mode.startswith("uu") else IN_UV
    want_irreps, want_ins = jtp.get_feasible_tp(in1, in2, FILTER, mode, weighted)
    irreps, ins = ttp.get_feasible_tp(in1, in2, FILTER, mode, weighted)
    assert str(irreps) == str(want_irreps)
    assert [tuple(i) for i in ins] == [tuple(i) for i in want_ins]
    for irrep_norm in ("component", "norm", "none"):
        for path_norm in ("element", "path", "none"):
            jt = jtp.TensorProduct(in1, in2, want_irreps, want_ins, irrep_norm, path_norm)
            tt = ttp.TensorProduct(in1, in2, irreps, ins, irrep_norm, path_norm)
            assert tt.alphas == jt.alphas and tt.weight_numel == jt.weight_numel
            x1 = rng.normal(size=(4, 5, tt.irreps_in1.dim)).astype(np.float32)
            x2 = rng.normal(size=(4, 5, tt.irreps_in2.dim)).astype(np.float32)
            for shape in ((tt.weight_numel,), (4, 5, tt.weight_numel)) if weighted else [None]:
                w = None if shape is None else rng.normal(size=shape).astype(np.float32)
                want = jt.apply(jnp.asarray(x1), jnp.asarray(x2),
                                None if w is None else jnp.asarray(w))
                got = tt.apply(torch.as_tensor(x1), torch.as_tensor(x2),
                               None if w is None else torch.as_tensor(w))
                _rel(got.numpy(), np.asarray(want), 1e-5)


def test_uvw_without_weights_raises():
    irreps, ins = ttp.get_feasible_tp(*IN_UV, FILTER, "uvw", False)
    x1, x2 = torch.ones(2, Irreps(IN_UV[0]).dim), torch.ones(2, Irreps(IN_UV[1]).dim)
    with pytest.raises(ValueError, match="needs weights"):
        ttp.TensorProduct(*IN_UV, irreps, ins).apply(x1, x2)
    with pytest.raises(ValueError, match="pairs channels"):
        ttp.get_feasible_tp(*IN_UV, FILTER, "uuu")


@pytest.mark.parametrize("formula", ["ij", "ij=ji", "ijk=jik"])
def test_reduced_tensor_basis_matches_jax(formula):
    irreps, q = tcart.reduced_tensor_basis(formula)
    want_irreps, want_q = jcart.reduced_tensor_basis(formula)
    assert str(irreps) == str(want_irreps) and q.shape == want_q.shape
    np.testing.assert_allclose(q, want_q, rtol=0, atol=1e-12)
    np.testing.assert_allclose(q @ q.T, np.eye(q.shape[0]), atol=1e-10)  # orthonormal rows


def test_wigner_D_matches_jax():
    rng = np.random.default_rng(12)
    for _ in range(3):
        rot = random_rotation(rng)
        r_irrep = geometric_rotation_to_irrep_basis(rot)
        np.testing.assert_allclose(r_irrep, jw.geometric_rotation_to_irrep_basis(rot),
                                   atol=1e-15)
        for l in range(5):
            d = wigner_D(l, r_irrep)
            np.testing.assert_allclose(d, jw.wigner_D(l, r_irrep), atol=1e-10)
            np.testing.assert_allclose(d @ d.T, np.eye(2 * l + 1), atol=1e-10)
    # a half turn, where the logarithm's axis comes from R + I
    half = geometric_rotation_to_irrep_basis(np.diag([1.0, -1.0, -1.0]))
    np.testing.assert_allclose(wigner_D(1, half), half, atol=1e-12)


def irreps_D(irreps, rot):
    """Block-diagonal Wigner-D of a geometric rotation on a flat irreps
    array, from the port's own matrices (parity plays no part)."""
    r_irrep = geometric_rotation_to_irrep_basis(rot)
    blocks = [wigner_D(ir.l, r_irrep) for mul, ir in Irreps(irreps) for _ in range(mul)]
    out = np.zeros((sum(b.shape[0] for b in blocks),) * 2)
    off = 0
    for b in blocks:
        out[off:off + len(b), off:off + len(b)] = b
        off += len(b)
    return out


def _rotate(x, irreps, rot):
    return torch.as_tensor((np.asarray(x, np.float64) @ irreps_D(irreps, rot).T)
                           .astype(np.float32))


def test_spherical_harmonics_rotate_with_wigner_D():
    rng = np.random.default_rng(21)
    irreps = "1x0e+1x1o+1x2e+1x3o+1x4e"
    vec = rng.normal(size=(9, 3))
    rot = random_rotation(rng)
    # the harmonics take vectors in the irrep basis: [x, y, z] -> [y, z, x]
    sh = lambda v: spherical_harmonics(irreps, torch.as_tensor(v).roll(-1, dims=-1)).numpy()
    _rel(sh(vec @ rot.T), sh(vec) @ irreps_D(irreps, rot).T, 1e-10)


@pytest.mark.parametrize("layer", ["o3linear", "gate", "uuu", "uvw", "uuw"])
def test_port_layers_commute_with_rotation(layer):
    """f(D x) = D f(x) for the port's equivariant layers (seeded weights)."""
    rng = np.random.default_rng(31)
    irreps_in = "4x0e+3x1o+2x2e+2x3o"
    rot = random_rotation(rng)
    x = rng.normal(size=(6, Irreps(irreps_in).dim)).astype(np.float32)
    if layer in ("o3linear", "gate"):
        irreps_out = "3x0e+2x1o+2x2e+1x3o" if layer == "o3linear" else irreps_in
        f = init_params(O3Linear(irreps_in, irreps_out, biases=True) if layer == "o3linear"
                        else Gate(irreps_in, refine=True), seed=2)
        apply = lambda a: f(a)
    else:
        uu = layer.startswith("uu")
        in_tp = "3x0e+3x1o+3x2e+3x3o" if uu else irreps_in
        x = rng.normal(size=(6, Irreps(in_tp).dim)).astype(np.float32)
        irreps_in = in_tp
        irreps_out, ins = ttp.get_feasible_tp(in_tp, in_tp, "2x0e+2x1o+2x2e+1x3o+1x4e",
                                              layer)
        tp = ttp.TensorProduct(in_tp, in_tp, irreps_out, ins)
        w = torch.as_tensor(rng.normal(size=tp.weight_numel).astype(np.float32))
        apply = lambda a: tp.apply(a, a, w)
    with torch.no_grad():
        got = apply(_rotate(x, irreps_in, rot)).numpy()
        want = apply(torch.as_tensor(x)).numpy() @ irreps_D(irreps_out, rot).T
    _rel(got, want, 1e-5)
