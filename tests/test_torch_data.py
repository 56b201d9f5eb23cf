"""The port's host data path (xequinet_torch.data, ops.radius_graph,
ops.slot_layout) against the JAX package: neighbour lists compared as
edge sets, and collate compared bit for bit on every key, including the
kernel slot keys and a slot_cap tail."""

import numpy as np
import pytest

from xequinet_tpu.data import batching as jb
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.data.transforms import NeighborTransform as JNeighborTransform
from xequinet_tpu.ops import radius_graph as jrg
from xequinet_tpu.ops.pallas_scatter_v2 import prepare_v2 as jprepare
from xequinet_torch.data import batching as tb
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.data.transforms import NeighborTransform
from xequinet_torch.ops import radius_graph as trg
from xequinet_torch.ops.slot_layout import prepare_v2


def _edge_set(ei, offs=None):
    rows = [tuple(ei[:, k]) + (() if offs is None else tuple(offs[k]))
            for k in range(ei.shape[1])]
    assert len(rows) == len(set(rows))
    return set(rows)


def _molecule_arrays(rng, n_mols, lo=12, hi=28):
    """bench.py build_batch's geometry recipe (without its labels)."""
    out = []
    for _ in range(n_mols):
        n = int(rng.integers(lo, hi + 1))
        pos = rng.normal(size=(n, 3)) * (n ** (1 / 3)) * 0.9
        out.append((rng.integers(1, 9, size=n).astype(np.int32), pos,
                    float(rng.normal()), rng.normal(size=(n, 3))))
    return out


def _crystal_arrays(rng, n_cells):
    out = []
    for _ in range(n_cells):
        n = int(rng.integers(8, 17))
        cell = np.diag(rng.uniform(4.5, 6.5, size=3)) + rng.normal(size=(3, 3)) * 0.15
        pos = rng.uniform(0, 1, size=(n, 3)) @ cell
        out.append((rng.integers(1, 9, size=n).astype(np.int32), pos, cell))
    return out


def test_radius_graph_edge_sets_match(rng):
    for z, pos, _, _ in _molecule_arrays(rng, 4):
        got, _ = trg.radius_graph_np(pos, 5.0)
        want, _ = jrg.radius_graph_np(pos, 5.0)
        assert _edge_set(got) == _edge_set(want)
    for z, pos, cell in _crystal_arrays(rng, 3):
        pbc = np.array([True, True, False])
        got = trg.radius_graph_pbc_np(pos, cell, pbc, 5.0)
        want = jrg.radius_graph_pbc_np(pos, cell, pbc, 5.0)
        assert _edge_set(*got) == _edge_set(*want)


def test_neighbor_transform_matches(rng):
    z, pos, cell = _crystal_arrays(rng, 1)[0]
    a = NeighborTransform(4.0)(Datapoint(z, pos, cell=cell))
    b = JNeighborTransform(4.0)(JDatapoint(z, pos, cell=cell))
    assert _edge_set(a.edge_index, a.cell_offsets) == _edge_set(b.edge_index, b.cell_offsets)


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("slot_tail", [False, True])
def test_collate_bit_for_bit_molecules(rng, slot_tail):
    dps_t, dps_j = [], []
    for z, pos, e, f in _molecule_arrays(rng, 64):
        ei, _ = jrg.radius_graph_np(pos, 5.0)
        dps_t.append(Datapoint(z, pos, edge_index=ei, energy=e, forces=f))
        dps_j.append(JDatapoint(z, pos, edge_index=ei, energy=e, forces=f))
    layout = {"block_nodes": 512, "chunk": 512, "pad_nodes": 32, "max_chunks": 64}
    args = ()
    if slot_tail:
        n_cap = tb.bucket_capacity(sum(d.num_atoms for d in dps_t))
        e_cap = tb.bucket_capacity(sum(d.num_edges for d in dps_t))
        assert n_cap == jb.bucket_capacity(sum(d.num_atoms for d in dps_j))
        layout["slot_cap"] = tb.kernel_slot_cap(n_cap, e_cap, layout)
        assert layout["slot_cap"] == jb.kernel_slot_cap(n_cap, e_cap, layout)
        args = (n_cap, e_cap, len(dps_t) + 1)
    got = tb.collate(dps_t, *args, kernel_layout=layout)
    want = jb.collate(dps_j, *args, kernel_layout=layout)
    if slot_tail:
        assert got["edge_mask"].shape[0] > got["edge_mask"].sum()
    _assert_same_batch(got, want)
    _assert_same_batch(tb.collate(dps_t), jb.collate(dps_j))


def test_collate_bit_for_bit_crystals(rng):
    dps_t, dps_j = [], []
    for z, pos, cell in _crystal_arrays(rng, 16):
        pbc = np.array([True, True, True])
        ei, offs = jrg.radius_graph_pbc_np(pos, cell, pbc, 5.0)
        v = rng.normal(size=(3, 3))
        dps_t.append(Datapoint(z, pos, cell=cell, pbc=pbc, edge_index=ei,
                               cell_offsets=offs, virial=v))
        dps_j.append(JDatapoint(z, pos, cell=cell, pbc=pbc, edge_index=ei,
                                cell_offsets=offs, virial=v))
    layout = {"block_nodes": 128, "chunk": 512, "pad_nodes": 32, "max_chunks": 128}
    _assert_same_batch(tb.collate(dps_t, kernel_layout=layout),
                       jb.collate(dps_j, kernel_layout=layout))


def test_layout_helpers_match():
    for kw in ({}, {"use_pallas_scatter": "mega", "pallas_layout": (512, 512, 32, 64)},
               {"use_pallas_scatter": "mega-xb"}, {"use_pallas_scatter": True}):
        assert tb.kernel_layout_from_model_kwargs(kw) == jb.kernel_layout_from_model_kwargs(kw)
    for n in (1, 7, 9, 25, 100, 1000, 4097):
        assert tb.bucket_capacity(n) == jb.bucket_capacity(n)


def test_prepare_v2_matches(rng):
    from tests.test_pallas_v2 import molecule_edges

    src, dst, n = molecule_edges(rng, n_mols=12)
    n_pad = ((n + 15) // 16) * 16 + 64
    for got, want in zip(prepare_v2(src, dst, n_pad, 16, 8, 16),
                         jprepare(src, dst, n_pad, 16, 8, 16)):
        np.testing.assert_array_equal(got, want)
