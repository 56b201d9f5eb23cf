"""The port's host data path (xequinet_torch.data, ops.radius_graph,
ops.slot_layout) against the JAX package: neighbour lists compared as
edge sets, collate compared bit for bit on every key, including the
kernel slot keys and a slot_cap tail, the XDB store read across the two
packages byte for byte, the loader's batches bit for bit for one seed,
and the unit transform."""

import numpy as np
import pytest

from xequinet_tpu.data import batching as jb
from xequinet_tpu.data import dataset as jds
from xequinet_tpu.data import store as jstore
from xequinet_tpu.data import transforms as jtf
from xequinet_tpu.data.datapoint import Datapoint as JDatapoint
from xequinet_tpu.data.transforms import NeighborTransform as JNeighborTransform
from xequinet_tpu.ops import radius_graph as jrg
from xequinet_tpu.ops.pallas_scatter_v2 import prepare_v2 as jprepare
from xequinet_torch.data import batching as tb
from xequinet_torch.data import dataset as tds
from xequinet_torch.data import store as tstore
from xequinet_torch.data import transforms as ttf
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
               {"use_pallas_scatter": "mega-xb"}):
        assert tb.kernel_layout_from_model_kwargs(kw) == jb.kernel_layout_from_model_kwargs(kw)
    # the v2 route: the port's entry points emit the layout the JAX
    # package's emit for the mega route (the JAX ones emit none, and run a v2
    # model on its XLA path; ROADMAP section 3)
    for mode in (True, "v2"):
        for lay in ({}, {"pallas_layout": (512, 512, 32, 64)}):
            kw = dict(lay, use_pallas_scatter=mode)
            assert jb.kernel_layout_from_model_kwargs(kw) is None
            assert tb.kernel_layout_from_model_kwargs(kw) == \
                jb.kernel_layout_from_model_kwargs(dict(lay, use_pallas_scatter="mega"))
    for n in (1, 7, 9, 25, 100, 1000, 4097):
        assert tb.bucket_capacity(n) == jb.bucket_capacity(n)


@pytest.mark.parametrize("big", [30, 40])
def test_fit_kernel_layout_takes_large_molecules(rng, big):
    """A molecule larger than the model's window (pallas_layout (8, 8, 4,
    16)): the model's own layout refuses the batch, the fitted one keeps BN
    and chunk, raises pad_nodes to the molecule rounded up to 8, drops the
    max_chunks cap, and collates the batch bit for bit as the JAX package's
    collate does with that layout."""
    dps_t, dps_j = [], []
    # no labels: the JAX collate leaves a forces label un-padded when the
    # layout re-pads the nodes (ROADMAP section 3)
    for z, pos, _, _ in _molecule_arrays(rng, 2, 5, 9) + _molecule_arrays(rng, 1, big, big):
        ei, _ = jrg.radius_graph_np(pos, 5.0)
        dps_t.append(Datapoint(z, pos, edge_index=ei))
        dps_j.append(JDatapoint(z, pos, edge_index=ei))
    model = tb.kernel_layout_from_model_kwargs(
        {"use_pallas_scatter": "mega", "pallas_layout": (8, 8, 4, 16)})
    n_cap = tb.bucket_capacity(sum(d.num_atoms for d in dps_t))
    e_cap = tb.bucket_capacity(sum(d.num_edges for d in dps_t))
    args = (n_cap, e_cap, len(dps_t) + 1)
    own = dict(model, slot_cap=tb.kernel_slot_cap(n_cap, e_cap, model))
    with pytest.raises(ValueError, match="window"):
        tb.collate(dps_t, *args, kernel_layout=own)
    fitted = tb.fit_kernel_layout(model, big, n_cap, e_cap)
    pad = (big + 7) // 8 * 8
    assert fitted == {"block_nodes": 8, "chunk": 8, "pad_nodes": pad, "max_chunks": 0,
                      "slot_cap": tb.kernel_slot_cap(n_cap, e_cap, dict(model, pad_nodes=pad))}
    got = tb.collate(dps_t, *args, kernel_layout=fitted)
    _assert_same_batch(got, jb.collate(dps_j, *args, kernel_layout=fitted))
    assert int(got["edge_mask"].sum()) == sum(d.num_edges for d in dps_t)


def test_prepare_v2_matches(rng):
    from tests.test_pallas_v2 import molecule_edges

    src, dst, n = molecule_edges(rng, n_mols=12)
    n_pad = ((n + 15) // 16) * 16 + 64
    for got, want in zip(prepare_v2(src, dst, n_pad, 16, 8, 16),
                         jprepare(src, dst, n_pad, 16, 8, 16)):
        np.testing.assert_array_equal(got, want)


def _labelled_pair(rng, n, cell_every=0):
    """The same structures as port and JAX Datapoints, with labels and an
    extra field; every ``cell_every``-th one periodic."""
    dps_t, dps_j = [], []
    for i in range(n):
        k = int(rng.integers(3, 9))
        kw = dict(atomic_numbers=rng.integers(1, 9, k), pos=rng.normal(size=(k, 3)) * 1.5,
                  energy=float(rng.normal()), forces=rng.normal(size=(k, 3)), charge=0,
                  extras={"tag": np.arange(k, dtype=np.int32)})
        if cell_every and i % cell_every == 0:
            kw.update(cell=np.eye(3) * 6.0, pbc=np.array([True, True, False]),
                      virial=rng.normal(size=(3, 3)))
        dps_t.append(Datapoint(**kw))
        dps_j.append(JDatapoint(**kw))
    return dps_t, dps_j


def _assert_same_datapoint(a, b):
    for f in ("atomic_numbers", "pos", "pbc", "cell", "edge_index", "cell_offsets", "forces",
              "virial", "charge", "spin", "energy"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f)
            assert np.asarray(x).dtype == np.asarray(y).dtype, f
    assert sorted(a.extras) == sorted(b.extras)
    for k in a.extras:
        np.testing.assert_array_equal(a.extras[k], b.extras[k])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_xdb_store_read_across_packages(tmp_path, rng, writer):
    """A dataset written by one package's create_dataset is read by the
    other's XDBDataset field for field, and the two writers' files are
    the same bytes."""
    dps_t, dps_j = _labelled_pair(rng, 10, cell_every=3)
    units = {"energy": "eV", "pos": "Angstrom"}
    jstore.create_dataset(tmp_path / "j", dps_j, units=units)
    tstore.create_dataset(tmp_path / "t", dps_t, units=units)
    for f in ("data.xdb", "info.json", "split.json"):
        assert (tmp_path / "j" / f).read_bytes() == (tmp_path / "t" / f).read_bytes(), f
    src = tmp_path / ("j" if writer == "jax" else "t")
    got = (tstore if writer == "jax" else jstore).XDBDataset(src, split="train")
    want = (jstore if writer == "jax" else tstore).XDBDataset(src, split="train")
    assert len(got) == len(want) == 8 and got.units == units
    for i in range(len(want)):
        _assert_same_datapoint(got[i], want[i])


@pytest.mark.parametrize("layout", [None, {"block_nodes": 16, "chunk": 16, "pad_nodes": 16,
                                           "max_chunks": 32}])
def test_dataloader_batches_bit_for_bit(rng, layout):
    """Shuffled by seed, capacity-packed, with the kernel slot layout at a
    fixed slot_cap: the same batches as the JAX loader over two epochs,
    the port's through its prefetch thread."""
    dps_t, dps_j = _labelled_pair(rng, 30)
    for a, b in zip(dps_t, dps_j):  # one edge list: the radius graphs order edges apart
        a.edge_index = b.edge_index = jrg.radius_graph_np(b.pos, 5.0)[0].astype(np.int64)
    ds_t, ds_j = tds.InMemoryDataset(dps_t), jds.InMemoryDataset(dps_j)
    caps_t = tds.compute_capacities(ds_t, 6)
    assert caps_t == jds.compute_capacities(ds_j, 6)
    if layout:  # node capacity a multiple of block_nodes covering the window
        caps_t["n_nodes"] = 64
    lt = tds.DataLoader(ds_t, 6, capacities=dict(caps_t), shuffle=True, seed=3,
                        kernel_layout=layout, prefetch=2)
    lj = jds.DataLoader(ds_j, 6, capacities=dict(caps_t), shuffle=True, seed=3,
                        kernel_layout=layout)
    assert len(lt) == len(lj)
    for epoch in (0, 1):
        lt.set_epoch(epoch)
        lj.set_epoch(epoch)
        got, want = list(lt), list(lj)
        assert len(got) == len(want) > 1
        for a, b in zip(got, want):
            _assert_same_batch(a, b)
    assert tds.calculate_stats(ds_t, ["energy"]) == jds.calculate_stats(ds_j, ["energy"])


def test_unit_transform_pipeline_matches(rng):
    units = {"energy": "kcal/mol", "pos": "Bohr", "forces": "kcal/mol/Bohr"}
    (a,), (b,) = _labelled_pair(rng, 1, cell_every=1)
    got = ttf.build_transform_pipeline(data_units=units, cutoff=4.0)(a)
    want = jtf.build_transform_pipeline(data_units=units, cutoff=4.0)(b)
    assert got.energy == want.energy
    for f in ("pos", "cell", "forces", "virial"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert _edge_set(got.edge_index, got.cell_offsets) == _edge_set(want.edge_index,
                                                                   want.cell_offsets)
    # delta learning: the same target as the JAX pipeline gives
    (a,), (b,) = _labelled_pair(rng, 1, cell_every=1)
    a.base_energy = b.base_energy = 0.75
    got = ttf.build_transform_pipeline(base_targets=["energy"])(a)
    want = jtf.build_transform_pipeline(base_targets=["energy"])(b)
    assert got.energy == want.energy and got.base_energy is None
