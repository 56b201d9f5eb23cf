"""``xeq-torch export``: ahead-of-time export of the single-structure
forward, for deployment.

Port of ``xequinet_tpu/interface/export.py``.  The JAX package writes a
serialized StableHLO module; the port writes a ``torch.export`` program
(``model.pt2``, read back by ``torch.export.load`` from Python or by
AOTInductor's packaging from C++) beside the same ``manifest.json``
(cutoff in deployment units, species, periodic table, unit style,
capacities, signature).  The program holds the forward and, for energies,
the forces (and virial) by autograd: the function is traced once with
``make_fx`` (autograd's backward ops become graph nodes) and that graph is
exported.  ``torch.export.export`` of the function itself cannot take
``torch.autograd.grad``.

Modes (``interface/jit_model.py``'s deployment models of the reference):

* ``energy``: positions, atomic numbers and a neighbour list in, energy,
  forces (and virial) out; with ``periodic=True`` also the cell and the
  edges' integer cell offsets;
* ``dipole``: atomic charges and the total dipole;
* ``gmx``: ``(positions, atomic_numbers, box, pbc, total_charge) ->
  (energy, forces, n_edges_found, needed_reps)`` with the neighbour list
  built inside the program (``ops/radius_graph.radius_graph_pbc_fixed``),
  in nm and kJ/mol;
* ``matrix``: XMatNet's node and edge blocks, in model units.

The ``total_charge`` input is wired into the data dict, or ``net_charge``
bakes a constant.  As in the JAX package the program runs the model's
plain route: a checkpoint of a kernel route is rebuilt with
``use_pallas_scatter=False`` on the same weights (the message kernels are
ctypes calls, which a traced graph cannot hold).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import keys
from ..utils.qc import ELEMENTS_LIST, get_default_units, unit_conversion

GMX_UNITS = {
    keys.TOTAL_ENERGY: "kJ/mol",
    keys.POSITIONS: "nm",
    keys.FORCES: "kJ/mol/nm",
    keys.TOTAL_CHARGE: "e",
}

Forward = Callable[..., dict]


def _base_data(pos, atomic_numbers, edge_index, edge_mask, total_charge,
               pos_conv: float, net_charge: Optional[int]):
    """The one-graph data dict of a structure padded to ``pos.shape[0]``
    atom slots (atomic number 0 marks padding)."""
    n, dev = pos.shape[0], pos.device
    node_mask = atomic_numbers > 0
    data = {
        keys.POSITIONS: pos * (1.0 / pos_conv),
        keys.ATOMIC_NUMBERS: atomic_numbers,
        keys.EDGE_INDEX: edge_index,
        keys.EDGE_MASK: edge_mask,
        keys.NODE_MASK: node_mask,
        keys.BATCH: torch.zeros(n, dtype=torch.int32, device=dev),
        keys.GRAPH_MASK: torch.ones(1, dtype=torch.bool, device=dev),
        keys.NUM_ATOMS: node_mask.sum(dtype=torch.int32).reshape(1),
        keys.BATCH_PTR: torch.tensor([0, n], dtype=torch.int32, device=dev),
    }
    if net_charge is not None:
        data[keys.TOTAL_CHARGE] = torch.tensor([net_charge], dtype=torch.int32, device=dev)
    else:
        data[keys.TOTAL_CHARGE] = total_charge
    return data


def make_batchless_forward(forward: Forward, energy_conv: float, pos_conv: float,
                           compute_virial: bool = False, net_charge: Optional[int] = None,
                           periodic: bool = False, output_mode: str = "energy"):
    """Single-structure function in deployment units around
    ``forward(data, compute_forces, compute_virial)``
    (``models/properties.make_forward``).  Its arguments are (pos,
    atomic_numbers, edge_index, edge_mask[, cell_offsets, cell],
    total_charge); the cell is in deployment length units."""

    def run(data):
        if output_mode == "matrix":
            out = forward(data, False, False)
            return out[keys.NODE_MAT_BLOCKS], out[keys.EDGE_MAT_BLOCKS]
        if output_mode == "dipole":
            out = forward(data, False, False)
            return out[keys.ATOMIC_CHARGES], out[keys.DIPOLE][0] * pos_conv
        out = forward(data, True, compute_virial)
        res = (out[keys.TOTAL_ENERGY][0] * energy_conv,
               out[keys.FORCES] * (energy_conv / pos_conv))
        if compute_virial:
            res = res + (out[keys.VIRIAL][0] * energy_conv,)
        return res

    if periodic:
        def fn(pos, atomic_numbers, edge_index, edge_mask, cell_offsets, cell, total_charge):
            data = _base_data(pos, atomic_numbers, edge_index, edge_mask, total_charge,
                              pos_conv, net_charge)
            data[keys.CELL] = (cell * (1.0 / pos_conv))[None]
            data[keys.CELL_OFFSETS] = cell_offsets
            return run(data)
    else:
        def fn(pos, atomic_numbers, edge_index, edge_mask, total_charge):
            data = _base_data(pos, atomic_numbers, edge_index, edge_mask, total_charge,
                              pos_conv, net_charge)
            return run(data)

    return fn


def make_selfcontained_forward(forward: Forward, cutoff: float, e_cap: int,
                               energy_conv: float, pos_conv: float, max_reps: int = 1,
                               net_charge: Optional[int] = None):
    """The ``gmx`` function: ``(positions, atomic_numbers, box, pbc,
    total_charge) -> (energy, forces, n_edges_found, needed_reps)`` with
    the neighbour list built inside.  The caller checks ``n_edges_found <=
    max_edges`` and ``max(needed_reps) <= max_reps`` (manifest keys):
    images past the static [-max_reps, max_reps]^3 grid are not generated."""
    from ..ops.radius_graph import radius_graph_pbc_fixed

    def fn(pos, atomic_numbers, box, pbc, total_charge):
        pos_model = pos * (1.0 / pos_conv)
        cell_model = box * (1.0 / pos_conv)
        node_mask = atomic_numbers > 0
        # along no periodic axis an identity cell keeps the plane distances
        # finite; pbc masks those images
        safe_cell = torch.where(pbc.any(), cell_model,
                                torch.eye(3, dtype=pos.dtype, device=pos.device))
        edge_index, edge_mask, cell_offsets, n_found, needed = radius_graph_pbc_fixed(
            pos_model, safe_cell, pbc, cutoff, e_cap, max_reps=max_reps, node_mask=node_mask)
        data = _base_data(pos, atomic_numbers, edge_index, edge_mask, total_charge, pos_conv,
                          net_charge)
        data[keys.CELL] = safe_cell[None]
        data[keys.CELL_OFFSETS] = cell_offsets
        out = forward(data, True, False)
        return (out[keys.TOTAL_ENERGY][0] * energy_conv,
                out[keys.FORCES] * (energy_conv / pos_conv), n_found, needed)

    return fn


def _sample_args(output_mode: str, periodic: bool, max_atoms: int, max_edges: int, device):
    """Example inputs of the signature (the JAX export's shapes and
    dtypes), and the signature's description."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=device)
    pos = t(rng.normal(size=(max_atoms, 3)).astype(np.float32))
    z = t(rng.integers(1, 9, max_atoms).astype(np.int32))
    charge = t(np.zeros(1, dtype=np.int32))
    if output_mode == "gmx":
        args = (pos, z, t(np.eye(3, dtype=np.float32) * 10.0), t(np.ones(3, dtype=bool)), charge)
        return args, ("positions[f32,N,3] atomic_numbers[i32,N] box[f32,3,3] pbc[bool,3] "
                      "total_charge[i32,1]")
    args = (pos, z, t(np.zeros((2, max_edges), dtype=np.int32)),
            t(np.zeros(max_edges, dtype=bool)))
    desc = "pos[f32,N,3] atomic_numbers[i32,N] edge_index[i32,2,E] edge_mask[bool,E]"
    if periodic:
        args = args + (t(np.zeros((max_edges, 3), dtype=np.float32)),
                       t(np.eye(3, dtype=np.float32) * 10.0))
        desc += " cell_offsets[f32,E,3] cell[f32,3,3]"
    return args + (charge,), desc + " total_charge[i32,1]"


def _outputs_desc(output_mode: str, compute_virial: bool) -> str:
    if output_mode == "gmx":
        return "energy[f32] forces[f32,N,3] n_edges_found[i32] needed_reps[i32,3]"
    if output_mode == "dipole":
        return "atomic_charges[f32,N] dipole[f32,3]"
    if output_mode == "matrix":
        return "node_mat_blocks[f32,N,D,D] edge_mat_blocks[f32,E,D,D] (model units)"
    return "energy[f32] forces[f32,N,3]" + (" virial[f32,3,3]" if compute_virial else "")


def trace_program(fn: Callable, args: Tuple[torch.Tensor, ...]) -> torch.export.ExportedProgram:
    """``fn`` (forward and autograd) as an exported program.  ``make_fx``
    traces on fake tensors, so an op whose result depends on the data
    (an ``.item()``, a data-dependent shape) fails the export instead of
    baking one structure's value into the program."""
    from torch.fx.experimental.proxy_tensor import make_fx

    graph = make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    return torch.export.export(graph, args)


def export_model(
    ckpt_file: str,
    output: str,
    max_atoms: int = 256,
    max_edges: int = 8192,
    unit_style: str = "metal",
    compute_virial: bool = True,
    output_mode: str = "energy",
    periodic: bool = False,
    net_charge: Optional[int] = None,
    max_reps: int = 1,
    device=None,
) -> str:
    """Write ``output/model.pt2`` and ``output/manifest.json`` for the
    checkpoint (either package's trainer); the program's tensors live on
    ``device`` (None: the card).  Returns ``output``.

    The program is traced from the checkpoint's model on the plain message
    route and without ``remat``: rematerialization changes what a backward
    keeps, not what it computes, and the traced program is one graph with
    its own memory plan (a checkpoint trained with ``remat: true``
    exports the same program as one trained without)."""
    from ..models.model import resolve_model
    from ..models.properties import make_forward
    from ..run.inference import load_model_from_checkpoint, resolve_device

    dev = resolve_device(device)
    loaded, extra, cutoff, _, mc = load_model_from_checkpoint(ckpt_file)
    module, _, _ = resolve_model(mc["model_name"], **dict(
        mc["model_kwargs"], use_pallas_scatter=False, remat=False))
    module.load_state_dict(loaded.state_dict())
    module = module.to(dev).eval().requires_grad_(False)
    forward = make_forward(module, extra)

    target_units = GMX_UNITS if output_mode == "gmx" else keys.LAMMPS_UNIT_STYLE[unit_style]
    model_units = get_default_units()
    e_conv = unit_conversion(model_units.get(keys.TOTAL_ENERGY, "eV"),
                             target_units[keys.TOTAL_ENERGY])
    # deployment length per model length
    p_conv = 1.0 / unit_conversion(target_units[keys.POSITIONS],
                                   model_units.get(keys.POSITIONS, "Angstrom"))
    if output_mode == "gmx":
        fn = make_selfcontained_forward(forward, float(cutoff), max_edges, e_conv, p_conv,
                                        max_reps=max_reps, net_charge=net_charge)
    else:
        fn = make_batchless_forward(forward, e_conv, p_conv, compute_virial=compute_virial,
                                    net_charge=net_charge, periodic=periodic,
                                    output_mode=output_mode)
    args, inputs_desc = _sample_args(output_mode, periodic, max_atoms, max_edges, dev)
    program = trace_program(fn, args)

    os.makedirs(output, exist_ok=True)
    torch.export.save(program, os.path.join(output, "model.pt2"))
    manifest = {
        # p_conv is deployment-per-model length, so the cutoff multiplies
        keys.CUTOFF_RADIUS: float(cutoff) * p_conv,
        keys.N_SPECIES: 100,
        keys.PERIODIC_TABLE: " ".join(ELEMENTS_LIST[1:]),
        "unit_style": "gmx" if output_mode == "gmx" else unit_style,
        "max_atoms": max_atoms,
        "max_edges": max_edges,
        "compute_virial": compute_virial and output_mode == "energy",
        "output_mode": output_mode,
        "periodic": bool(periodic or output_mode == "gmx"),
        "net_charge": net_charge,
        "max_reps": max_reps if output_mode == "gmx" else None,
        "model_name": mc["model_name"],
        "inputs": inputs_desc,
        "outputs": _outputs_desc(output_mode, compute_virial),
    }
    if output_mode == "matrix":
        manifest["target_basis"] = mc["model_kwargs"].get("target_basis")
        manifest["elements"] = mc["model_kwargs"].get("elements")
    with open(os.path.join(output, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return output


def load_exported(path: str):
    """``(module, manifest)`` of an export directory: the program's module
    takes the inputs of the manifest's signature, on the device it was
    exported on."""
    program = torch.export.load(os.path.join(path, "model.pt2"))
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return program.module(), manifest


def run_export_from_args(args) -> None:
    out = export_model(
        args.ckpt,
        args.output,
        max_atoms=args.max_atoms,
        max_edges=args.max_edges,
        unit_style=args.unit_style,
        compute_virial=not getattr(args, "no_virial", False),
        output_mode=getattr(args, "mode", "energy"),
        periodic=getattr(args, "periodic", False),
        net_charge=getattr(args, "net_charge", None),
        max_reps=getattr(args, "max_reps", 1),
        device=getattr(args, "device", None),
    )
    print(f"exported to {out}")
