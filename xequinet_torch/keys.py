"""Canonical string keys for the blackboard-dict dataflow.

Copy of ``xequinet_tpu/keys.py`` (the port imports nothing of the JAX
package): models thread a flat ``Dict[str, torch.Tensor]`` through the
blocks.  The padding masks (NODE_MASK/EDGE_MASK/GRAPH_MASK) and the
kernel slot-layout keys come from the static-shape batch design.
"""

from typing import Dict, Final, Set

# basic keys in datapoints
POSITIONS: Final[str] = "pos"
ATOMIC_NUMBERS: Final[str] = "atomic_numbers"
EDGE_INDEX: Final[str] = "edge_index"
CELL_OFFSETS: Final[str] = "cell_offsets"
CELL: Final[str] = "cell"
PBC: Final[str] = "pbc"
# keys for collated batches
BATCH: Final[str] = "batch"
BATCH_PTR: Final[str] = "ptr"
NUM_GRAPHS: Final[str] = "num_graphs"

# padding masks (static-shape batching)
NODE_MASK: Final[str] = "node_mask"
EDGE_MASK: Final[str] = "edge_mask"
GRAPH_MASK: Final[str] = "graph_mask"
NUM_ATOMS: Final[str] = "num_atoms"  # per-graph real atom counts

# pallas kernel layout (block-aligned edge slots; see ops/pallas_scatter_v2)
K_SRC2: Final[str] = "k_src2"
K_DST2: Final[str] = "k_dst2"
K_CHUNK_BASE: Final[str] = "k_chunk_base"
K_NCHUNKS: Final[str] = "k_nchunks"
K_WSTARTS: Final[str] = "k_window_starts"
K_EDGE_FEAT: Final[str] = "k_edge_feat"  # packed [E,128] rbf/fcut/Y stream

# periodic ghost images for banded-window kernels (ops/spatial_sort):
# ghost rows mirror a real atom at a shifted lattice image — positions are
# derived in-graph (models/properties), features refreshed per message block
GHOST_MAP: Final[str] = "ghost_map"  # [N] owning real row (identity on reals)
GHOST_SHIFT: Final[str] = "ghost_shift"  # [N, 3] integer lattice shift

# intermediate variables
CENTER_IDX: Final[int] = 0
NEIGHBOR_IDX: Final[int] = 1
EDGE_LENGTH: Final[str] = "edge_length"
EDGE_VECTOR: Final[str] = "edge_vector"
STRAIN: Final[str] = "strain"

RADIAL_BASIS_FUNCTION: Final[str] = "radial_basis_function"
ENVELOPE_FUNCTION: Final[str] = "envelope_function"
SPHERICAL_HARMONICS: Final[str] = "spherical_harmonics"
NODE_INVARIANT: Final[str] = "node_invariant"
NODE_EQUIVARIANT: Final[str] = "node_equivariant"

# Ewald message passing
K_DOT_R: Final[str] = "k_dot_r"
SINC_DAMPING: Final[str] = "sinc_damping"
DOWN_PROJECTION: Final[str] = "down_projection"

# properties
ATOMIC_ENERGIES: Final[str] = "atomic_energies"
TOTAL_ENERGY: Final[str] = "energy"
BASE_ENERGY: Final[str] = "base_energy"
ENERGY_PER_ATOM: Final[str] = "energy/atom"
FORCES: Final[str] = "forces"
BASE_FORCES: Final[str] = "base_forces"
VIRIAL: Final[str] = "virial"
STRESS: Final[str] = "stress"
ATOMIC_CHARGES: Final[str] = "atomic_charges"
BASE_CHARGES: Final[str] = "base_charges"
TOTAL_CHARGE: Final[str] = "charge"
TOTAL_SPIN: Final[str] = "spin"

# QC-matrix learning (QHNet-style; models/xmatnet.py): per-node diagonal
# and per-edge off-diagonal blocks of an AO-basis operator matrix
NODE_MAT_BLOCKS: Final[str] = "node_mat_blocks"
EDGE_MAT_BLOCKS: Final[str] = "edge_mat_blocks"

# axis registry for labels: collate padding, loss/metric masking and the
# NeighborTransform edge-rebuild guard all dispatch on these, NOT on
# shape heuristics (leading dims are ambiguous, e.g. diatomics have
# num_atoms == num_edges)
NODE_LEVEL_PROPERTIES: Final[Set[str]] = {
    "forces", "base_forces", "atomic_charges", "base_charges",
    "atomic_energies", NODE_MAT_BLOCKS,
}
EDGE_LEVEL_PROPERTIES: Final[Set[str]] = {EDGE_MAT_BLOCKS}

DIPOLE: Final[str] = "dipole"
BASE_DIPOLE: Final[str] = "base_dipole"
DIPOLE_MAGNITUDE: Final[str] = "dipole_magnitude"
POLARIZABILITY: Final[str] = "polarizability"
ISO_POLARIZABILITY: Final[str] = "iso_polarizability"

# properties obtained by autodiff of the energy
GRAD_PROPERTIES: Final[Set[str]] = {FORCES, BASE_FORCES, VIRIAL}
# delta-learning base properties
BASE_PROPERTIES: Final[Dict[str, str]] = {
    BASE_ENERGY: TOTAL_ENERGY,
    BASE_FORCES: FORCES,
    BASE_CHARGES: ATOMIC_CHARGES,
    BASE_DIPOLE: DIPOLE,
}
STANDARD_PROPERTIES: Final[Set[str]] = {
    TOTAL_ENERGY,
    FORCES,
    VIRIAL,
    DIPOLE,
    POLARIZABILITY,
}
VECTOR_PROPERTIES: Final[Set[str]] = {DIPOLE}
ATOMIC_VECTOR_PROPERTIES: Final[Set[str]] = {FORCES}

SPATIAL_EXTENT: Final[str] = "spatial_extent"

# general-purpose properties
SCALAR_OUTPUT: Final[str] = "scalar_output"
CARTESIAN_TENSOR: Final[str] = "cartesian_tensor"

# Verlet skin lists (interface/calculator.py): when present, the edge
# list was built at cutoff+skin and compute_edge_data tightens EDGE_MASK
# to dist <= EDGE_CUTOFF on the device — so every MD step between
# rebuilds re-uploads only positions
EDGE_CUTOFF: Final[str] = "edge_cutoff"

# every key a forward pass can emit as a USER-FACING output.  The
# interface layers project the blackboard dict onto this set before
# fetching from the device: the intermediates
# (edge features, equivariant node states, ...) are megabytes, and
# device->host transfer is the MD hot-loop tail, so only these are
# copied back to the host.
OUTPUT_PROPERTIES: Final[Set[str]] = {
    ATOMIC_ENERGIES, TOTAL_ENERGY, FORCES, VIRIAL, ATOMIC_CHARGES,
    DIPOLE, DIPOLE_MAGNITUDE, POLARIZABILITY, ISO_POLARIZABILITY,
    SPATIAL_EXTENT, SCALAR_OUTPUT, CARTESIAN_TENSOR,
    NODE_MAT_BLOCKS, EDGE_MAT_BLOCKS,
}

# xTB methods
xTB_METHODS: Final[Dict[str, str]] = {
    "gfn1-xtb": "GFN1-xTB",
    "gfn2-xtb": "GFN2-xTB",
}

# others
TRAIN: Final[str] = "train"
VALID: Final[str] = "valid"
TEST: Final[str] = "test"

# deployment metadata
CUTOFF_RADIUS: Final[str] = "cutoff_radius"
N_SPECIES: Final[str] = "n_species"
PERIODIC_TABLE: Final[str] = "periodic_table"
LAMMPS_UNIT_STYLE: Final[Dict[str, Dict[str, str]]] = {
    "metal": {
        TOTAL_ENERGY: "eV",
        POSITIONS: "Angstrom",
        FORCES: "eV/Angstrom",
        TOTAL_CHARGE: "e",
    },
    "real": {
        TOTAL_ENERGY: "kcal/mol",
        POSITIONS: "Angstrom",
        FORCES: "kcal/mol/Angstrom",
        TOTAL_CHARGE: "e",
    },
    "electron": {
        TOTAL_ENERGY: "Hartree",
        POSITIONS: "Bohr",
        FORCES: "Hartree/Bohr",
        TOTAL_CHARGE: "e",
    },
}
