"""``xeq infer``: batch property prediction (every head's output, forces
and virial), with the optional xTB delta correction.

Port of ``xequinet_tpu/run/inference.py`` (``InferenceEngine``,
``_delta_correction``, ``run_infer``, ``run_infer_from_args``) and of
``xequinet_tpu/run/test.py:27-37`` (``load_model_from_checkpoint``).  The
engine runs on the card unless the caller passes ``device="cpu"``.
Results are in the checkpoint's default units (``default_units`` of its
config, set when it is loaded).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import keys
from ..convert import load_checkpoint, load_params
from ..data.batching import (
    bucket_capacity,
    collate,
    fit_kernel_layout,
    kernel_layout_from_model_kwargs,
)
from ..data.datapoint import Datapoint
from ..data.fmt_conversion import read_structures
from ..data.transforms import NeighborTransform
from ..models.model import resolve_model
from ..models.properties import make_forward
from ..utils.logger import ZeroLogger
from ..utils.qc import get_default_units, set_default_units, unit_conversion


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one that raises, unless the
    caller asks for the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def load_model_from_checkpoint(ckpt_file: str, use_ema: bool = True):
    """Rebuild the model from the checkpoint's embedded config (and set
    its default units) and load its (EMA) weights, from either package's
    trainer.  Returns (module, extra, cutoff, blob, config)."""
    blob = load_checkpoint(ckpt_file)
    model_config = blob["config"]
    if model_config.get("default_units"):
        set_default_units(model_config["default_units"])
    module, extra, cutoff = resolve_model(
        model_config["model_name"], **model_config["model_kwargs"]
    )
    key = "ema_model" if (use_ema and "ema_model" in blob) else "model"
    load_params(module, blob[key])
    return module, extra, cutoff, blob, model_config


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


class InferenceEngine:
    """Predictor over single structures or batches, on one device."""

    def __init__(self, ckpt_file: Optional[str] = None, use_ema: bool = True,
                 device=None, *, module: Optional[torch.nn.Module] = None,
                 model_kwargs: Optional[Dict] = None, extra=None,
                 cutoff: Optional[float] = None) -> None:
        """From a JAX-trained checkpoint, or (``module=...``) from a built
        model with its ``model_kwargs``, ``extra`` properties and cutoff."""
        self.device = resolve_device(device)
        if module is None:
            module, extra, cutoff, _, mc = load_model_from_checkpoint(ckpt_file, use_ema)
            model_kwargs = mc["model_kwargs"]
        self.module = module.to(self.device).eval().requires_grad_(False)
        self.extra = extra
        self.cutoff = cutoff
        self.transform = NeighborTransform(cutoff)
        self.forward = make_forward(self.module, extra)
        # models on a kernel route (v2 or mega) keep it at inference:
        # batches carry the slot layout
        self._kernel_layout = kernel_layout_from_model_kwargs(model_kwargs or {})

    def collate(self, dps: List[Datapoint]) -> Dict[str, np.ndarray]:
        """Host-side batch of already-transformed datapoints.

        A model on a kernel route gets the slot layout fitted to the batch
        (``fit_kernel_layout``: its ``pad_nodes`` raised to the largest
        molecule, no ``max_chunks`` cap), so a molecule larger than the
        model's window still serves through the kernels, on the card and
        on the CPU alike (where the JAX engine collates such a batch
        without the layout)."""
        if self._kernel_layout is not None:
            n_cap = bucket_capacity(sum(d.num_atoms for d in dps))
            e_cap = bucket_capacity(max(sum(d.num_edges for d in dps), 1))
            layout = fit_kernel_layout(self._kernel_layout, max(d.num_atoms for d in dps),
                                       n_cap, e_cap)
            return collate(dps, n_cap, e_cap, len(dps) + 1, kernel_layout=layout)
        return collate(dps)

    def forward_batch(self, batch: Dict[str, np.ndarray], compute_forces: bool = True,
                      compute_virial: bool = False) -> Dict[str, torch.Tensor]:
        """User-facing outputs of one collated batch, left on the device."""
        out = self.forward(batch_to_device(batch, self.device), compute_forces,
                           compute_virial)
        return {k: v for k, v in out.items() if k in keys.OUTPUT_PROPERTIES}

    def predict(self, dps: List[Datapoint], compute_forces: bool = True,
                compute_virial: bool = False) -> List[Dict[str, np.ndarray]]:
        dps = [self.transform(dp) for dp in dps]
        out = self.forward_batch(self.collate(dps), compute_forces, compute_virial)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        results = []
        node_off = 0
        for g, dp in enumerate(dps):
            n = dp.num_atoms
            r: Dict[str, np.ndarray] = {}
            for prop in (keys.TOTAL_ENERGY, keys.DIPOLE, keys.POLARIZABILITY, keys.VIRIAL,
                         keys.SCALAR_OUTPUT, keys.SPATIAL_EXTENT, keys.CARTESIAN_TENSOR):
                if prop in out:
                    r[prop] = out[prop][g]
            for prop in (keys.FORCES, keys.ATOMIC_CHARGES, keys.ATOMIC_ENERGIES):
                if prop in out:
                    r[prop] = out[prop][node_off : node_off + n]
            node_off += n
            results.append(r)
        return results


def _delta_correction(dp: Datapoint, result: Dict[str, np.ndarray], method: str):
    """Add the semi-empirical xTB baseline back to one structure's
    prediction, in the default units (requires tblite)."""
    from ..data.fmt_conversion import datapoint_to_xtb

    res = datapoint_to_xtb(dp, method=keys.xTB_METHODS.get(method, method)).singlepoint()
    default = get_default_units()
    energy_unit = default.get(keys.TOTAL_ENERGY, "eV")
    length_unit = default.get(keys.POSITIONS, "Angstrom")
    e_conv = unit_conversion("Hartree", energy_unit)
    f_conv = unit_conversion("Hartree/Bohr", f"{energy_unit}/{length_unit}")
    if keys.TOTAL_ENERGY in result:
        result[keys.TOTAL_ENERGY] = result[keys.TOTAL_ENERGY] + res.get("energy") * e_conv
    if keys.FORCES in result:
        result[keys.FORCES] = result[keys.FORCES] - res.get("gradient") * f_conv
    if keys.VIRIAL in result and res.get("virial") is not None:
        result[keys.VIRIAL] = result[keys.VIRIAL] + res.get("virial") * e_conv
    if keys.ATOMIC_CHARGES in result:
        result[keys.ATOMIC_CHARGES] = result[keys.ATOMIC_CHARGES] + res.get("charges")
    if keys.DIPOLE in result:
        # xTB's dipole is in e Bohr
        result[keys.DIPOLE] = result[keys.DIPOLE] + res.get("dipole") * unit_conversion(
            "Bohr", length_unit)
    return result


def run_infer(
    ckpt_file: str,
    input_file: str,
    input_format: Optional[str] = None,
    output_file: Optional[str] = None,
    compute_forces: bool = True,
    compute_virial: bool = False,
    delta_method: Optional[str] = None,
    batch_size: int = 16,
    logger=None,
    device=None,
) -> List[Dict[str, np.ndarray]]:
    """Each structure of ``input_file`` predicted in chunks of
    ``batch_size``; logged, and pickled to ``output_file`` (a list of
    per-structure dicts) when given."""
    logger = logger or ZeroLogger()
    engine = InferenceEngine(ckpt_file, device=device)
    dps = read_structures(input_file, input_format)
    logger.info(f"read {len(dps)} structures from {input_file}")

    all_results: List[Dict[str, np.ndarray]] = []
    for i in range(0, len(dps), batch_size):
        chunk = dps[i : i + batch_size]
        results = engine.predict(chunk, compute_forces, compute_virial)
        if delta_method:
            results = [_delta_correction(dp, r, delta_method) for dp, r in zip(chunk, results)]
        all_results.extend(results)

    energy_unit = get_default_units().get(keys.TOTAL_ENERGY, "")
    lines = []
    for i, r in enumerate(all_results):
        parts = [f"structure {i}:"]
        if keys.TOTAL_ENERGY in r:
            parts.append(f"energy = {float(r[keys.TOTAL_ENERGY]):.8f} {energy_unit}")
        lines.append("  ".join(parts))
    logger.info("\n".join(lines))

    if output_file:
        with open(output_file, "wb") as f:
            pickle.dump(all_results, f)
        logger.info(f"full results written to {output_file}")
    return all_results


def run_infer_from_args(args) -> List[Dict[str, np.ndarray]]:
    return run_infer(
        args.ckpt,
        args.input,
        input_format=getattr(args, "format", None),
        output_file=getattr(args, "output", None),
        compute_forces=getattr(args, "forces", False),
        compute_virial=getattr(args, "stress", False),
        delta_method=getattr(args, "delta", None),
        batch_size=getattr(args, "batch_size", 16),
        device=getattr(args, "device", None),
    )
