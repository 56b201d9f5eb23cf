"""Batch property prediction: energies and forces (and virial).

Port of ``xequinet_tpu/run/inference.py:30-138`` (``InferenceEngine``) and
``xequinet_tpu/run/test.py:27-37`` (``load_model_from_checkpoint``).  The
engine runs on the card unless the caller passes ``device="cpu"``.  The
xTB delta correction, unit handling and the CLI come with a later slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .. import keys
from ..convert import load_checkpoint, load_params
from ..data.batching import (
    bucket_capacity,
    collate,
    kernel_layout_from_model_kwargs,
    kernel_slot_cap,
)
from ..data.datapoint import Datapoint
from ..data.transforms import NeighborTransform
from ..models.model import resolve_model
from ..models.properties import make_forward


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
    """Rebuild the model from the checkpoint's embedded config and load
    its (EMA) weights, from either package's trainer.  Returns (module,
    extra, cutoff, blob, config)."""
    blob = load_checkpoint(ckpt_file)
    model_config = blob["config"]
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
        # models using the mega kernels keep them at inference: batches
        # carry the slot layout
        self._kernel_layout = kernel_layout_from_model_kwargs(model_kwargs or {})

    def collate(self, dps: List[Datapoint]) -> Dict[str, np.ndarray]:
        """Host-side batch of already-transformed datapoints.

        A structure that exceeds the kernel window cannot take the slot
        layout.  On the CPU the batch then goes without it, as in the JAX
        engine (the message op is the plain version there anyway); on the
        card that would run the plain message route, so it raises."""
        if self._kernel_layout is not None:
            n_cap = bucket_capacity(sum(d.num_atoms for d in dps))
            e_cap = bucket_capacity(max(sum(d.num_edges for d in dps), 1))
            layout = dict(self._kernel_layout)
            layout["slot_cap"] = kernel_slot_cap(n_cap, e_cap, layout)
            try:
                return collate(dps, n_cap, e_cap, len(dps) + 1, kernel_layout=layout)
            except ValueError as e:
                if self.device.type != "cpu":
                    raise ValueError(
                        f"batch does not fit the message kernels' slot layout "
                        f"{self._kernel_layout} ({e}); serve it with a model built "
                        f"with a larger pallas_layout pad_nodes, or with "
                        f"use_pallas_scatter=False"
                    ) from e
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
            for prop in (keys.TOTAL_ENERGY, keys.VIRIAL):
                if prop in out:
                    r[prop] = out[prop][g]
            for prop in (keys.FORCES, keys.ATOMIC_ENERGIES):
                if prop in out:
                    r[prop] = out[prop][node_off : node_off + n]
            node_off += n
            results.append(r)
        return results
