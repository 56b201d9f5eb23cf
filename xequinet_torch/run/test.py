"""``xeq test``: evaluate a checkpoint on the test split.

Port of ``xequinet_tpu/run/test.py:40-149``.  The test split is built as
training builds it (``run/train.build_datasets``), batched by the port's
``DataLoader`` with the checkpoint's slot layout, so that a checkpoint of
a kernel route is evaluated through its kernels, and scored by the
trainer's eval step and ``MetricAccumulator``.  It runs on the card unless
the caller (``device``) or the config (``trainer.device``) asks for the
CPU.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np

from .. import keys
from ..data.batching import kernel_layout_from_model_kwargs
from ..data.dataset import DataLoader
from ..models.properties import make_forward
from ..training.loss import ErrorMetric, MetricAccumulator
from ..training.trainer import _fmt_metrics, make_eval_step
from ..utils.config import XequiConfig, load_config
from ..utils.logger import ZeroLogger
from .inference import batch_to_device, load_model_from_checkpoint, resolve_device
from .train import build_datasets

__all__ = ["load_model_from_checkpoint", "run_test", "run_test_from_args"]


def run_test(
    config: XequiConfig,
    ckpt_file: str,
    use_ema: bool = True,
    verbose: bool = False,
    results_file: Optional[str] = None,
    logger=None,
    device=None,
) -> dict:
    """{property: {mae, rmse, count}} of the checkpoint on the test split.
    With ``verbose`` or ``results_file``, also each structure's energy,
    target energy and forces (logged, and pickled to ``results_file``)."""
    logger = logger or ZeroLogger()
    dev = resolve_device(device if device is not None else config.trainer.device)
    module, extra, _cutoff, _blob, mc = load_model_from_checkpoint(ckpt_file, use_ema)
    config.model.model_name = mc["model_name"]
    config.model.model_kwargs = mc["model_kwargs"]
    module = module.to(dev).eval().requires_grad_(False)

    _train, _valid, test_set = build_datasets(config)
    loader = DataLoader(test_set, config.data.valid_batch_size,
                        kernel_layout=kernel_layout_from_model_kwargs(mc["model_kwargs"]))

    targets = list(config.data.targets)
    compute_forces = keys.FORCES in targets
    compute_virial = keys.VIRIAL in targets or keys.STRESS in targets
    forward = make_forward(module, extra)
    kept = {}

    def forward_kept(batch, cf, cv):
        # one forward per batch serves the metric and the dump
        kept["out"] = forward(batch, cf, cv)
        return kept["out"]

    eval_step = make_eval_step(forward_kept, compute_forces, compute_virial,
                               ErrorMetric(*targets))
    acc = MetricAccumulator()
    dump = [] if (verbose or results_file) else None
    for raw in loader:
        acc.update(eval_step(batch_to_device(raw, dev)))
        if dump is None:
            continue
        out = {k: v.cpu().numpy() for k, v in kept["out"].items()
               if k in keys.OUTPUT_PROPERTIES}
        ptr = np.asarray(raw[keys.BATCH_PTR])
        for g in range(int(np.asarray(raw[keys.GRAPH_MASK]).sum())):
            entry = {}
            if keys.TOTAL_ENERGY in out:
                entry[keys.TOTAL_ENERGY] = float(out[keys.TOTAL_ENERGY][g])
                entry["target_" + keys.TOTAL_ENERGY] = float(raw[keys.TOTAL_ENERGY][g])
            if keys.FORCES in out:
                entry[keys.FORCES] = out[keys.FORCES][ptr[g] : ptr[g + 1]]
            dump.append(entry)
            if verbose:
                logger.info(f"structure {len(dump) - 1}: " + " ".join(
                    f"{k}={v}" for k, v in entry.items() if np.isscalar(v)))
    results = acc.compute()
    if results_file and dump is not None:
        with open(results_file, "wb") as f:
            pickle.dump(dump, f)
        logger.info(f"per-structure results written to {results_file}")
    logger.info("test results\n" + _fmt_metrics(results))
    return results


def run_test_from_args(args) -> dict:
    """``args.config``, ``args.ckpt`` and the optional ``no_ema``,
    ``verbose``, ``results`` and ``device``."""
    return run_test(
        load_config(args.config),
        args.ckpt,
        use_ema=not getattr(args, "no_ema", False),
        verbose=getattr(args, "verbose", False),
        results_file=getattr(args, "results", None),
        device=getattr(args, "device", None),
    )
