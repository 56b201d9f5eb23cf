"""bf16 accuracy study: the same XPaiNN trained in f32 and in bf16.

Port of the JAX package's ``tools/bf16_accuracy_study.py``.  Trains one
XPaiNN configuration on the synthetic many-body PES dataset
(``xequinet_torch/tools/make_synthetic_dataset.py``) through ``run_train``
once per dtype mode, then evaluates energy and force MAE on the held-out
test split with ``run_test`` (EMA weights).  The modes:

- ``f32``: f32 message and update pipelines;
- ``bf16``: bf16 message pipeline and bf16 update blocks;
- ``bf16msg``: bf16 message pipeline, f32 update blocks;
- ``bf16_f32ft``: as ``bf16``, with the last fifth of the epochs in f32
  (``trainer.f32_finetune_epochs``).

The config sets no ``use_pallas_scatter``, as the JAX tool's does not:
the study runs on the plain route.

Usage (on the card; ``--device cpu`` for the CPU):
    python -m xequinet_torch.tools.make_synthetic_dataset synth3k --n 3000
    python -m xequinet_torch.tools.bf16_accuracy_study synth3k [--epochs 60] \\
        [--out DIR] [--tiny] [--modes f32,bf16,bf16msg,bf16_f32ft]

Writes <out>/results.json: per mode the test metrics under the JAX tool's
keys ({mode: {property: {mae, rmse, count}}}), and beside them ``card``
(the card's name and power limit as nvidia-smi prints them), ``device``,
``dataset`` (path, structures, sha256), ``epochs``, ``wall_s`` (training
and test per mode), ``step_ms_mean`` (the trainer's mean step time over
the epochs, host clock) and ``kernel_launches`` per mode.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from .. import keys
from ..utils.config import XequiConfig

MODES = ("f32", "bf16", "bf16msg", "bf16_f32ft")


def make_config(db_path: str, save_dir: str, dtype_mode: str, epochs: int,
                tiny: bool = False, device=None) -> XequiConfig:
    """The JAX tool's config on the port's schema for ``dtype_mode`` (one
    of ``MODES``); ``device`` is the port's ``trainer.device`` (None: the
    card)."""
    cfg = XequiConfig()
    cfg.model.model_name = "xpainn"
    cfg.model.model_kwargs = dict(
        node_dim=16 if tiny else 64,
        node_irreps="16x0e+8x1o" if tiny else "64x0e+32x1o+16x2e",
        embed_basis="one-hot",
        num_basis=8 if tiny else 16,
        action_blocks=1 if tiny else 3,
        output_modes=["energy"],
        remat=False,
    )
    if dtype_mode == "bf16msg":
        # the update blocks (the deep residual chain where rounding
        # accumulates) stay f32
        cfg.model.model_kwargs.update(compute_dtype="bfloat16")
    elif dtype_mode.startswith("bf16"):
        cfg.model.model_kwargs.update(
            compute_dtype="bfloat16", update_compute_dtype="bfloat16"
        )
    if dtype_mode == "bf16_f32ft":
        cfg.trainer.f32_finetune_epochs = max(1, epochs // 5)
    cfg.data.db_path = db_path
    cfg.data.cutoff = 5.0
    cfg.data.targets = [keys.TOTAL_ENERGY, keys.FORCES]
    cfg.data.batch_size = 64
    cfg.data.valid_batch_size = 128
    cfg.data.node_shift = True
    cfg.trainer.run_name = f"bf16study-{dtype_mode}"
    cfg.trainer.save_dir = save_dir
    cfg.trainer.max_epochs = epochs
    cfg.trainer.warmup_epochs = 3
    cfg.trainer.max_lr = 1e-3
    cfg.trainer.lossfn = "l2"
    cfg.trainer.losses_weight = {keys.TOTAL_ENERGY: 1.0, keys.FORCES: 25.0}
    cfg.trainer.ema_decay = 0.995
    cfg.trainer.seed = 42
    cfg.trainer.log_epochs = 5
    cfg.trainer.device = device
    return cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("db_path")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--out", default="bf16_study")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--modes", default="f32,bf16",
                    help="comma list of " + " / ".join(MODES))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        ap.error(f"unknown mode(s) {', '.join(unknown)}; each one of {', '.join(MODES)}")

    import torch

    from ..ops import cuda_build
    from ..run.inference import resolve_device
    from ..run.test import run_test
    from ..run.train import run_train
    from .convergence_study import card_line, dataset_checksum, parse_epochs

    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "CPU"
    info = json.loads((Path(args.db_path) / "info.json").read_text())
    results = {}
    extra = {"card": card, "device": str(dev), "epochs": args.epochs,
             "dataset": {"path": str(args.db_path), "n_structures": info.get("num_records"),
                         "sha256": dataset_checksum(args.db_path)},
             "wall_s": {}, "step_ms_mean": {}, "kernel_launches": {}}
    for mode in modes:
        save_dir = Path(args.out) / mode
        save_dir.mkdir(parents=True, exist_ok=True)
        cfg = make_config(args.db_path, str(save_dir), mode, args.epochs, tiny=args.tiny,
                          device=args.device)
        print(f"=== training {mode} on {dev} ({card}) ===", flush=True)
        cuda_build.reset_launch_counts()
        t0 = time.perf_counter()
        run_train(cfg)
        ckpt = str(save_dir / f"{cfg.trainer.run_name}_last.ckpt")
        metrics = run_test(cfg, ckpt_file=ckpt, use_ema=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        extra["wall_s"][mode] = time.perf_counter() - t0
        step_ms = [e["step_ms"] for e in parse_epochs(save_dir / cfg.trainer.log_file)
                   if e["step_ms"] is not None]
        extra["step_ms_mean"][mode] = float(np.mean(step_ms)) if step_ms else None
        extra["kernel_launches"][mode] = dict(cuda_build.LAUNCHES)
        results[mode] = metrics
        print(mode, json.dumps(metrics, default=float), flush=True)

    print("\n=== summary (test split) ===")
    for mode, m in results.items():
        print(mode, json.dumps(m, default=float))
    out = Path(args.out) / "results.json"
    results.update(extra)
    out.write_text(json.dumps(results, default=float, indent=1))
    print(f"wrote {out} ({card})")
    return results


if __name__ == "__main__":
    main()
