"""``xeq-torch``: the port's command line (``python -m xequinet_torch``).

The subcommands and flags of the JAX package's ``xeq``
(``xequinet_tpu/cli.py``), dispatched to the port's drivers, plus
``--device`` on ``infer``, ``test``, ``opt`` and ``export`` and
``--no-virial`` on ``export``.  Every subcommand runs on the card unless
the CPU is asked for (``--device cpu``; for ``train`` and ``md`` in the
config: ``trainer.device`` / ``device``); without a card it raises.
``train`` runs data-parallel across processes when launched by
``torchrun`` with ``trainer.dp_devices`` > 1 (``run/train.py``).
"""

from __future__ import annotations

import argparse
import sys


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="cuda (the default: the card) or cpu")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="xeq-torch", description="xequinet on PyTorch and CUDA")
    sub = parser.add_subparsers(dest="task", required=True)

    p_train = sub.add_parser("train", help="train a model")
    p_train.add_argument("--config", "-C", default="config.yaml")
    p_train.add_argument("--ckpt", "-c", default=None, help="warm-start checkpoint")
    p_train.add_argument("--resume", "-r", action="store_true")

    p_test = sub.add_parser("test", help="evaluate on the test split")
    p_test.add_argument("--config", "-C", default="config.yaml")
    p_test.add_argument("--ckpt", "-c", required=True)
    p_test.add_argument("--no-ema", action="store_true")
    p_test.add_argument("--verbose", "-v", action="store_true")
    p_test.add_argument("--results", default=None, help="per-structure dump file")
    _device_flag(p_test)

    p_infer = sub.add_parser("infer", help="predict properties for structures")
    p_infer.add_argument("--ckpt", "-c", required=True)
    p_infer.add_argument("--input", "-in", dest="input", required=True)
    p_infer.add_argument("--output", "-out", dest="output", default=None)
    p_infer.add_argument("--forces", action="store_true")
    p_infer.add_argument("--stress", action="store_true")
    p_infer.add_argument("--delta", "-d", default=None, help="xTB delta method")
    p_infer.add_argument("--batch-size", "-b", type=int, default=16)
    p_infer.add_argument("--format", default=None,
                         help="input format (built-in extxyz or any ASE format)")
    _device_flag(p_infer)

    p_opt = sub.add_parser("opt", help="geometry optimization")
    p_opt.add_argument("--ckpt", "-c", required=True)
    p_opt.add_argument("--input", "-in", dest="input", required=True)
    p_opt.add_argument("--output", "-out", dest="output", default=None)
    p_opt.add_argument("--max-steps", type=int, default=200)
    p_opt.add_argument("--fmax", type=float, default=0.05, help="eV/A convergence")
    p_opt.add_argument("--freq", action="store_true", help="frequencies/thermo")
    p_opt.add_argument("--temp", type=float, default=298.15)
    p_opt.add_argument("--delta", "-d", default=None)
    p_opt.add_argument("--constraints", "-con", default=None,
                       help="geomeTRIC-style constraints file ($freeze xyz natively; full "
                            "files via --engine geometric)")
    p_opt.add_argument("--engine", default="auto", choices=["auto", "native", "geometric"],
                       help="optimizer engine: built-in L-BFGS-B or geomeTRIC via PySCF "
                            "(auto-delegates when the constraint file needs it)")
    p_opt.add_argument("--shermo", action="store_true",
                       help="write a shermo input file alongside --freq")
    p_opt.add_argument("--save-hessian", action="store_true",
                       help="save the [3N,3N] Hessian (eV/A^2) to <input>_h.txt")
    p_opt.add_argument("--format", default=None,
                       help="input format (built-in extxyz or any ASE format)")
    p_opt.add_argument("--opt-params", dest="opt_params", default=None,
                       help="JSON file of extra L-BFGS-B options")
    p_opt.add_argument("--no-opt", action="store_true",
                       help="skip optimization (frequencies at the input geometry)")
    _device_flag(p_opt)

    p_md = sub.add_parser("md", help="molecular dynamics")
    p_md.add_argument("--config", "-C", default="md.yaml")

    p_export = sub.add_parser("export", help="export a model for deployment (torch.export)")
    p_export.add_argument("--ckpt", "-c", required=True)
    p_export.add_argument("--output", "-out", dest="output", required=True)
    p_export.add_argument("--max-atoms", type=int, default=256)
    p_export.add_argument("--max-edges", type=int, default=8192)
    p_export.add_argument("--unit-style", default="metal")
    p_export.add_argument("--mode", default="energy",
                          choices=["energy", "dipole", "gmx", "matrix"])
    p_export.add_argument("--periodic", action="store_true",
                          help="energy mode: add cell + cell_offsets inputs")
    p_export.add_argument("--net-charge", type=int, default=None,
                          help="bake a fixed total charge into the export")
    p_export.add_argument("--max-reps", type=int, default=1,
                          help="gmx mode: static cell-image replication bound")
    p_export.add_argument("--no-virial", action="store_true",
                          help="energy mode: energy and forces only")
    _device_flag(p_export)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.task == "train":
        from .run.train import run_train_from_args

        run_train_from_args(args)
    elif args.task == "test":
        from .run.test import run_test_from_args

        run_test_from_args(args)
    elif args.task == "infer":
        from .run.inference import run_infer_from_args

        run_infer_from_args(args)
    elif args.task == "opt":
        from .run.geometry import run_opt_from_args

        run_opt_from_args(args)
    elif args.task == "md":
        from .run.dynamics import run_md_from_args

        run_md_from_args(args)
    elif args.task == "export":
        from .interface.export import run_export_from_args

        run_export_from_args(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
