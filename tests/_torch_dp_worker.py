"""Worker of tests/test_torch_parallel.py: one rank of a gloo process group
on the CPU, set up from torchrun's environment variables, as torchrun
would start it.

argv: <mode> <rank> <world> <port> <work dir>

* ``train``: ``run_train`` of the config pickled in ``<work dir>/config.pkl``
  with ``trainer.save_dir`` = ``<work dir>/run<rank>``; writes a digest of
  the final parameters and EMA, the world size, the steps run and the
  rank's own micro-batches per epoch to ``<work dir>/digest_<rank>.txt``.
* ``preempt_step`` / ``preempt_validation``: ``train`` with rank 1 sending
  itself SIGTERM after its first train step, or inside its first
  validation batch; the process exits with the trainer's 128 + 15.
* ``step``: one data-parallel step (``make_dp_train_step``) of the model in
  ``<work dir>/step.pkl`` on this rank's micro-batch; writes the loss, the
  clipped mean gradient (from Adam's first moment) and the parameters
  after the step to ``<work dir>/step_<rank>.pkl``.
"""

import hashlib
import os
import pickle
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().double().contiguous().numpy().tobytes())
    return h.hexdigest()


def train(rank: int, work: Path) -> None:
    from xequinet_torch.run.train import run_train

    with open(work / "config.pkl", "rb") as f:
        cfg = pickle.load(f)
    cfg.trainer.save_dir = str(work / f"run{rank}")
    trainer = run_train(cfg, device="cpu")
    ema = [] if trainer.ema_module is None else list(trainer.ema_module.parameters())
    # this rank's own micro-batches in an epoch (its shard's packing)
    n_local = sum(1 for _ in trainer.train_loader.loader)
    lines = [_digest(trainer.module.parameters()), _digest(ema),
             str(trainer.world_size), str(trainer.step), str(n_local)]
    (work / f"digest_{rank}.txt").write_text("\n".join(lines) + "\n")


def preempt(where: str):
    """``train`` with SIGTERM to rank 1 alone, after its first train step
    (``where`` = "step") or inside its first validation batch."""

    def run(rank: int, work: Path) -> None:
        import signal

        from xequinet_torch.training import trainer as trainer_mod

        build = trainer_mod.Trainer._build_steps

        def build_with_signal(self):
            build(self)
            name = "train_step" if where == "step" else "eval_step"
            inner = getattr(self, name)

            def hooked(*a, **k):
                out = inner(*a, **k)
                if rank == 1 and not sent:
                    sent.append(True)
                    os.kill(os.getpid(), signal.SIGTERM)
                return out

            setattr(self, name, hooked)

        sent = []
        trainer_mod.Trainer._build_steps = build_with_signal
        train(rank, work)

    return run


def step(rank: int, work: Path) -> None:
    from xequinet_torch import keys
    from xequinet_torch.data.batching import collate
    from xequinet_torch.models.model import resolve_model
    from xequinet_torch.models.properties import make_forward
    from xequinet_torch.parallel.data_parallel import make_dp_train_step
    from xequinet_torch.parallel.mesh import maybe_init_distributed
    from xequinet_torch.run.inference import batch_to_device
    from xequinet_torch.training import loss as tloss
    from xequinet_torch.training import lr_schedule as tls

    with open(work / "step.pkl", "rb") as f:
        job = pickle.load(f)
    assert maybe_init_distributed("cpu")
    module, extra, _ = resolve_model("xpainn", **job["kw"])
    module.load_state_dict(job["state"])
    named = list(module.named_parameters())
    params = [p for _, p in named]
    sched = tls.resolve_lr_schedule("cosine_annealing", 1e-3, 100, warmup_steps=2)
    opt = tls.resolve_optimizer("adamw", params)
    ema = [p.detach().clone() for p in params]
    core = make_dp_train_step(make_forward(module, extra, create_graph=True),
                              tloss.WeightedLoss("l2", **job["weights"]), params, opt, sched,
                              True, False, 5.0, 0.999,
                              tloss.ErrorMetric(keys.TOTAL_ENERGY, keys.FORCES))
    batch = batch_to_device(collate(job["micro_batches"][rank], *job["caps"]), "cpu")
    loss, metrics = core(batch, 0, 1.0, ema)
    b1 = opt.defaults["betas"][0]
    out = {"loss": float(loss),
           "clipped": {n: (opt.state[p]["exp_avg"] / (1 - b1)).numpy() for n, p in named},
           "params": {n: p.detach().numpy().copy() for n, p in named},
           "ema": [e.numpy().copy() for e in ema],
           "metric_count": int(metrics[keys.FORCES][2])}
    with open(work / f"step_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def main() -> int:
    mode, rank, world, port, work = sys.argv[1:6]
    os.environ.update(RANK=rank, WORLD_SIZE=world, MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch

    torch.set_num_threads(1)
    modes = {"train": train, "step": step, "preempt_step": preempt("step"),
             "preempt_validation": preempt("validation")}
    modes[mode](int(rank), Path(work))
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
