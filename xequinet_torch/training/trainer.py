"""The Trainer: train / validation steps, EMA, best-k checkpoints, early
stopping, plateau scheduling, resume.

Port of ``xequinet_tpu/training/trainer.py:42-154, 163-214, 220-651`` on
one device.  A train step (forward with forces by autodiff, the weighted
loss, the parameter gradient through the force loss, the clip, the
optimizer update, the EMA) is :func:`make_step_core`; on the card a
force loss runs the message blocks' forward, backward and second-order
kernels.  Host code orchestrates epochs, logging and checkpoints.

Checkpoints are pickles with the JAX trainer's keys (``model``,
``ema_model``, ``opt_state``, ``config``, ``epoch``, ``loss``,
``loss2file``, ``plateau``, ``stoppings``), torch state_dicts in place of
its flax msgpack blobs; the JAX trainer's checkpoints load here too
(``convert.load_params``).  The preemption handler of the JAX trainer is
not ported yet (ROADMAP item 6).
"""

from __future__ import annotations

import copy
import heapq
import math
import os
import pickle
import re
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import keys
from ..convert import load_checkpoint, load_params
from ..models.model import resolve_model
from ..models.properties import make_forward
from ..run.inference import batch_to_device
from ..utils.config import XequiConfig, config_to_dict
from ..utils.logger import StepTimer
from .loss import ErrorMetric, MetricAccumulator, WeightedLoss
from .lr_schedule import PlateauScheduler, resolve_lr_schedule, resolve_optimizer, set_lr

DataDict = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Early stopping
# ---------------------------------------------------------------------------
@dataclass
class EarlyStopping:
    patience: int = 50
    threshold: float = 1e-4
    lower_bound: Optional[float] = None
    best: float = math.inf
    num_bad: int = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if self.lower_bound is not None and metric < self.lower_bound:
            return True
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        return self.num_bad > self.patience


class MultiEarlyStopping:
    """Per-metric criteria combined with 'and' / 'or'."""

    def __init__(self, stoppings: Dict[str, Dict], mode: str = "and") -> None:
        self.stoppings = {prop: EarlyStopping(**cfg) for prop, cfg in (stoppings or {}).items()}
        if mode not in ("and", "or"):
            raise ValueError(f"early_stopping_mode must be 'and' or 'or', got {mode!r}")
        self.mode = mode

    def step(self, metrics: Dict[str, float]) -> bool:
        votes = [es.step(metrics[p]) for p, es in self.stoppings.items() if p in metrics]
        if not votes:
            return False
        return all(votes) if self.mode == "and" else any(votes)


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------
def loss_and_grads(forward: Callable, lossfn: WeightedLoss, params: Sequence[torch.Tensor],
                   batch: DataDict, compute_forces: bool, compute_virial: bool):
    """(loss, losses, out, grads): the training forward (forces with
    ``create_graph=True``), the weighted loss and its gradient w.r.t.
    every parameter (zeros for a parameter the loss does not reach)."""
    out = forward(batch, compute_forces, compute_virial)
    loss, losses = lossfn(out, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return loss, losses, out, grads


def clip_by_global_norm(grads: Sequence[torch.Tensor], clip: float) -> None:
    """Scale the gradients in place by JAX's min(1, clip / max(|g|, 1e-12))
    (trainer.py:134-136; not ``clip_grad_norm_``'s clip / (|g| + 1e-6))."""
    gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    for g in grads:
        g.mul_(scale)


def make_step_core(forward: Callable, lossfn: WeightedLoss, params: Sequence[nn.Parameter],
                   optimizer: torch.optim.Optimizer, schedule: Callable[[int], float],
                   compute_forces: bool, compute_virial: bool, grad_clip: Optional[float],
                   ema_decay: Optional[float], metric: ErrorMetric):
    """``step_core(batch, step, lr_scale, ema_params) -> (loss, metrics)``
    (trainer.py:98-154): the gradient over every parameter (the clip's
    global norm includes frozen ones, as in the JAX package), the
    optimizer (holding only the trainable ones) at the learning rate
    ``schedule(step) * lr_scale``, then ``e = d e + (1 - d) p`` on the
    separate EMA copy."""
    params = list(params)

    def step_core(batch: DataDict, step: int, lr_scale: float = 1.0,
                  ema_params: Optional[List[torch.Tensor]] = None):
        loss, _, out, grads = loss_and_grads(forward, lossfn, params, batch,
                                             compute_forces, compute_virial)
        if grad_clip is not None:
            clip_by_global_norm(grads, grad_clip)
        for p, g in zip(params, grads):
            p.grad = g
        # lr_scale multiplies the optimizer's updates in the JAX package
        # (trainer.py:141); every update here is proportional to the lr,
        # weight decay included, so scaling the lr is the same
        set_lr(optimizer, schedule(step) * lr_scale)
        optimizer.step()
        for p in params:
            p.grad = None
        if ema_params is not None and ema_decay is not None:
            with torch.no_grad():
                torch._foreach_mul_(ema_params, ema_decay)
                torch._foreach_add_(ema_params, [p.detach() for p in params],
                                    alpha=1.0 - ema_decay)
        with torch.no_grad():
            metrics = metric({k: v.detach() for k, v in out.items() if torch.is_tensor(v)},
                             batch)
        return loss.detach(), metrics

    return step_core


def make_eval_step(forward: Callable, compute_forces: bool, compute_virial: bool,
                   metric: ErrorMetric):
    def eval_fn(batch: DataDict):
        return metric(forward(batch, compute_forces, compute_virial), batch)

    return eval_fn


# ---------------------------------------------------------------------------
# Checkpoint I/O
# ---------------------------------------------------------------------------
def _to_cpu(obj: Any) -> Any:
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, module: nn.Module, config: Dict[str, Any], *,
                    ema_module: Optional[nn.Module] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None, epoch: int = 0,
                    loss: float = math.inf, extra: Optional[Dict[str, Any]] = None) -> None:
    blob = {"model": _to_cpu(module.state_dict()), "config": config, "epoch": epoch,
            "loss": loss}
    if ema_module is not None:
        blob["ema_model"] = _to_cpu(ema_module.state_dict())
    if optimizer is not None:
        blob["opt_state"] = _to_cpu(optimizer.state_dict())
    if extra:
        blob.update(extra)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(blob, f)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------
def _flax_path(name: str) -> str:
    """A torch parameter name as the JAX package's parameter path
    (``blocks.3.Dense_0.weight`` -> ``blocks_3/Dense_0/weight``), so
    ``finetune_modules`` substrings written for either package match."""
    return re.sub(r"^blocks\.(\d+)", r"blocks_\1", name).replace(".", "/")


def _adopt_parameters(new: nn.Module, old: nn.Module) -> nn.Module:
    """Make ``new`` (same structure) use ``old``'s parameter and buffer
    objects, so the optimizer and the EMA keep theirs."""
    for name, t in list(old.named_parameters()) + list(old.named_buffers()):
        mod, _, leaf = name.rpartition(".")
        target = new.get_submodule(mod)
        if leaf in target._parameters:
            target._parameters[leaf] = t
        else:
            target._buffers[leaf] = t
    return new


class Trainer:
    """Epochs of :func:`make_step_core` over ``train_loader``, validation
    on the EMA weights (or the weights without EMA), best-k and last
    checkpoints, resume, early stopping, plateau scaling, finetune
    freezing and the late f32 switch (``f32_finetune_epochs``)."""

    def __init__(self, *, config: XequiConfig, module: nn.Module, extra: List[str],
                 train_loader, valid_loader, steps_per_epoch: int, device,
                 logger=None) -> None:
        tc = config.trainer
        self.config = config
        self.tc = tc
        self.logger = logger
        self.device = torch.device(device)
        self.train_loader = train_loader
        self.valid_loader = valid_loader
        self.extra = extra
        self.module = module.to(self.device).train().requires_grad_(True)

        targets = list(config.data.targets)
        self.compute_forces = keys.FORCES in targets
        self.compute_virial = keys.VIRIAL in targets or keys.STRESS in targets
        self.lossfn = WeightedLoss(tc.lossfn, **self._loss_weights(targets))
        self.metric = ErrorMetric(*targets)

        self.schedule = resolve_lr_schedule(
            tc.lr_scheduler, tc.max_lr, tc.max_epochs * steps_per_epoch,
            warmup_scheduler=tc.warmup_scheduler,
            warmup_steps=tc.warmup_epochs * steps_per_epoch,
            **(tc.lr_scheduler_kwargs or {}),
        )
        named = list(self.module.named_parameters())
        self.params = [p for _, p in named]
        trainable = [p for n, p in named if not tc.finetune_modules
                     or any(m in n or m in _flax_path(n) for m in tc.finetune_modules)]
        self.optimizer = resolve_optimizer(tc.optimizer, trainable,
                                           **(tc.optimizer_kwargs or {}))
        self.plateau = (PlateauScheduler(**(tc.lr_scheduler_kwargs or {}))
                        if tc.lr_scheduler.lower() == "plateau" else None)
        self.stopper = MultiEarlyStopping(tc.early_stoppings or {}, tc.early_stopping_mode)

        # a separate copy, never aliasing the parameters; None when off
        self.ema_module = None
        if tc.ema_decay is not None:
            self.ema_module = copy.deepcopy(self.module).eval().requires_grad_(False)
        self.epoch = 0
        self.step = 0
        self.lr_scale = 1.0
        self.step_timer = StepTimer()
        # best-k heap of (-loss, file)
        self.best_heap: List[Tuple[float, str]] = []
        self._f32_switched = False
        self._build_steps()

        os.makedirs(tc.save_dir, exist_ok=True)
        if tc.ckpt_file and os.path.exists(tc.ckpt_file):
            if tc.resume:
                self._resume(tc.ckpt_file)
            else:
                load_params(self.module, load_checkpoint(tc.ckpt_file)["model"])
                if self.ema_module is not None:
                    self.ema_module.load_state_dict(self.module.state_dict())

    # ------------------------------------------------------------------
    def _ema_params(self) -> Optional[List[torch.Tensor]]:
        if self.ema_module is None:
            return None
        return list(self.ema_module.parameters())

    def _build_steps(self) -> None:
        """(Re)build the train / eval steps around the current modules:
        at init and after the late f32 switch."""
        tc = self.tc
        self.forward = make_forward(self.module, self.extra, create_graph=True)
        self.train_step = make_step_core(
            self.forward, self.lossfn, self.params, self.optimizer, self.schedule,
            self.compute_forces, self.compute_virial, tc.grad_clip, tc.ema_decay,
            self.metric,
        )
        eval_module = self.ema_module if self.ema_module is not None else self.module
        self.eval_step = make_eval_step(make_forward(eval_module, self.extra),
                                        self.compute_forces, self.compute_virial, self.metric)

    def _maybe_switch_to_f32(self, epoch: int) -> None:
        """The last ``f32_finetune_epochs`` epochs run with float32 compute
        dtypes: the modules are rebuilt with f32 kwargs around the same
        parameter objects, and the model config is updated in place, so
        checkpoints saved from here embed f32."""
        k = self.tc.f32_finetune_epochs or 0
        if not k or self._f32_switched or epoch < self.tc.max_epochs - k:
            return
        self._f32_switched = True
        mc = self.config.model
        mk = dict(mc.model_kwargs)
        if str(mk.get("compute_dtype", "float32")) == "float32" and \
                str(mk.get("update_compute_dtype", "float32")) == "float32":
            return
        mk["compute_dtype"] = mk["update_compute_dtype"] = "float32"
        mc.model_kwargs = mk
        rebuild = lambda old: _adopt_parameters(
            resolve_model(mc.model_name, **mk)[0].to(self.device), old)
        self.module = rebuild(self.module).train()
        if self.ema_module is not None:
            self.ema_module = rebuild(self.ema_module).eval()
        self._build_steps()
        self._log(f"f32 fine-tune: compute dtypes switched to float32 for the final {k} "
                  "epoch(s); checkpoints from here embed f32")

    def _loss_weights(self, targets: List[str]) -> Dict[str, float]:
        return dict(self.tc.losses_weight or {}) or {t: 1.0 for t in targets}

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.info(msg)

    # ------------------------------------------------------------------
    def train1epoch(self) -> float:
        self.train_loader.set_epoch(self.epoch)
        acc = MetricAccumulator()
        loss = None
        for step, raw in enumerate(self.train_loader):
            batch = batch_to_device(raw, self.device)
            self.step_timer.start()
            loss, metrics = self.train_step(batch, self.step, self.lr_scale, self._ema_params())
            self.step_timer.stop()
            self.step += 1
            if (step + 1) % self.tc.log_steps == 0:
                acc.update(metrics)
                self._log(f"epoch {self.epoch} step {step + 1} loss {float(loss):.6f}\n"
                          f"{_fmt_metrics(acc.compute())}")
                acc.reset()
        return float("nan") if loss is None else float(loss)

    def validate(self) -> Dict[str, Dict[str, float]]:
        acc = MetricAccumulator()
        for raw in self.valid_loader:
            acc.update(self.eval_step(batch_to_device(raw, self.device)))
        return acc.compute()

    def weighted_mae(self, results: Dict[str, Dict[str, float]]) -> float:
        weights = self._loss_weights(list(self.config.data.targets))
        return sum(w * results[p]["mae"] for p, w in weights.items() if p in results)

    # ------------------------------------------------------------------
    def _ckpt_blob_extra(self) -> Dict[str, Any]:
        return {
            "epoch": self.epoch,
            "step": self.step,
            "loss2file": list(self.best_heap),
            "plateau": self.plateau.state_dict() if self.plateau else None,
            "stoppings": {k: vars(v) for k, v in self.stopper.stoppings.items()},
        }

    def save_best_k(self, val_mae: float) -> None:
        tc = self.tc
        fname = os.path.join(tc.save_dir, f"{tc.run_name}_ep{self.epoch}_{val_mae:.6f}.ckpt")
        entry = (-val_mae, fname)
        if len(self.best_heap) < tc.best_k:
            heapq.heappush(self.best_heap, entry)
        elif entry > self.best_heap[0]:
            _, old = heapq.heappushpop(self.best_heap, entry)
            if os.path.exists(old):
                os.remove(old)
        else:
            return
        save_checkpoint(fname, self.module, config_to_dict(self.config.model),
                        ema_module=self.ema_module, epoch=self.epoch, loss=val_mae)

    def save_last(self, val_mae: float) -> None:
        save_checkpoint(os.path.join(self.tc.save_dir, f"{self.tc.run_name}_last.ckpt"),
                        self.module, config_to_dict(self.config.model),
                        ema_module=self.ema_module, optimizer=self.optimizer,
                        epoch=self.epoch, loss=val_mae, extra=self._ckpt_blob_extra())

    def _resume(self, path: str) -> None:
        blob = load_checkpoint(path)
        load_params(self.module, blob["model"])
        if self.ema_module is not None:
            load_params(self.ema_module, blob.get("ema_model", blob["model"]))
        opt = blob.get("opt_state")
        if isinstance(opt, dict) and "param_groups" in opt:
            self.optimizer.load_state_dict(opt)
        elif opt is not None:
            self._log("the checkpoint's optimizer state is the JAX trainer's; "
                      "the optimizer starts afresh")
        self.epoch = blob.get("epoch", 0) + 1
        self.step = blob.get("step", 0)
        self.best_heap = [tuple(x) for x in blob.get("loss2file", [])]
        if self.plateau and blob.get("plateau"):
            self.plateau.load_state_dict(blob["plateau"])
            self.lr_scale = self.plateau.scale
        for prop, st in (blob.get("stoppings") or {}).items():
            es = self.stopper.stoppings.get(prop)
            if es is not None:
                es.best = st.get("best", es.best)
                es.num_bad = st.get("num_bad", es.num_bad)
        self._log(f"resumed from {path} at epoch {self.epoch}")

    # ------------------------------------------------------------------
    def start(self) -> None:
        tc = self.tc
        for epoch in range(self.epoch, tc.max_epochs):
            self.epoch = epoch
            self._maybe_switch_to_f32(epoch)
            t0 = time.time()
            loss = self.train1epoch()
            results = self.validate()
            val_mae = self.weighted_mae(results)
            if epoch % tc.log_epochs == 0:
                timing = self.step_timer.stats()
                timing_str = (f" step {timing['mean_ms']:.1f}ms (p95 {timing['p95_ms']:.1f})"
                              if timing else "")
                self._log(f"== epoch {epoch} done in {time.time() - t0:.1f}s{timing_str} "
                          f"train-loss {loss:.6f} valid weighted-MAE {val_mae:.6f}\n"
                          + _fmt_metrics(results))
                self.step_timer.reset()
            self.save_best_k(val_mae)
            self.save_last(val_mae)
            if self.plateau is not None:
                self.lr_scale = self.plateau.step(val_mae)
            if self.stopper.step({p: r["mae"] for p, r in results.items()}):
                self._log(f"early stopping at epoch {epoch}")
                break


def _fmt_metrics(results: Dict[str, Dict[str, float]]) -> str:
    rows = [("property", "MAE", "RMSE", "count")] + [
        (prop, f"{r['mae']:.6f}", f"{r['rmse']:.6f}", str(r["count"]))
        for prop, r in sorted(results.items())
    ]
    widths = [max(len(row[i]) for row in rows) for i in range(4)]
    return "\n".join("  ".join(c.ljust(w) for c, w in zip(row, widths)) for row in rows)
