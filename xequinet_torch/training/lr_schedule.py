"""Optimizers, LR schedules, warmups and plateau scheduling.

Port of ``xequinet_tpu/training/lr_schedule.py:19-193``.  A schedule is a
plain Python function of the step count that gives optax's value
(``optax.linear_schedule``, ``cosine_decay_schedule``, ``exponential_decay``,
``polynomial_schedule`` and ``join_schedules``, which hands each later
schedule the steps since its boundary).  The optimizer is ``torch.optim``;
the trainer sets its learning rate before each update from the schedule
at the number of updates done so far, as ``optax.inject_hyperparams``
does.  ``PlateauScheduler`` is the host-side EMA-smoothed reduce-on-plateau
that scales the updates.

Where torch's optimizers differ from optax's, the port follows optax:

* ``adamw``: optax's default weight decay is 1e-4 (torch's 1e-2).
* ``nadam``: optax's Nesterov Adam has a constant momentum b1; torch's
  ``NAdam`` multiplies it by ``1 - 0.5 * 0.96 ** (step * momentum_decay)``,
  which is exactly b1 with ``momentum_decay=inf``.
* ``radam``: torch's ``RAdam`` rectifies above rho > 5 (optax: >= 5) and
  adds eps to sqrt(v) before the bias correction; :class:`OptaxRAdam`
  implements optax's update instead.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Optional

import torch

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# optax's schedules as functions of the step count
# ---------------------------------------------------------------------------
def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps)


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if decay_steps <= 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float,
                      staircase: bool = False) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        p = count / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value if count <= 0 else init_value * decay_rate ** p

    return schedule


def join_schedules(schedules, boundaries) -> Schedule:
    """Each later schedule gets the steps since its boundary."""

    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def resolve_warmup(warmup_scheduler: Optional[str], warmup_steps: int,
                   base_lr: float) -> Optional[Schedule]:
    """Warmup schedule on [0, warmup_steps) (pytorch-warmup semantics)."""
    name = (warmup_scheduler or "none").lower()
    if name in ("none", ""):
        return None
    n = max(warmup_steps, 1)
    if name in ("linear", "untuned_linear"):
        return linear_schedule(base_lr / n if name == "linear" else 0.0, base_lr, n)
    if name in ("exponential", "untuned_exponential"):
        return lambda step: base_lr * (1.0 - math.exp(-(step + 1) / n))
    if name == "radam":
        return None  # RAdam has its own variance rectification
    raise NotImplementedError(f"Unsupported warmup scheduler {warmup_scheduler}")


def resolve_lr_schedule(lr_scheduler: str, base_lr: float, max_steps: int,
                        warmup_scheduler: Optional[str] = "linear",
                        warmup_steps: int = 0, **kwargs: Any) -> Schedule:
    """Warmup then the main schedule, as one function of the step.  For
    "plateau" the main part is a constant that :class:`PlateauScheduler`
    scales from the host."""
    name = lr_scheduler.lower()
    if name == "cosine_annealing":
        t_max = kwargs.get("T_max", max_steps)
        eta_min = kwargs.get("eta_min", 0.0)
        main = cosine_decay_schedule(base_lr, max(t_max, 1),
                                     eta_min / base_lr if base_lr > 0 else 0.0)
    elif name == "cosine_restarts":
        t, mult = kwargs.get("T_0", max(max_steps // 4, 1)), kwargs.get("T_mult", 1)
        schedules, boundaries, start = [], [], 0
        while start < max_steps:
            schedules.append(cosine_decay_schedule(base_lr, t))
            start += t
            boundaries.append(start)
            t *= mult if mult > 1 else 1
        main = join_schedules(schedules, boundaries[:-1]) if schedules else (
            lambda step: base_lr)
    elif name == "exponential":
        main = exponential_decay(base_lr, 1, kwargs.get("gamma", 0.999))
    elif name == "step":
        main = exponential_decay(base_lr, kwargs.get("step_size", max(max_steps // 3, 1)),
                                 kwargs.get("gamma", 0.1), staircase=True)
    elif name == "linear_decay":
        main = polynomial_schedule(base_lr, kwargs.get("end_lr", 0.0),
                                   kwargs.get("power", 1.0), max(max_steps, 1))
    elif name == "plateau":
        main = lambda step: base_lr
    else:
        raise NotImplementedError(f"Unsupported lr scheduler {lr_scheduler}")
    warm = resolve_warmup(warmup_scheduler, warmup_steps, base_lr)
    if warm is None or warmup_steps <= 0:
        return main
    return join_schedules([warm, main], [warmup_steps])


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------
class OptaxRAdam(torch.optim.Optimizer):
    """``optax.radam``: with count t, rho = rho_inf - 2 t b2^t / (1 - b2^t)
    and rho_inf = 2 / (1 - b2) - 1, the update is
    r * m_hat / (sqrt(v_hat) + eps) when rho >= threshold and m_hat
    otherwise, r the variance rectification."""

    def __init__(self, params: Iterable, lr: float = 0.0, betas=(0.9, 0.999),
                 eps: float = 1e-8, threshold: float = 5.0) -> None:
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, threshold=threshold))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = st["step"]
                m, v = st["exp_avg"], st["exp_avg_sq"]
                m.lerp_(p.grad, 1.0 - b1)
                v.mul_(b2).addcmul_(p.grad, p.grad, value=1.0 - b2)
                m_hat = m / (1.0 - b1 ** t)
                b2t = b2 ** t
                ro = ro_inf - 2.0 * t * b2t / (1.0 - b2t)
                if ro >= group["threshold"]:
                    r = math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                                  / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))
                    upd = r * m_hat / ((v / (1.0 - b2t)).sqrt() + group["eps"])
                else:
                    upd = m_hat
                p.add_(upd, alpha=-group["lr"])
        return None


def resolve_optimizer(optimizer: str, params: Iterable, **kwargs) -> torch.optim.Optimizer:
    """The optimizer, learning rate 0 until the trainer sets it.  As in the
    JAX package only ``weight_decay`` (for adamw) is read from ``kwargs``."""
    name = optimizer.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=kwargs.get("weight_decay", 1e-4))
    if name == "nadam":
        return torch.optim.NAdam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 momentum_decay=math.inf)
    if name == "radam":
        return OptaxRAdam(params)
    raise NotImplementedError(f"Unsupported optimizer {optimizer}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class PlateauScheduler:
    """EMA-smoothed reduce-on-plateau, host side: ``step(metric)`` each
    validation returns the factor the updates are scaled by."""

    def __init__(self, factor: float = 0.5, patience: int = 10, threshold: float = 1e-4,
                 smoothing_factor: float = 0.0, min_lr: float = 0.0,
                 max_reductions: int = 10) -> None:
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.smoothing = smoothing_factor
        self.min_lr = min_lr
        self.max_reductions = max_reductions
        self.best = math.inf
        self.ema_metric: Optional[float] = None
        self.num_bad_epochs = 0
        self.num_reductions = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if self.ema_metric is None:
            self.ema_metric = metric
        else:
            self.ema_metric = self.smoothing * self.ema_metric + (1.0 - self.smoothing) * metric
        if self.ema_metric < self.best * (1.0 - self.threshold):
            self.best = self.ema_metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience and self.num_reductions < self.max_reductions:
            self.scale *= self.factor
            self.num_bad_epochs = 0
            self.num_reductions += 1
        return self.scale

    def state_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
