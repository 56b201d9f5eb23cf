"""Data-parallel training across processes.

Port of ``xequinet_tpu/parallel/data_parallel.py``.  The JAX package runs
one SPMD program over a device mesh, each device on its own micro-batch,
with the gradients ``pmean``-ed and the metric sums ``psum``-med over the
mesh axis.  The port runs one process per card (torchrun), each on its
own micro-batch from a disjoint shard of the dataset, and the step core
all-reduces the gradients and the loss to their mean before the clip, as
``pmean`` comes before the clip in the JAX step, and the metric sums to
their sum.  The step takes its gradients with ``torch.autograd.grad``
(the gradient of a force loss is a gradient of a gradient), so no
``DistributedDataParallel`` hook would fire: the gradient list goes
through one all-reduce as one flattened buffer.  Every rank then applies
the same update to the same parameters, which rank 0 broadcast at the
start (``replicate``), so the replicas stay bit-identical.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import keys
from .mesh import world_size

Tensor = torch.Tensor


def all_reduce_mean_(tensors: Sequence[Tensor]) -> None:
    """Each tensor becomes its mean over the ranks, in place: one
    all-reduce of the flattened tensors of each dtype, then a division by
    the world size."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_ts])
        dist.all_reduce(flat)
        flat.div_(dist.get_world_size())
        offset = 0
        for t in group_ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


Metrics = Dict[str, Tuple[Tensor, Tensor, Tensor]]


def all_reduce_metrics(metrics: Metrics) -> Metrics:
    """The (l1, l2, count) sums of ``training.loss.ErrorMetric`` summed over
    the ranks (``psum``), in one float64 all-reduce."""
    props = sorted(metrics)
    if not props:
        return metrics
    dev = metrics[props[0]][0].device
    flat = torch.tensor([float(v) for p in props for v in metrics[p]], dtype=torch.float64,
                        device=dev)
    dist.all_reduce(flat)
    out = {}
    for i, p in enumerate(props):
        l1, l2, n = flat[3 * i:3 * i + 3]
        out[p] = (l1, l2, n.round().to(torch.int64))
    return out


def stack_device_batches(batches: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """D padded batches of identical shapes stacked on a leading axis (the
    JAX ``stack_device_batches``)."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def device_put_sharded_batch(batch: Dict[str, np.ndarray], group=None, device=None
                             ) -> Dict[str, Tensor]:
    """This process's slice of a stacked batch's leading axis (its rank in
    ``group``), on ``device`` (None: the card; without one that raises
    unless the caller asks for the CPU): the port's counterpart of placing
    the leading axis over the mesh (JAX ``device_put_sharded_batch``)."""
    from ..ops.scatter import group_size_rank
    from ..run.inference import resolve_device

    dev = resolve_device(device)
    r = group_size_rank(group)[1]
    return {k: torch.as_tensor(np.asarray(v[r]), device=dev) for k, v in batch.items()}


def make_dp_train_step(*args, **kwargs):
    """``training.trainer.make_step_core`` with the gradients and the loss
    all-reduced to their mean before the clip, and the metric sums summed,
    over the process group (the JAX ``make_dp_train_step``'s pmean / psum)."""
    from ..training.trainer import make_step_core

    return make_step_core(*args, grad_reduce=all_reduce_mean_,
                          metric_reduce=all_reduce_metrics, **kwargs)


def make_dp_eval_step(forward: Callable, compute_forces: bool, compute_virial: bool, metric):
    """``training.trainer.make_eval_step`` with the metric sums summed over
    the process group."""
    from ..training.trainer import make_eval_step

    return make_eval_step(forward, compute_forces, compute_virial, metric,
                          metric_reduce=all_reduce_metrics)


def replicate(modules: Sequence[Optional[torch.nn.Module]]) -> None:
    """Every parameter and buffer of ``modules`` (None skipped) set to rank
    0's (the JAX ``replicate``)."""
    for module in modules:
        if module is None:
            continue
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0)


def empty_batch_like(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A fully masked batch of ``batch``'s shapes: every node, edge and
    graph mask False, counts and values zero, so its loss, metric sums
    and gradients are exactly zero.  The slot layout's metadata (``K_*``)
    is copied, not zeroed: every destination block of the kernels' plan
    covers at least one chunk, and the masks already null every
    contribution."""
    layout_keys = (keys.K_SRC2, keys.K_DST2, keys.K_CHUNK_BASE, keys.K_NCHUNKS, keys.K_WSTARTS)
    return {k: (v.copy() if k in layout_keys else np.zeros_like(v)) for k, v in batch.items()}


def _allgather_host(values: np.ndarray) -> np.ndarray:
    """[world, *values.shape]: ``values`` of every rank, in rank order (the
    local values alone without a process group).  NCCL takes CUDA tensors
    only."""
    if not dist.is_initialized():
        return values[None]
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.as_tensor(values, device=device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def agreed_signal(local: int) -> int:
    """The largest pending signal number (0: none) over the ranks, so that
    every rank acts on a preemption at the same point."""
    return int(_allgather_host(np.asarray([local], dtype=np.uint8)).max())


class ReplicaBatcher:
    """One padded micro-batch per rank and step, in lockstep across the
    processes.

    Greedy capacity packing makes the number of micro-batches of a shard
    depend on its content, so two ranks can disagree on the steps of an
    epoch: the one that runs out first would leave the epoch while the
    others wait in the step's all-reduce for ever.  With more than one
    process, every round all-gathers two bytes per rank: a flag (has data /
    exhausted / fatal) and a pending signal number (``stop_request()``, 0
    for none).  An exhausted rank steps on a fully masked batch
    (:func:`empty_batch_like`: zero loss, metric and gradient) until every
    rank is done; a rank with no batch at all this epoch sends the fatal
    flag, so every rank raises instead of one hanging; and once any rank
    has a signal pending, every rank ends the epoch at that same round with
    ``stop_signal`` set (the trainer then saves on rank 0 and exits)."""

    _EXHAUSTED, _HAS_DATA, _FATAL = 0, 1, 2

    def __init__(self, loader, sync_processes: Optional[bool] = None) -> None:
        self.loader = loader
        self.caps = loader.caps
        self.sync_processes = world_size() > 1 if sync_processes is None else sync_processes
        # [local values] -> every process's [world, ...], in rank order; a
        # test replaces it
        self._allgather = _allgather_host
        # this process's pending signal (the trainer's preemption flag), and
        # the one every rank stopped on
        self.stop_request: Callable[[], int] = lambda: 0
        self.stop_signal = 0
        # the steps of an epoch: the longest rank's estimate, exchanged once
        # here (not in __len__, which implicit protocol calls reach)
        self._synced_len: Optional[int] = None
        if self.sync_processes:
            counts = self._allgather(np.asarray([self._local_len()], dtype=np.int64))
            self._synced_len = int(np.max(counts))

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __iter__(self):
        if not self.sync_processes:
            yield from self.loader
            return
        inner = iter(self.loader)
        template: Optional[Dict[str, np.ndarray]] = None
        while True:
            b = next(inner, None)
            if b is not None:
                template = b
            flag = self._HAS_DATA if b is not None else self._EXHAUSTED
            if b is None and template is None:
                flag = self._FATAL
            gathered = self._allgather(np.asarray([flag, self.stop_request()], dtype=np.uint8))
            flags, signals = gathered[:, 0], gathered[:, 1]
            if np.any(flags == self._FATAL):
                raise RuntimeError(
                    "ReplicaBatcher: a process has no batch at all this epoch while others do; "
                    "shard the dataset so that every process gets at least one")
            if np.any(signals):
                self.stop_signal = int(signals.max())
                break
            if not np.any(flags == self._HAS_DATA):
                break
            yield b if b is not None else empty_batch_like(template)

    def _local_len(self) -> int:
        return max(1, len(self.loader))

    def __len__(self) -> int:
        """Steps per epoch: the longest rank's estimate in lockstep (so the
        learning-rate schedule paces the same on every rank)."""
        if self._synced_len is not None:
            return self._synced_len
        return self._local_len()

