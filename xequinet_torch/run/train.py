"""Training entry point: config -> units -> datasets + transforms -> loaders ->
energy statistics -> model -> Trainer.

Port of ``xequinet_tpu/run/train.py:38-85, 439-556``.  It runs on the
card unless the config (``trainer.device``) or the caller asks for the
CPU; without a card it raises.

Data parallelism: launched as several processes by torchrun (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; NCCL with one card per
process, gloo on the CPU) or inside a process group the caller made,
with ``trainer.dp_devices`` 0 (the whole group) or the group's size,
every process trains on its own shard of the dataset with the global
batch divided over the processes, the gradients all-reduced and rank 0
writing the checkpoints (``parallel/``).  Halo training (``gp_devices >
1``) is the next slice of the port and raises.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .. import keys
from ..data.batching import kernel_layout_from_model_kwargs
from ..data.dataset import DataLoader, calculate_stats
from ..data.store import XDBDataset
from ..data.transforms import build_transform_pipeline
from ..models.model import init_params, resolve_model
from ..training.trainer import Trainer
from ..utils.config import XequiConfig, load_config
from ..utils.logger import ZeroLogger
from ..utils.qc import set_default_units
from .inference import resolve_device


def build_datasets(config: XequiConfig):
    """(train, valid, test) XDB datasets with the transform pipeline; the
    dataset's units (info.json) are converted to the model's."""
    dc = config.data
    probe = XDBDataset(dc.db_path, split="train", split_name=dc.split)
    units = probe.units
    probe.reader.close()
    transform = build_transform_pipeline(
        data_units=units,
        base_targets=dc.base_targets,
        svd_frame=bool(config.model.model_kwargs.get("use_pbc") is False
                       and config.model.model_name.endswith("ewald")),
        vector_targets=[keys.DIPOLE] if keys.DIPOLE in dc.targets else [],
        atomic_vector_targets=[keys.FORCES] if keys.FORCES in dc.targets else [],
        cutoff=dc.cutoff,
    )
    mk = lambda split: XDBDataset(dc.db_path, split=split, split_name=dc.split,
                                  transform=transform, max_num_samples=dc.max_num_samples)
    return mk("train"), mk("valid"), mk("test")


def _resolve_replicas(tc, dev) -> int:
    """The number of data-parallel processes: the process group's size (1
    without one).  ``dp_devices`` is 0 or that size; above it the driver
    warns and trains on the group (the JAX driver's clamp), below it (a
    part of the group) it refuses."""
    from ..parallel.mesh import maybe_init_distributed, world_size

    maybe_init_distributed(dev)
    avail = world_size()
    n = tc.dp_devices if tc.dp_devices > 0 else avail
    if n > avail:
        warnings.warn(f"dp_devices={n} requested but the process group has {avail} "
                      f"process(es); training on {avail}.")
        n = avail
    if n != avail:
        raise ValueError(f"dp_devices={n} inside a process group of {avail}: launch "
                         f"{n} processes (or set dp_devices 0)")
    return n


def run_train(config: XequiConfig, logger=None, device=None) -> Trainer:
    """Train as the config says; returns the Trainer after its last epoch.
    ``device`` (or ``trainer.device``): None = the card."""
    tc, dc, mc = config.trainer, config.data, config.model
    if tc.gp_devices and tc.gp_devices > 1:
        raise NotImplementedError(
            f"gp_devices={tc.gp_devices}: halo training (spatial decomposition) is not "
            "ported yet; it is the next slice of the port (parallel/halo.py)")
    dev = resolve_device(device if device is not None else tc.device)
    n_replicas = _resolve_replicas(tc, dev)
    logger = logger or ZeroLogger(os.path.join(tc.save_dir, tc.log_file))
    if tc.seed is not None:
        np.random.seed(tc.seed)
    if mc.default_units:
        set_default_units(mc.default_units)

    train_set, valid_set, _ = build_datasets(config)
    logger.info(f"datasets: train={len(train_set)} valid={len(valid_set)} on {dev}")

    # the global batch divided over the processes, each on its own shard
    local_bs = max(1, dc.batch_size // n_replicas)
    local_valid_bs = max(1, dc.valid_batch_size // n_replicas)
    shard = None
    if n_replicas > 1:
        from ..parallel.mesh import rank

        shard = (rank(), n_replicas)
    caps = None
    if dc.max_nodes and dc.max_edges:
        caps = {"n_nodes": dc.max_nodes, "n_edges": dc.max_edges, "n_graphs": local_bs + 1}
    # kernel routes (v2, mega): the loaders emit the block-aligned slot
    # layout with a fixed slot capacity
    kernel_layout = kernel_layout_from_model_kwargs(mc.model_kwargs)
    train_loader = DataLoader(train_set, local_bs, capacities=caps, shuffle=True,
                              seed=tc.seed or 0, process_shard=shard,
                              kernel_layout=kernel_layout, prefetch=2)
    valid_loader = DataLoader(valid_set, local_valid_bs, capacities=train_loader.caps,
                              process_shard=shard, kernel_layout=kernel_layout)
    logger.info(f"padded capacities: {train_loader.caps}")
    if n_replicas > 1:
        from ..parallel.data_parallel import ReplicaBatcher

        logger.info(f"data parallel: {n_replicas} processes, local batch {local_bs} (global "
                    f"{dc.batch_size})")
        train_loader = ReplicaBatcher(train_loader)
        valid_loader = ReplicaBatcher(valid_loader)

    # node shift / scale from the training statistics
    model_kwargs = dict(mc.model_kwargs)
    if dc.node_shift is True or dc.node_scale is True:
        stats = calculate_stats(train_set, dc.targets)
        if dc.node_shift is True:
            model_kwargs["node_shift"] = stats["node_shift"]
        if dc.node_scale is True:
            model_kwargs["node_scale"] = stats["node_scale"]
        logger.info(f"energy stats: {stats}")
    else:
        if not isinstance(dc.node_shift, bool):
            model_kwargs["node_shift"] = float(dc.node_shift)
        if not isinstance(dc.node_scale, bool):
            model_kwargs["node_scale"] = float(dc.node_scale)
    config.model.model_kwargs = model_kwargs

    module, extra, _cutoff = resolve_model(mc.model_name, **model_kwargs)
    init_params(module, seed=tc.seed or 0)
    n_params = sum(p.numel() for p in module.parameters())
    logger.info(f"model {mc.model_name}: {n_params / 1e6:.3f}M parameters")

    trainer = Trainer(config=config, module=module, extra=extra, train_loader=train_loader,
                      valid_loader=valid_loader, steps_per_epoch=len(train_loader),
                      device=dev, logger=logger)
    trainer.start()
    return trainer


def run_train_from_args(args) -> Trainer:
    """``args.config`` (a YAML path), optional ``args.ckpt`` / ``args.resume``
    / ``args.device``."""
    config = load_config(args.config)
    if getattr(args, "ckpt", None):
        config.trainer.ckpt_file = args.ckpt
    if getattr(args, "resume", False):
        config.trainer.resume = True
    return run_train(config, device=getattr(args, "device", None))
