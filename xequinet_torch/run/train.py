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
writing the checkpoints (``parallel/``).

Halo training (``trainer.gp_devices > 1``, :func:`run_halo_train`): every
structure of the dataset is one large system split over ``gp_devices``
processes; with ``dp_devices > 1`` a batch of systems trains over ``dp x
gp`` processes.
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


def run_halo_train(config: XequiConfig, logger=None, device=None):
    """Config-driven training on systems too large for one card
    (``trainer.gp_devices``; JAX run/train.py:87-437): every structure is
    one large system halo-decomposed over ``gp_devices`` processes
    (``parallel/halo.make_halo_train_step``); with ``dp_devices`` > 1 a
    batch of ``dp`` systems trains over ``dp x gp`` processes
    (``make_halo_dp_train_step``).  Launch ``dp x gp`` processes with
    torchrun, or call it inside a process group of that size.

    One geometry serves every system: n_local from the largest system,
    halo and edge capacities sized over the whole dataset (+ margin), so
    the shapes never change.  With ``use_pallas_scatter: mega`` each shard
    runs the fused message kernels over its window
    (``apply_halo_kernel_layout``); the slot capacities are sized over the
    dataset too, and the derived ``pallas_layout`` is written back into the
    checkpointed model config.  A dataset that mixes periodic and free
    systems, and the v2 kernel (not halo-aware), are refused.  Rank 0
    writes ``{run_name}_last.ckpt`` and ``{run_name}_best.ckpt`` each epoch.
    Returns the trained module."""
    from ..parallel.halo import (_ceil_to, apply_halo_kernel_layout, local_batch,
                                 make_halo_loss_fn, make_halo_train_step, prepare_halo_system,
                                 scatter_labels_to_shards)
    from ..parallel.mesh import make_groups, maybe_init_distributed, rank, world_size
    from ..training.lr_schedule import resolve_lr_schedule, resolve_optimizer, set_lr
    from ..training.trainer import save_checkpoint
    from ..utils.config import config_to_dict

    tc, dc, mc = config.trainer, config.data, config.model
    dev = resolve_device(device if device is not None else tc.device)
    ups = mc.model_kwargs.get("use_pallas_scatter")
    use_mega = ups in ("mega", "mega-xb")
    if ups and not use_mega:
        raise ValueError("halo training runs the mega kernels (use_pallas_scatter='mega'/"
                         "'mega-xb') or the plain message route; the v2 kernel is not "
                         "halo-aware")
    if tc.seed is not None:
        np.random.seed(tc.seed)
    if mc.default_units:
        set_default_units(mc.default_units)

    # datasets without the neighbour transform: the halo pipeline builds its
    # own sorted graph per system
    probe = XDBDataset(dc.db_path, split="train", split_name=dc.split)
    units = probe.units
    probe.reader.close()
    transform = build_transform_pipeline(
        data_units=units, base_targets=dc.base_targets, cutoff=None,
        svd_frame=bool(mc.model_kwargs.get("use_pbc") is False
                       and mc.model_name.endswith("ewald")),
        vector_targets=[keys.DIPOLE] if keys.DIPOLE in dc.targets else [],
        atomic_vector_targets=[keys.FORCES] if keys.FORCES in dc.targets else [])
    train_set, valid_set = (
        XDBDataset(dc.db_path, split=split, split_name=dc.split, transform=transform,
                   max_num_samples=dc.max_num_samples) for split in ("train", "valid"))
    # the exchange ring's topology (wrapping or open) is one for every system
    periodic_flags = {bool(ds[i].has_cell and np.any(ds[i].pbc))
                      for ds in (train_set, valid_set) for i in range(len(ds))}
    if len(periodic_flags) > 1:
        raise ValueError(
            "halo training requires a homogeneous dataset (all periodic or all free "
            "systems): the exchange-ring topology is one for every system — split the "
            "dataset into a periodic and a free run, or train molecule-batched with "
            "dp_devices (docs/config.md)")

    maybe_init_distributed(dev)
    gp = int(tc.gp_devices)
    avail = world_size()
    dp = tc.dp_devices if tc.dp_devices > 0 else max(1, avail // gp)
    if dp * gp != avail:
        raise ValueError(f"gp_devices={gp} x dp_devices={dp} needs {dp * gp} processes; the "
                         f"process group has {avail}")
    gp_group, dp_group = make_groups(dp, gp)
    replica, shard = rank() // gp, rank() % gp
    logger = logger or ZeroLogger(os.path.join(tc.save_dir, tc.log_file))
    logger.info(f"halo training: dp={dp} x gp={gp} processes on {dev}")
    logger.info(f"datasets: train={len(train_set)} valid={len(valid_set)}")

    # ---- one geometry over the whole dataset -------------------------------
    n_max = max(len(ds[i].atomic_numbers) for ds in (train_set, valid_set)
                for i in range(len(ds)))
    nl_exact = _ceil_to((n_max + gp - 1) // gp, 8)
    halo0 = tc.halo_width or None
    cap = None
    preps = {}
    cache_cap = max(64, 8 * dp)
    if use_mega:
        u_bn, u_chunk = tuple(mc.model_kwargs.get("pallas_layout", (256, 1024, 32, 8)))[:2]
        k_bn, k_chunk = min(int(u_bn), nl_exact), int(u_chunk)
    mega_state = {"slot_cap": None, "max_chunks": None}

    def prep(ds, i):
        nonlocal halo0, cap
        dpnt = ds[i]
        key = (id(ds), i)
        if key not in preps:
            stacked, geom, perm, wshift, halo0, cap = prepare_halo_system(
                dpnt.atomic_numbers, dpnt.pos, dc.cutoff, gp,
                cell=dpnt.cell if dpnt.has_cell else None,
                pbc=dpnt.pbc if dpnt.has_cell else None, halo=None, edge_cap=None,
                margin=tc.halo_margin, nl_exact=nl_exact, min_halo=halo0, min_edge_cap=cap)
            sig = [halo0, cap]
            if dpnt.charge is not None:
                stacked[keys.TOTAL_CHARGE] = np.full((gp, 1), dpnt.charge, np.int32)
            if dpnt.spin is not None:
                stacked[keys.TOTAL_SPIN] = np.full((gp, 1), dpnt.spin, np.int32)
            if use_mega:
                stacked, sc, mxc = apply_halo_kernel_layout(
                    stacked, geom, {"block_nodes": k_bn, "chunk": k_chunk},
                    min_slot_cap=mega_state["slot_cap"],
                    min_max_chunks=mega_state["max_chunks"])
                mega_state["slot_cap"], mega_state["max_chunks"] = sc, mxc
                sig += [sc, mxc]
            f_arr = (np.asarray(dpnt.forces, np.float32) if dpnt.forces is not None
                     else np.zeros((len(dpnt.atomic_numbers), 3), np.float32))
            preps[key] = (stacked, geom, np.float32(dpnt.energy),
                          scatter_labels_to_shards(stacked, geom, f_arr[perm]),
                          np.zeros(3, np.float32) if wshift is None
                          else np.asarray(wshift, np.float32), tuple(sig))
            if len(preps) > cache_cap:
                preps.pop(next(k for k in preps if k != key))
        return preps[key]

    # sizing passes: every system, until every cached partition shares the
    # final capacities (the slot layout depends on the final halo)
    for _ in range(4):
        for ds in (train_set, valid_set):
            for i in range(len(ds)):
                prep(ds, i)
        final_sig = (halo0, cap) + ((mega_state["slot_cap"], mega_state["max_chunks"])
                                    if use_mega else ())
        stale = [k for k in preps if preps[k][5] != final_sig]
        if not stale:
            break
        for k in stale:
            del preps[k]
    else:
        raise AssertionError("halo geometry sizing did not converge")
    geom0 = next(iter(preps.values()))[1]
    logger.info(
        f"halo geometry: n_local={geom0['n_local']} halo={halo0} edge_cap={cap}"
        + (f" kernel(bn={k_bn} chunk={k_chunk} slots={mega_state['slot_cap']} "
           f"max_chunks={mega_state['max_chunks']})" if use_mega else ""))

    # ---- model and optimizer -------------------------------------------------
    model_kwargs = dict(mc.model_kwargs)
    if use_mega:
        # the kernels' layout matches the host slot layout, and the
        # checkpoint embeds it, so the calculators rebuild the same model
        model_kwargs["pallas_layout"] = (k_bn, k_chunk, halo0, mega_state["max_chunks"])
        mc.model_kwargs = model_kwargs
    module, _extra, _cutoff = resolve_model(mc.model_name, **model_kwargs)
    init_params(module, seed=tc.seed or 0)
    module = module.to(dev)
    params = [p for p in module.parameters() if p.requires_grad]
    logger.info(f"model {mc.model_name}: {sum(p.numel() for p in params) / 1e6:.3f}M "
                f"parameters")

    n_train = len(train_set)
    steps_per_epoch = max(1, n_train // dp)
    schedule = resolve_lr_schedule(
        tc.lr_scheduler, tc.max_lr, tc.max_epochs * steps_per_epoch,
        warmup_scheduler=tc.warmup_scheduler or "linear",
        warmup_steps=tc.warmup_epochs * steps_per_epoch, **(tc.lr_scheduler_kwargs or {}))
    optimizer = resolve_optimizer(tc.optimizer, params, **(tc.optimizer_kwargs or {}))
    w = dict(tc.losses_weight or {})
    w_e = float(w.get(keys.TOTAL_ENERGY, w.get("energy", 1.0)))
    w_f = float(w.get(keys.FORCES, w.get("forces", 10.0)))
    step = make_halo_train_step(module, gp_group, dict(geom0), optimizer, energy_weight=w_e,
                                forces_weight=w_f, dp_group=dp_group)
    eval_loss = make_halo_loss_fn(module, gp_group, dict(geom0), energy_weight=w_e,
                                  forces_weight=w_f)

    def valid_loss() -> float:
        tot = 0.0
        for i in range(len(valid_set)):
            stacked, _, e_lbl, f_lbl, wshift = prep(valid_set, i)[:5]
            tot += eval_loss(local_batch(stacked, shard, dev), e_lbl, f_lbl[shard], wshift)
        return tot / max(len(valid_set), 1)

    rng = np.random.default_rng(tc.seed or 0)
    best = float("inf")
    os.makedirs(tc.save_dir, exist_ok=True)
    last_loss = None
    count = 0
    for epoch in range(tc.max_epochs):
        order = rng.permutation(n_train)
        module.train()
        for s in range(steps_per_epoch):
            idx = order[s * dp:(s + 1) * dp]
            if len(idx) < dp:
                break
            stacked, _, e_lbl, f_lbl, wshift = prep(train_set, int(idx[replica]))[:5]
            set_lr(optimizer, schedule(count))
            loss = step(local_batch(stacked, shard, dev), e_lbl, f_lbl[shard], wshift)
            count += 1
            last_loss = float(loss)
        vl = valid_loss()
        logger.info(f"epoch {epoch + 1}/{tc.max_epochs}: train loss {last_loss:.6f}  valid "
                    f"loss {vl:.6f}")
        if rank() == 0:
            mconf = config_to_dict(mc)
            save_checkpoint(os.path.join(tc.save_dir, f"{tc.run_name}_last.ckpt"), module,
                            mconf, epoch=epoch + 1, loss=vl)
            if vl < best:
                best = vl
                save_checkpoint(os.path.join(tc.save_dir, f"{tc.run_name}_best.ckpt"),
                                module, mconf, epoch=epoch + 1, loss=vl)
    return module


def run_train(config: XequiConfig, logger=None, device=None) -> Trainer:
    """Train as the config says; returns the Trainer after its last epoch
    (the trained module for halo training, :func:`run_halo_train`).
    ``device`` (or ``trainer.device``): None = the card."""
    tc, dc, mc = config.trainer, config.data, config.model
    if tc.gp_devices and tc.gp_devices > 1:
        return run_halo_train(config, logger=logger, device=device)
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
