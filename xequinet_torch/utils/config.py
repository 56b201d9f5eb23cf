"""Config schema: {model, trainer, data} dataclasses merged with YAML or a
plain dict of overrides.

Copy of ``xequinet_tpu/utils/config.py:18-104, 145-170, 186-187``: field
names stay one to one, so the JAX package's YAML configs load unchanged
(its TPU-only fields, such as ``compile_cache`` and the halo settings, are
accepted and read by nothing on the port's single-device path).  The
port adds ``trainer.device``.  ``yaml`` is imported only when a YAML path
is given.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ModelConfig:
    model_name: str = "xpainn"
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    default_units: Dict[str, str] = field(default_factory=dict)


@dataclass
class TrainerConfig:
    run_name: str = "xequinet"
    ckpt_file: Optional[str] = None
    resume: bool = False
    finetune_modules: Optional[List[str]] = None
    warmup_scheduler: Optional[str] = "linear"
    warmup_epochs: int = 10
    max_epochs: int = 300
    max_lr: float = 5e-4
    min_lr: float = 0.0
    lossfn: str = "smoothl1"
    losses_weight: Dict[str, float] = field(default_factory=dict)
    grad_clip: Optional[float] = None
    optimizer: str = "adamW"
    optimizer_kwargs: Dict[str, Any] = field(default_factory=dict)
    lr_scheduler: str = "cosine_annealing"
    lr_scheduler_kwargs: Dict[str, Any] = field(default_factory=dict)
    early_stoppings: Optional[Dict[str, Any]] = None
    early_stopping_mode: str = "and"
    ema_decay: Optional[float] = None
    seed: Optional[int] = None
    num_workers: int = 0

    save_dir: str = "./"
    best_k: int = 1
    log_file: str = "loss.log"
    log_steps: int = 50
    log_epochs: int = 1

    # ---- the JAX package's TPU settings (kept so its configs load) -----
    dp_devices: int = 0
    compile_cache: Any = True
    gp_devices: int = 0
    halo_width: int = 0
    halo_margin: float = 1.3
    # bf16 accuracy mitigation: the last K epochs run with float32 compute
    # dtypes; checkpoints saved after the switch embed f32
    f32_finetune_epochs: int = 0

    # ---- the port ------------------------------------------------------
    # "cuda", "cpu" or None (the card; raises without one)
    device: Optional[str] = None


@dataclass
class DataConfig:
    db_path: str = "./"
    cutoff: float = 5.0
    split: str = "split"
    targets: List[str] = field(default_factory=list)
    base_targets: Optional[List[str]] = None
    default_dtype: str = "float32"
    node_shift: Any = False
    node_scale: Any = False
    max_num_samples: int = 1000000
    batch_size: int = 64
    valid_batch_size: int = 64

    # static-shape padding policy: capacities per batch; 0 = derive from
    # batch statistics at startup
    max_nodes: int = 0
    max_edges: int = 0


@dataclass
class XequiConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    trainer: TrainerConfig = field(default_factory=TrainerConfig)
    data: DataConfig = field(default_factory=DataConfig)


def _merge_into(obj: Any, data: Dict[str, Any], path: str = "") -> Any:
    """Recursively merge a dict into a dataclass instance, validating keys."""
    names = {f.name: f for f in dataclasses.fields(obj)}
    for k, v in (data or {}).items():
        if k not in names:
            raise KeyError(f"unknown config key {path}{k}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge_into(cur, v, path=f"{path}{k}.")
        else:
            setattr(obj, k, v)
    return obj


def load_config(yaml_file: Optional[str] = None, overrides: Optional[Dict] = None) -> XequiConfig:
    cfg = XequiConfig()
    if yaml_file is not None:
        import yaml

        with open(yaml_file) as f:
            data = yaml.safe_load(f) or {}
        _merge_into(cfg, data)
    if overrides:
        _merge_into(cfg, overrides)
    return cfg


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
