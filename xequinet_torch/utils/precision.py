"""Matmul precision control.

Port of ``xequinet_tpu/utils/precision.py:23`` with its meaning on the
card.  The JAX knob sets ``jax_default_matmul_precision`` (single-pass
bf16 on the TPU by default); the port's rule is exact f32 matmuls (no
TF32 anywhere), and the names map onto PyTorch's f32-matmul settings:

* ``None`` / ``"default"``: the port's rule, no TF32;
* ``"float32"`` / ``"highest"``: no TF32 and no reduced-precision f32
  matmul (the same as ``None`` on the port);
* ``"tensorfloat32"``: TF32 tensor cores for f32 matmuls and convolutions;
* ``"bfloat16"``: f32 matmuls may use bf16 passes (``"medium"``).

The bf16 compute dtypes of a model (``compute_dtype``) are not touched:
they are the model's own, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

_VALID = ("bfloat16", "tensorfloat32", "float32", "highest", "default")
_TORCH = {"float32": "highest", "tensorfloat32": "high", "bfloat16": "medium"}


def set_matmul_precision(precision: Optional[str]) -> None:
    """Set the f32 matmul precision ("bfloat16" | "tensorfloat32" |
    "float32" / "highest"); None / "default" keeps the port's rule (no
    TF32)."""
    if precision is None or precision == "default":
        precision = "float32"
    if precision == "highest":
        precision = "float32"
    if precision not in _VALID:
        raise ValueError(f"matmul_precision {precision!r}; choose one of {_VALID}")
    tf32 = precision == "tensorfloat32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision(_TORCH[precision])
