"""Weights and checkpoints of the JAX package, carried into the port.

* :func:`params_from_flax` maps the JAX package's flax parameter tree (a
  nested dict of numpy arrays) onto the port's modules: ``blocks_<i>`` ->
  ``blocks.<i>``, flax ``Dense`` kernels [in, out] -> torch weights
  [out, in], LayerNorm ``scale`` -> ``weight``; every other leaf (O3Linear
  block weights, embeddings, frequencies) maps one to one.
* :func:`load_checkpoint` reads a checkpoint written by the JAX trainer
  (``xequinet_tpu/training/trainer.py:179-214``): a pickle whose
  ``"model"`` / ``"ema_model"`` entries are flax ``serialization.to_bytes``
  msgpack and whose ``"config"`` is a plain dict.  The port's trainer
  writes the same keys with torch state_dicts in place of the msgpack
  blobs; :func:`load_params` loads either kind.  It needs neither jax,
  flax nor the ``msgpack`` package: :func:`msgpack_restore` decodes the
  subset flax writes (maps, arrays, str, bin, ints, floats, nil, bools and
  the ext types 1 = ndarray, 2 = complex, 3 = numpy scalar, each ndarray
  packed as ``(shape, dtype name, buffer)``, plus flax's chunked arrays).
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# msgpack subset
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return bytes(out)

    def unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]


def _decode(r: _Reader) -> Any:
    b = r.unpack(">B")
    if b <= 0x7F:
        return b
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_decode(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    if b >= 0xE0:
        return b - 0x100
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
             0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        return r.unpack(fixed[b])
    lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
    if b in lengths:  # bin
        return r.take(r.unpack(lengths[b]))
    strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
    if b in strs:
        return r.take(r.unpack(strs[b])).decode("utf-8")
    if b in (0xDC, 0xDD):
        n = r.unpack(">H" if b == 0xDC else ">I")
        return [_decode(r) for _ in range(n)]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"))
    fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
    if b in fixext:
        code = r.unpack(">b")
        return _ext(code, r.take(fixext[b]))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack byte 0x{b:02x}")


def _map(r: _Reader, n: int) -> Dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k.decode("utf-8") if isinstance(k, bytes) else k] = _decode(r)
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack_unpackb(data)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        t = torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16)
        return t.float().numpy().reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == 1:
        return _ndarray(data)
    if code == 2:
        re_, im = msgpack_unpackb(data)
        return complex(re_, im)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code}")


def msgpack_unpackb(data: bytes) -> Any:
    r = _Reader(data)
    out = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _dict_to_tuple(d: Dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = _dict_to_tuple(tree["shape"])
            flat = np.concatenate(_dict_to_tuple(tree["chunks"]))
            return flat.reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes) -> Any:
    """flax ``serialization.msgpack_restore`` without msgpack: a nested
    dict of numpy arrays."""
    return _unchunk(msgpack_unpackb(data))


# ---------------------------------------------------------------------------
# Parameter trees and checkpoints
# ---------------------------------------------------------------------------


def _flatten(tree: Dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def params_from_flax(tree: Dict, module: Optional[torch.nn.Module] = None
                     ) -> Dict[str, torch.Tensor]:
    """state_dict of the port's model from a flax parameter tree.  With
    ``module``, raises on any key left unmapped on either side and on a
    shape mismatch."""
    if "params" in tree and len(tree) == 1:
        tree = tree["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        parts = list(path)
        if parts[0].startswith("blocks_"):
            parts[0:1] = ["blocks", parts[0][len("blocks_"):]]
        arr = np.asarray(leaf, dtype=np.float32)
        if parts[-1] == "kernel" and parts[-2].startswith("Dense_"):
            parts[-1] = "weight"
            arr = arr.T
        elif parts[-1] == "scale" and parts[-2].startswith("LayerNorm_"):
            parts[-1] = "weight"
        sd[".".join(parts)] = torch.from_numpy(np.array(arr, copy=True, order="C"))
    if module is not None:
        want = module.state_dict()
        missing = sorted(set(want) - set(sd))
        extra = sorted(set(sd) - set(want))
        if missing or extra:
            raise KeyError(f"unmapped parameters: port-only {missing}, flax-only {extra}")
        for k, v in sd.items():
            if tuple(v.shape) != tuple(want[k].shape):
                raise ValueError(f"{k}: flax {tuple(v.shape)} vs port {tuple(want[k].shape)}")
    return sd


def load_flax_params(module: torch.nn.Module, tree: Dict) -> torch.nn.Module:
    """Load a flax parameter tree into ``module`` (strict)."""
    module.load_state_dict(params_from_flax(tree, module), strict=True)
    return module


def load_params(module: torch.nn.Module, tree: Dict) -> torch.nn.Module:
    """Load either package's checkpointed parameters into ``module``
    (strict): a torch state_dict (the port's checkpoints: flat, tensor
    leaves) as it is, a flax tree (the JAX trainer's) through
    :func:`params_from_flax`."""
    if tree and all(torch.is_tensor(v) for v in tree.values()):
        module.load_state_dict(tree, strict=True)
        return module
    return load_flax_params(module, tree)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Either trainer's checkpoint, with the JAX trainer's parameter blobs
    decoded: its ``"model"`` / ``"ema_model"`` become nested dicts of numpy
    arrays (the port's are state_dicts already); its ``"opt_state"`` stays
    flax bytes; ``"config"`` is the plain dict."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    out = dict(blob)
    for key in ("model", "ema_model"):
        if key in out and isinstance(out[key], (bytes, bytearray)):
            out[key] = msgpack_restore(out[key])
    return out
