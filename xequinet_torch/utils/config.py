"""Config schema: {model, trainer, data} dataclasses and the MD config,
merged with YAML or a plain dict of overrides.

Copy of ``xequinet_tpu/utils/config.py:18-187``: field names stay one to
one, so the JAX package's YAML configs load unchanged (its TPU-only
fields, such as ``compile_cache`` and the halo settings, are accepted and
read by nothing on the port's single-device path).  The port adds
``trainer.device``; ``MDConfig.device`` ("cuda", "cpu" or None for the
card) is the JAX field, read by the port's ``run_md``.

The configs are read by the port's own block-YAML reader
(:func:`yaml_loads`), on every machine, so that PyYAML is no dependency.
It takes the subset the configs use and resolves plain scalars as
PyYAML's ``safe_load`` does (YAML 1.1); anything else raises
:class:`YAMLError` naming the line.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


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


@dataclass
class MDConfig:
    ensembles: List[Any] = field(default_factory=list)
    input_file: str = "input.xyz"
    input_format: Optional[str] = None
    model_file: str = "model.ckpt"
    delta_method: Optional[str] = None
    init_temperature: float = 300.0  # Kelvin
    logfile: str = "md.log"
    append_logfile: bool = False
    trajectory: Optional[str] = None
    append_trajectory: bool = False
    xyz_traj: Optional[str] = None
    columns: Optional[List[str]] = None
    dtype: str = "float32"
    # "cuda", "cpu" or None (the card; raises without one)
    device: Optional[str] = None
    seed: Optional[int] = None
    # "mega": the fused message kernels on the MD hot loop, for free
    # systems whose sorted neighbour reach fits a window and for periodic
    # ones through the ghost layout (ops/spatial_sort); other systems take
    # the plain route by the JAX Calculator's own size rules
    pallas: Optional[str] = None
    # >1: one system halo-decomposed over this many processes, one per
    # card (parallel/halo.HaloCalculator; torchrun or the caller's group)
    halo_devices: int = 0
    # the JAX package's persistent XLA cache; accepted, no effect here
    compile_cache: Any = True
    # None = the port's rule (no TF32); see utils/precision.py
    matmul_precision: Optional[str] = None
    # Verlet skin (model length units): neighbour lists at cutoff+skin,
    # reused until an atom drifts skin/2 (interface/calculator.py)
    skin: float = 0.0


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
        _merge_into(cfg, read_yaml(yaml_file) or {})
    if overrides:
        _merge_into(cfg, overrides)
    return cfg


def load_md_config(yaml_file: Optional[str] = None, overrides: Optional[Dict] = None) -> MDConfig:
    cfg = MDConfig()
    if yaml_file is not None:
        _merge_into(cfg, read_yaml(yaml_file) or {})
    if overrides:
        _merge_into(cfg, overrides)
    return cfg


def config_to_dict(cfg: Any) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# Block YAML, the subset the configs use
# ---------------------------------------------------------------------------
class YAMLError(ValueError):
    """A YAML text outside the subset :func:`yaml_loads` takes."""


# the scalars of the configs, resolved as PyYAML's ``safe_load`` resolves
# them: null, true / false, decimal ints, floats with a dot (an exponent
# with a sign)
_BOOL = {"true": True, "True": True, "TRUE": True, "false": False, "False": False,
         "FALSE": False}
_NULL = {"~", "null", "Null", "NULL", ""}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?")
# what PyYAML resolves otherwise (YAML 1.1 bools, octal, hex and binary
# ints, digits with underscores, infinities, sexagesimal numbers, dates)
# or reads as a string (an exponent without a dot or a sign): refused
_REFUSED = re.compile(r"yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF"
                      r"|[-+]?0b[0-1_]+|[-+]?0x[0-9a-fA-F_]+"
                      r"|[-+]?(?:[0-9][0-9_]*\.?[0-9_]*|\.[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)?"
                      r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?|=|<<")
_ESCAPES = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}


def _plain(text: str, line: int) -> Any:
    """A plain scalar, resolved as PyYAML resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _REFUSED.fullmatch(text):
        raise YAMLError(f"line {line}: {text!r} is not taken (PyYAML would read it as a bool, "
                        "a number in another form, a date or a string); write true / false, "
                        "a decimal number such as 1.0e-4, or quote a string")
    if text[0] in "[]{},#&*!|>'\"%@`?:" or text == "-" or text.startswith("- ") \
            or ": " in text or text.endswith(":") or " #" in text:
        raise YAMLError(f"line {line}: {text!r} is not a plain scalar this reader takes")
    return text


def _quoted(text: str, pos: int, line: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]`` and the position after it."""
    q = text[pos]
    out, i = [], pos + 1
    while i < len(text):
        c = text[i]
        if q == "'":
            if c == "'":
                if text[i + 1 : i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), i + 1
        if c == "\\":
            e = text[i + 1 : i + 2]
            if e not in _ESCAPES:
                raise YAMLError(f"line {line}: the escape \\{e} is not taken")
            out.append(_ESCAPES[e])
            i += 2
            continue
        out.append(c)
        i += 1
    raise YAMLError(f"line {line}: unterminated {q}-quoted string (quoted strings over "
                    "several lines are not taken)")


def _flow(text: str, pos: int, line: int, stops: str) -> Tuple[Any, int]:
    """The flow node at ``text[pos]`` (a ``[...]`` list, a ``{...}``
    mapping, a quoted or a plain scalar ending before one of ``stops``)."""
    while pos < len(text) and text[pos] == " ":
        pos += 1
    if pos >= len(text):
        raise YAMLError(f"line {line}: unexpected end of a flow collection")
    c = text[pos]
    if c in "[{":
        close = "]" if c == "[" else "}"
        out: Any = [] if c == "[" else {}
        pos += 1
        while True:
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if pos >= len(text):
                raise YAMLError(f"line {line}: unclosed {c}")
            if text[pos] == close:
                return out, pos + 1
            if c == "[":
                item, pos = _flow(text, pos, line, ",]")
                out.append(item)
            else:
                key, pos = _flow(text, pos, line, ":,}")
                while pos < len(text) and text[pos] == " ":
                    pos += 1
                value = None
                if text[pos : pos + 1] == ":":
                    nxt = text[pos + 1 : pos + 2]
                    if nxt in ",}":
                        pos += 1
                    else:
                        value, pos = _flow(text, pos + 1, line, ",}")
                if key in out:
                    raise YAMLError(f"line {line}: duplicate key {key!r}")
                out[key] = value
            while pos < len(text) and text[pos] == " ":
                pos += 1
            if text[pos : pos + 1] == ",":
                pos += 1
            elif text[pos : pos + 1] != close:
                raise YAMLError(f"line {line}: expected ',' or {close!r} in a flow collection")
    if c in "'\"":
        return _quoted(text, pos, line)
    end = pos
    while end < len(text) and text[end] not in stops.replace(":", "") and \
            not (":" in stops and text[end] == ":" and text[end + 1 : end + 2] in " ,}"):
        end += 1
    return _plain(text[pos:end].strip(), line), end


def _inline(text: str, line: int) -> Any:
    """The value after ``key:`` or ``-`` on one logical line."""
    if text[0] in "[{'\"":
        value, end = _flow(text, 0, line, "")
        if text[end:].strip():
            raise YAMLError(f"line {line}: unexpected {text[end:].strip()!r} after a value")
        return value
    return _plain(text, line)


def _strip_comment(raw: str, line: int, depth: int) -> Tuple[str, int]:
    """The line without its comment, and the flow nesting depth after it."""
    i, quote = 0, None
    while i < len(raw):
        c = raw[i]
        if quote == "'":
            if c == "'":
                if raw[i + 1 : i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif c in "'\"" and (i == 0 or raw[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            raw = raw[:i]
            break
        elif c in "[{":
            depth += 1
        elif c in "]}":
            depth -= 1
        i += 1
    if quote is not None:
        raise YAMLError(f"line {line}: unterminated {quote}-quoted string (quoted strings over "
                        "several lines are not taken)")
    return raw.rstrip(), depth


def _logical_lines(text: str) -> List[Tuple[int, int, str]]:
    """(line number, indent, content) of each non-empty line, comments
    removed, a flow collection over several lines joined into one."""
    out: List[Tuple[int, int, str]] = []
    pending = None  # (line, indent, parts, depth) of an open flow collection
    for n, raw in enumerate(text.splitlines(), 1):
        if pending is None:
            body = raw.lstrip(" ")
            if body.startswith("\t"):
                raise YAMLError(f"line {n}: a tab in the indentation")
            content, depth = _strip_comment(body, n, 0)
            if not content:
                continue
            if content in ("---", "..."):
                if out:
                    raise YAMLError(f"line {n}: one document per file")
                continue
            if content[0] in "&*!|>%?" or re.search(r"(?:^|[\s:])[&*!][^\s,\]}]", content) or \
                    re.search(r":\s+[|>][-+0-9]*$", content):
                raise YAMLError(f"line {n}: anchors, aliases, tags, directives, complex keys "
                                "and block scalars are not taken")
            if depth > 0:
                pending = (n, len(raw) - len(body), [content], depth)
            elif depth < 0:
                raise YAMLError(f"line {n}: unbalanced brackets")
            else:
                out.append((n, len(raw) - len(body), content))
            continue
        first, indent, parts, depth = pending
        content, depth = _strip_comment(raw.strip(), n, depth)
        if content:
            parts.append(content)
        if depth < 0:
            raise YAMLError(f"line {n}: unbalanced brackets")
        pending = (first, indent, parts, depth)
        if depth == 0:
            out.append((first, indent, " ".join(parts)))
            pending = None
    if pending is not None:
        raise YAMLError(f"line {pending[0]}: unclosed flow collection")
    return out


def _split_key(content: str, line: int) -> Optional[Tuple[Any, str]]:
    """(key, the rest) of a ``key: value`` line, or None when the line is
    not a mapping entry."""
    if content[0] in "'\"":
        key, pos = _quoted(content, 0, line)
        rest = content[pos:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if content[0] in "[{":
        return None
    m = re.search(r":(?: |$)", content)
    if m is None:
        return None
    return _plain(content[: m.start()].strip(), line), content[m.end():].strip()


class _BlockParser:
    def __init__(self, lines: List[Tuple[int, int, str]]) -> None:
        self.lines = lines
        self.i = 0

    def _peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    @staticmethod
    def _is_item(content: str) -> bool:
        return content == "-" or content.startswith("- ")

    def node(self, indent: int) -> Any:
        line = self._peek()
        if self._is_item(line[2]):
            return self.sequence(indent)
        return self.mapping(indent)

    def _nested(self, indent: int, line: int, allow_item: bool) -> Any:
        """The block below an entry whose value is empty (None if none)."""
        nxt = self._peek()
        if nxt is not None and (nxt[1] > indent or (allow_item and nxt[1] == indent
                                                    and self._is_item(nxt[2]))):
            return self.node(nxt[1])
        return None

    def _no_continuation(self, indent: int, line: int) -> None:
        nxt = self._peek()
        if nxt is not None and nxt[1] > indent:
            raise YAMLError(f"line {nxt[0]}: a value continued on the next line, or a block "
                            f"under a value (after line {line}), is not taken")

    def mapping(self, indent: int) -> Dict:
        out: Dict = {}
        while True:
            cur = self._peek()
            if cur is None or cur[1] != indent or self._is_item(cur[2]):
                break
            n, _, content = cur
            kv = _split_key(content, n)
            if kv is None:
                raise YAMLError(f"line {n}: expected 'key: value', got {content!r}")
            key, rest = kv
            if key in out:
                raise YAMLError(f"line {n}: duplicate key {key!r}")
            self.i += 1
            if rest:
                out[key] = _inline(rest, n)
                self._no_continuation(indent, n)
            else:
                out[key] = self._nested(indent, n, allow_item=True)
        cur = self._peek()
        if cur is not None and cur[1] > indent:
            raise YAMLError(f"line {cur[0]}: unexpected indentation")
        return out

    def sequence(self, indent: int) -> List:
        out: List = []
        while True:
            cur = self._peek()
            if cur is None or cur[1] != indent or not self._is_item(cur[2]):
                break
            n, _, content = cur
            rest = content[1:].lstrip(" ")
            if not rest:
                self.i += 1
                out.append(self._nested(indent, n, allow_item=False))
                continue
            inner = indent + len(content) - len(rest)
            if self._is_item(rest) or _split_key(rest, n) is not None:
                # "- key: value" / "- - x": a block whose first line
                # starts after the dash
                self.lines[self.i] = (n, inner, rest)
                out.append(self.node(inner))
                continue
            self.i += 1
            out.append(_inline(rest, n))
            self._no_continuation(indent, n)
        cur = self._peek()
        if cur is not None and cur[1] > indent:
            raise YAMLError(f"line {cur[0]}: unexpected indentation")
        return out


def yaml_loads(text: str) -> Any:
    """One YAML document in the block style the configs use: nested
    mappings and block lists (``- x``, also at their key's indent),
    flow lists and mappings (over several lines too), plain, single- and
    double-quoted scalars, comments.  Plain scalars resolve as in PyYAML's
    ``safe_load``: null, bools, ints, floats (a float needs a dot, its
    exponent a sign: ``5.0e-4``).  Anchors, aliases, tags, block scalars,
    multi-line plain or quoted scalars, complex and duplicate keys, and
    scalars PyYAML reads as dates, sexagesimal numbers or exponent strings
    raise :class:`YAMLError` with the line."""
    lines = _logical_lines(text)
    if not lines:
        return None
    parser = _BlockParser(lines)
    first = lines[0]
    if len(lines) == 1 and not parser._is_item(first[2]) and \
            _split_key(first[2], first[0]) is None:
        return _inline(first[2], first[0])
    value = parser.node(first[1])
    if parser.i != len(lines):
        n = lines[parser.i][0]
        raise YAMLError(f"line {n}: unexpected indentation")
    return value


def read_yaml(path: str) -> Any:
    """:func:`yaml_loads` of a file; errors name the file."""
    with open(path) as f:
        text = f.read()
    try:
        return yaml_loads(text)
    except YAMLError as err:
        raise YAMLError(f"{path}: {err}") from None
