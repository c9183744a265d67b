"""Run configuration from a model YAML + ``key=value`` overrides.

Port of ``incagg_gnn_tpu/train/config.py``: a model YAML holds a
``params.<dataset>`` block of architecture + trainer knobs; every override
is a declared ``TrainerConfig`` field, a run field, or an architecture key.
PyYAML is used when it is importable; otherwise :func:`load_yaml` reads the
subset the repository's ``conf/model/*.yaml`` use (block mappings, flow
mappings and sequences, plain scalars, comments), resolving scalars as
PyYAML's YAML 1.1 resolver does.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from incagg_gnn_tpu_torch.train.trainer import TrainerConfig

try:
    import yaml
except ImportError:  # the port's GPU machine has no PyYAML
    yaml = None


# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_NULL = ("", "~", "null", "Null", "NULL")


def _scalar(tok: str) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        return tok[1:-1]
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.match(tok):
        return int(tok.replace("_", ""))
    if _FLOAT.match(tok):
        return float(tok.replace("_", ""))
    if _INF.match(tok):
        return float("-inf") if tok.startswith("-") else float("inf")
    if _NAN.match(tok):
        return float("nan")
    return tok


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at line start or after whitespace, outside
    quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _flow(text: str, i: int) -> Tuple[Any, int]:
    """Parse a flow collection or scalar starting at ``text[i]``; returns
    (value, index after it)."""
    while text[i] == " ":
        i += 1
    if text[i] not in "{[":
        j = i
        while j < len(text) and text[j] not in ",]}":
            j += 1
        return _scalar(text[i:j]), j
    close = "}" if text[i] == "{" else "]"
    out: Any = {} if close == "}" else []
    i += 1
    while True:
        while text[i] in " ,":
            i += 1
        if text[i] == close:
            return out, i + 1
        if close == "}":
            j = text.index(":", i)
            out[_scalar(text[i:j])], i = _flow(text, j + 1)
        else:
            val, i = _flow(text, i)
            out.append(val)


def _balanced(s: str) -> bool:
    return s.count("{") + s.count("[") == s.count("}") + s.count("]")


def _block(lines: List[Tuple[int, str]], pos: int, indent: int) -> Tuple[Dict, int]:
    """Parse a block mapping whose keys sit at ``indent``."""
    out: Dict[Any, Any] = {}
    while pos < len(lines):
        ind, text = lines[pos]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"unexpected indentation: {text!r}")
        key, sep, rest = text.partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {text!r}")
        rest = rest.strip()
        pos += 1
        if not rest:
            if pos < len(lines) and lines[pos][0] > indent:
                out[_scalar(key)], pos = _block(lines, pos, lines[pos][0])
            else:
                out[_scalar(key)] = None
            continue
        while not _balanced(rest):  # a flow collection continued on next lines
            rest += " " + lines[pos][1]
            pos += 1
        out[_scalar(key)] = _flow(rest, 0)[0]
    return out, pos


def load_yaml(text: str) -> Dict:
    """Read the YAML subset of the model configs (see module docstring)."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    return _block(lines, 0, lines[0][0] if lines else 0)[0]


def _load_doc(text: str) -> Any:
    return yaml.safe_load(text) if yaml is not None else load_yaml(text)


def _load_value(text: str) -> Any:
    return yaml.safe_load(text) if yaml is not None else _flow(text, 0)[0]


# ---------------------------------------------------------------------------
# run config
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunConfig:
    model: str  # GCN, GCN2, GraphSAGE, APPNP and GAT are ported so far
    dataset: str
    root: str = "/tmp/datasets"
    architecture: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trainer: TrainerConfig = dataclasses.field(default_factory=TrainerConfig)
    hist_dtype: str = "float32"
    log_every: int = 1


_TRAINER_KEYS = {f.name for f in dataclasses.fields(TrainerConfig)}


def load_config(model_yaml: str, dataset: str,
                overrides: Optional[Dict[str, Any]] = None) -> RunConfig:
    """Compose a run config from a model YAML's per-dataset block +
    overrides (layout of conf/model/*.yaml)."""
    with open(model_yaml) as f:
        doc = _load_doc(f.read())
    name = doc["name"]
    if dataset not in doc.get("params", {}):
        raise KeyError(
            f"model {name} has no hyperparameter block for dataset "
            f"{dataset!r}; available: {sorted(doc.get('params', {}))}")
    block = dict(doc["params"][dataset])
    arch = dict(block.pop("architecture", {}))

    tkw: Dict[str, Any] = {"loop": bool(doc.get("loop", True)),
                           "norm": bool(doc.get("norm", True))}
    alias = {"VR_update": "vr_update"}
    for k, v in block.items():
        k = alias.get(k, k)
        if k in _TRAINER_KEYS:
            if k == "grad_norm" and (v is None or isinstance(v, str)):
                v = None  # reference YAMLs use 'none'/null strings
            tkw[k] = v
    cfg = RunConfig(model=name, dataset=dataset, architecture=arch)

    for k, v in (overrides or {}).items():
        k = alias.get(k, k)
        if k in _TRAINER_KEYS:
            tkw[k] = v
        elif k in ("model", "dataset", "root", "hist_dtype", "log_every"):
            setattr(cfg, k, v)
        else:
            cfg.architecture[k] = v

    if isinstance(tkw.get("grad_norm"), str):
        tkw["grad_norm"] = None
    cfg.trainer = TrainerConfig(**tkw)
    return cfg


def parse_overrides(argv) -> Dict[str, Any]:
    """Parse ``key=value`` CLI overrides with YAML-typed values."""
    out = {}
    for a in argv:
        if "=" not in a:
            raise ValueError(f"override must be key=value, got {a!r}")
        k, v = a.split("=", 1)
        out[k.lstrip("+")] = _load_value(v)
    return out
