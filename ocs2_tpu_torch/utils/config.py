"""Config system: reference-compatible ``.info`` task files.

Counterpart of ``ocs2_tpu/utils/config.py`` (the reference's Boost
property-tree config loading, ocs2_core/misc/LoadData.h: loadPtreeValue /
loadCppDataType / loadEigenMatrix, and the per-module ``loadSettings``).

The parser accepts the Boost INFO grammar subset the reference task files
use:

    ; comment
    key   value
    section
    {
      nested   3.14      ; trailing comment
      (0,0)    1.0       ; matrix entry
    }

so existing OCS2 task files load unchanged.  ``load_settings`` maps camelCase
keys onto the snake_case fields of the port's settings dataclasses;
``load_matrix`` reads the reference's scaling + (i,j) matrix blocks into a
float32 tensor on ``device``.  Everything but ``load_matrix`` is plain Python.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Optional, Type, TypeVar

import numpy as np
import torch

T = TypeVar("T")

_TOKEN = re.compile(r'"[^"]*"|\{|\}|[^\s{}]+')


def _tokenize(text: str):
    for raw_line in text.splitlines():
        line = raw_line.split(";")[0].split("#")[0].split("//")[0]
        for tok in _TOKEN.findall(line):
            yield tok.strip('"')
    yield None  # sentinel


def parse_info(text: str) -> Dict[str, Any]:
    """Parse INFO text into nested dicts of strings."""
    tokens = _tokenize(text)

    def parse_block():
        tree: Dict[str, Any] = {}
        pending_key: Optional[str] = None
        while True:
            tok = next(tokens)
            if tok is None or tok == "}":
                if pending_key is not None:
                    tree[pending_key] = ""
                return tree
            if tok == "{":
                key = pending_key if pending_key is not None else ""
                pending_key = None
                tree[key] = parse_block()
                continue
            if pending_key is None:
                pending_key = tok
            else:
                tree[pending_key] = tok
                pending_key = None

    return parse_block()


def load_info(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return parse_info(f.read())


def get_path(tree: Dict[str, Any], dotted: str, default=None):
    """Fetch ``a.b.c`` from a nested dict (loadPtreeValue semantics)."""
    node: Any = tree
    for part in dotted.split("."):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def _coerce(value: str, target_type):
    if target_type is bool:
        return value.lower() in ("true", "1", "yes")
    if target_type is int:
        return int(float(value))
    if target_type is float:
        return float(value)
    return value


_CAMEL = re.compile(r"(?<=[a-z0-9])(?=[A-Z])")


def camel_to_snake(name: str) -> str:
    return _CAMEL.sub("_", name).lower()


def load_settings(
    tree: Dict[str, Any], prefix: str, settings_cls: Type[T], **overrides
) -> T:
    """Build a settings dataclass from a config subtree.

    Mirrors the reference's per-module loadSettings(filename, fieldName):
    camelCase keys in the file map onto snake_case dataclass fields; fields
    absent from the file keep their defaults; ``overrides`` win over both.
    """
    sub = get_path(tree, prefix, {}) if prefix else tree
    fields = {f.name: f for f in dataclasses.fields(settings_cls)}
    kwargs: Dict[str, Any] = {}
    if isinstance(sub, dict):
        for key, value in sub.items():
            if isinstance(value, dict):
                continue
            name = camel_to_snake(key)
            if name in fields:
                ftype = fields[name].type
                if isinstance(ftype, str):
                    ftype = {"int": int, "float": float, "bool": bool,
                             "str": str}.get(ftype, str)
                kwargs[name] = _coerce(value, ftype)
    kwargs.update(overrides)
    return settings_cls(**kwargs)


def load_matrix(tree: Dict[str, Any], key: str, shape, device="cuda") -> torch.Tensor:
    """Read the reference's matrix block format (LoadData.h loadEigenMatrix):

        key { scaling 1e0   (0,0) 1.0   (1,1) 2.0 ... }

    Unlisted entries are zero.  ``shape`` may be (n,) for vectors.  A float32
    tensor on ``device``."""
    sub = get_path(tree, key)
    if sub is None:
        raise KeyError(f"matrix block '{key}' not found")
    scaling = float(sub.get("scaling", 1.0)) if isinstance(sub, dict) else 1.0
    mat = np.zeros(shape, np.float32)
    for entry, value in sub.items():
        m = re.match(r"\((\d+)(?:,(\d+))?\)", entry)
        if not m:
            continue
        i = int(m.group(1))
        if m.group(2) is None or len(shape) == 1:
            mat[i] = float(value)
        else:
            mat[i, int(m.group(2))] = float(value)
    return torch.as_tensor(scaling * mat, dtype=torch.float32, device=device)


def load_scalar(tree: Dict[str, Any], dotted: str, default: float = 0.0) -> float:
    v = get_path(tree, dotted, default)
    return float(v)


def load_bool(tree: Dict[str, Any], dotted: str, default: bool = False) -> bool:
    v = get_path(tree, dotted, None)
    if v is None:
        return default
    return str(v).lower() in ("true", "1", "yes")
