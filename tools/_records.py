"""Stored results of the JAX package for the port's CPU tests.

A test of the port compares its result with the JAX package's on the same
inputs.  Where the JAX side is a solve or an LQ approximation that takes
XLA most of a minute to compile, the test module lists those computations in
``JAX_RECORDS`` (name -> function of no arguments returning the JAX result),
``tools/torch_test_records.py --record`` runs them once and stores them in
``tests/torch_data/<test module>_jax.npz``, and the test reads the stored
result back through ``Records``.

A result is stored as its leaves (numpy arrays) under slash-joined paths,
beside the type of every NamedTuple, dict, list and tuple on the way
(``<path>@type``) and a marker for each ``None`` (``<path>@none``);
``unflatten`` rebuilds the same structure, NamedTuples of the JAX package
included, with numpy leaves.  Imports numpy only (and, on loading, the
modules that define the stored NamedTuples).
"""
from __future__ import annotations

import functools
import importlib
import os
from typing import Any, Dict, Mapping

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "torch_data")


def record_path(test_module: str) -> str:
    """The record of a test module (a name like ``test_torch_sqp`` or its
    file's path)."""
    stem = os.path.splitext(os.path.basename(test_module))[0]
    return os.path.join(DATA, f"{stem}_jax.npz")


def flatten(tree: Any, path: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if tree is None:
        out[path + "@none"] = np.zeros(0, np.int8)
    elif hasattr(tree, "_fields"):
        cls = type(tree)
        out[path + "@type"] = np.asarray(f"{cls.__module__}:{cls.__qualname__}")
        for name in tree._fields:
            out.update(flatten(getattr(tree, name), f"{path}/{name}"))
    elif isinstance(tree, Mapping):
        out[path + "@type"] = np.asarray("dict")
        for key, val in tree.items():
            out.update(flatten(val, f"{path}/{key}"))
    elif isinstance(tree, (list, tuple)):
        out[path + "@type"] = np.asarray(type(tree).__name__)
        for i, val in enumerate(tree):
            out.update(flatten(val, f"{path}/{i}"))
    else:
        leaf = np.asarray(tree)
        if leaf.dtype == object:
            raise TypeError(f"{path}: {type(tree).__name__} is not an array leaf")
        out[path] = leaf
    return out


def _class(spec: str):
    module, _, qualname = spec.partition(":")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def unflatten(arrays: Mapping[str, np.ndarray], path: str = "") -> Any:
    if path + "@none" in arrays:
        return None
    if path in arrays:
        return arrays[path]
    spec = str(arrays[path + "@type"])
    prefix = path + "/"
    children = []
    for key in arrays:
        if key.startswith(prefix):
            child = key[len(prefix):].split("/")[0].split("@")[0]
            if child not in children:
                children.append(child)
    if spec in ("list", "tuple"):
        items = [unflatten(arrays, prefix + str(i)) for i in range(len(children))]
        return items if spec == "list" else tuple(items)
    if spec == "dict":
        return {child: unflatten(arrays, prefix + child) for child in children}
    cls = _class(spec)
    return cls(**{name: unflatten(arrays, prefix + name) for name in cls._fields})


def save(path: str, results: Mapping[str, Any]) -> None:
    arrays = {}
    for name, tree in results.items():
        arrays.update(flatten(tree, name))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **arrays)


@functools.lru_cache(maxsize=None)
def _arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def names(path: str) -> set:
    return {key.split("/")[0].split("@")[0] for key in _arrays(path)}


class Records:
    """The stored JAX results of one test module: ``Records(__file__)[name]``."""

    def __init__(self, test_module: str):
        self.path = record_path(test_module)

    def __getitem__(self, name: str) -> Any:
        return unflatten(_arrays(self.path), name)

    def names(self) -> set:
        return names(self.path)
