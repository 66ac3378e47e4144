"""Device meshes and scenario batches split over them.

Counterpart of ``ocs2_tpu/parallel/mesh.py``.  There a mesh is a
``jax.sharding.Mesh`` and a sharded solve is one program that XLA partitions;
here a mesh is a small record, a tuple of ``torch.device``s with one axis
name, and ``sharded`` runs each device's chunk of the batch on that device
and gathers the results.

A device may appear in a mesh more than once: each entry is one shard, and
consecutive equal entries are shards that live on the same device.  That is
how one card, or the CPU in the tests, holds several shards, where the JAX
package's tests split the CPU into eight devices
(``xla_force_host_platform_device_count=8``).  ``"cpu"`` and ``"cpu:0"``
name the same memory but are different entries, which lets a CPU mesh
exercise the exchanges between devices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices[i]`` holds shard i of the axis
    ``axis_names[0]``; ``mesh.shape[axis]`` is the number of shards."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("scenario",)

    def __post_init__(self):
        names = (self.axis_names,) if isinstance(self.axis_names, str) else tuple(self.axis_names)
        if len(names) != 1:
            raise ValueError(f"a mesh has one axis, got {names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)


def device_groups(mesh: Mesh) -> List[Tuple[torch.device, int, int]]:
    """The runs of equal consecutive devices: (device, first shard, shards)."""
    groups: List[Tuple[torch.device, int, int]] = []
    for i, dev in enumerate(mesh.devices):
        if groups and groups[-1][0] == dev:
            groups[-1] = (dev, groups[-1][1], groups[-1][2] + 1)
        else:
            groups.append((dev, i, 1))
    return groups


def make_mesh(devices: Optional[Sequence[Any]] = None, axis_name: str = "scenario") -> Mesh:
    """A 1-D mesh over the given devices, by default every CUDA device."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("no CUDA device; pass devices= (e.g. ['cpu'] * 8)")
    return Mesh(tuple(devices), (axis_name,))


def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` on every tensor of a tree of NamedTuples, tuples, lists and
    dicts; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def _tree_stack(trees: Sequence[Any], fn: Callable) -> Any:
    """Combine the tensors at the same place of several trees of one
    structure with ``fn(list of tensors)``."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(list(trees))
    if hasattr(first, "_fields"):
        return type(first)(*(_tree_stack(parts, fn) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack(parts, fn) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: _tree_stack([t[k] for t in trees], fn) for k in first}
    return first


def batched(solve_fn: Callable) -> Callable:
    """``solve_fn`` itself: the port's solvers already take a leading batch
    dim on every argument (the JAX package ``vmap``s a single-scenario
    solve here)."""
    return solve_fn


def sharded(solve_fn: Callable, mesh: Mesh, axis_name: str = "scenario") -> Callable:
    """A batched solve with the batch split over the mesh.

    ``run(*args)`` splits the leading dim of every tensor of the arguments
    into ``len(mesh)`` equal chunks (the batch must divide evenly, as in the
    JAX package), calls ``solve_fn`` on chunk i moved to ``mesh.devices[i]``
    (one chunk after another) and returns the results' tensors concatenated
    on the mesh's first device.  ``solve_fn`` takes and returns tensors with
    a leading batch dim; arguments shared by every scenario are closed over.
    """
    shards = mesh.shape[axis_name]

    def run(*batched_args):
        sizes = []
        _tree_map(lambda a: sizes.append(a.shape[0]), batched_args)
        if not sizes or len(set(sizes)) != 1 or sizes[0] % shards:
            raise ValueError(f"leading dims {sorted(set(sizes))} must be equal and divide "
                             f"by the mesh's {shards} shards")
        chunk = sizes[0] // shards
        outs = []
        for i, dev in enumerate(mesh.devices):
            part = _tree_map(lambda a: a[i * chunk:(i + 1) * chunk].to(dev), batched_args)
            outs.append(solve_fn(*part))
        home = mesh.devices[0]
        return _tree_stack(outs, lambda parts: torch.cat([p.to(home) for p in parts], dim=0))

    return run


def scenario_rollout_stats(batched_perf) -> dict:
    """Summary of a batched PerformanceIndex (on the host)."""
    cost = batched_perf.cost.detach().cpu().numpy()
    return {
        "num": int(cost.shape[0]),
        "cost_mean": float(cost.mean()),
        "cost_p99": float(np.percentile(cost, 99)),
    }
