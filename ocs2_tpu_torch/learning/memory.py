"""Circular replay memory of preallocated tensors.

Counterpart of ``ocs2_tpu/learning/memory.py`` (the reference's
memory/circular.py).  The buffer is one record (a NamedTuple, a dict or a
tensor) of [capacity, ...] tensors written in place; ``size`` and ``head``
are host integers.  ``push_batch`` writes as the JAX package's scan of
pushes does, so a batch longer than the capacity keeps its last rows.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

Tensor = torch.Tensor


def tree_map(fn, tree, *others):
    """``fn`` over the tensor leaves of a NamedTuple / dict / tensor record
    (and the matching leaves of ``others``), keeping its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(getattr(o, f) for o in others))
                            for f, v in zip(tree._fields, tree)))
    return fn(tree, *others)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


class CircularMemory:
    """Fixed-capacity replay buffer; ``data`` has a leading [capacity]."""

    def __init__(self, data: Any, size: int = 0, head: int = 0):
        self.data = data
        self.size = size
        self.head = head

    @staticmethod
    def create(example: Any, capacity: int, device="cuda") -> "CircularMemory":
        """Zeroed buffers shaped like one sample of ``example``."""
        data = tree_map(
            lambda a: torch.zeros(
                (capacity,) + tuple(torch.as_tensor(a).shape),
                dtype=torch.as_tensor(a).dtype, device=device),
            example)
        return CircularMemory(data)

    @property
    def capacity(self) -> int:
        return tree_leaves(self.data)[0].shape[0]

    @property
    def device(self) -> torch.device:
        return tree_leaves(self.data)[0].device

    def push(self, sample: Any) -> "CircularMemory":
        """Insert one sample at the head (in place; returns self)."""
        return self.push_batch(tree_map(lambda a: torch.as_tensor(a)[None], sample))

    def push_batch(self, samples: Any) -> "CircularMemory":
        """Insert a [B, ...] batch in order (in place; returns self)."""
        cap = self.capacity
        n = tree_leaves(samples)[0].shape[0]
        keep = min(n, cap)  # a batch longer than the buffer keeps its tail
        start = (self.head + n - keep) % cap
        idx = (start + torch.arange(keep, device=self.device)) % cap

        def write(buf, s):
            buf[idx] = torch.as_tensor(s, dtype=buf.dtype, device=buf.device)[n - keep:]

        tree_map(write, self.data, samples)
        self.size = min(self.size + n, cap)
        self.head = (self.head + n) % cap
        return self

    def sample(self, generator: Optional[torch.Generator], batch_size: int,
               indices: Optional[Tensor] = None) -> Any:
        """Uniform draws with replacement over the valid region
        [0, max(size, 1)).  ``indices`` replays given draws instead (a test
        hook: the JAX package's draws cannot be reproduced by a torch
        generator)."""
        if indices is None:
            gen_device = generator.device if generator is not None else "cpu"
            indices = torch.randint(0, max(self.size, 1), (batch_size,),
                                    generator=generator, device=gen_device)
        if not isinstance(indices, torch.Tensor):
            indices = torch.as_tensor(np.array(indices, np.int64))
        indices = indices.to(device=self.device, dtype=torch.int64)
        return tree_map(lambda buf: buf[indices], self.data)
