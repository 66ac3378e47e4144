"""Linear interpolation over time-stamped trajectories.

Counterpart of ``ocs2_tpu/core/interpolation.py``: ``torch.searchsorted`` +
gather, free of data-dependent control flow, so it works for a scalar query,
for a tensor of queries and under ``torch.func.vmap``.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _as_query(times: Tensor, t) -> Tensor:
    if isinstance(t, torch.Tensor):
        return t.to(times.dtype)
    return torch.as_tensor(t, dtype=times.dtype, device=times.device)


def lookup_index(times: Tensor, t) -> Tensor:
    """Index i such that times[i] <= t < times[i+1], clamped to [0, len-2],
    so queries outside the trajectory use the boundary segment."""
    t = _as_query(times, t)
    idx = torch.searchsorted(times, t, right=True) - 1
    return idx.clamp(0, max(times.shape[0] - 2, 0))


def _rows(values: Tensor, i: Tensor) -> Tensor:
    """values[i] for an index tensor i of any shape [...] -> [..., rest].
    ``index_select`` maps under ``torch.func.vmap`` also inside ``jacrev``,
    where indexing with a 0-dim index tensor made in the function does not."""
    return values.index_select(0, i.reshape(-1)).reshape(i.shape + values.shape[1:])


def interpolate(times: Tensor, values: Tensor, t) -> Tensor:
    """Linearly interpolate values [M, ...] stamped at times [M] at query t
    (any shape [...]); returns [..., *values.shape[1:]].  Clamps to the
    first/last sample (alpha clipped to [0, 1])."""
    if times.shape[0] == 1:
        return values[0]
    t = _as_query(times, t)
    i = lookup_index(times, t)
    t0 = _rows(times, i)
    t1 = _rows(times, i + 1)
    alpha = ((t - t0) / torch.clamp(t1 - t0, min=1e-12)).clamp(0.0, 1.0)
    alpha = alpha.reshape(alpha.shape + (1,) * (values.ndim - 1))
    v0 = _rows(values, i)
    v1 = _rows(values, i + 1)
    return v0 + alpha * (v1 - v0)


def interpolate_batch(times: Tensor, values: Tensor, ts: Tensor) -> Tensor:
    """Interpolation at many query times ts [M] -> [M, *values.shape[1:]],
    also when the trajectory has a single sample (then every query gets it)."""
    out = interpolate(times, values, ts)
    return out.expand(ts.shape + values.shape[1:]) if times.shape[0] == 1 else out
