"""Policy representations.

Counterpart of ``ocs2_tpu/core/controllers.py``.  Controllers are records of
dense time-stamped tensors evaluated by interpolation (``core/interpolation``).
Evaluation is batch-polymorphic in ``x``: a query ``t`` of shape ``[...]``
with ``x [..., nx]`` gives ``u [..., nu]`` (a 0-dim ``t`` with ``x [B, nx]``
evaluates every state at the same time).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .interpolation import interpolate

Tensor = torch.Tensor


class LinearController(NamedTuple):
    """u(t, x) = uff(t) + K(t) (x - x_nom(t)).

    times: [N]; uff: [N, nu]; gains: [N, nu, nx]; x_nom: [N, nx].
    x_nom is kept explicit (rather than a bias uff - K x_nom) because it also
    serves MRT evaluation and trajectory spreading.
    """

    times: Tensor
    uff: Tensor
    gains: Tensor
    x_nom: Tensor

    def __call__(self, t, x: Tensor) -> Tensor:
        uff = interpolate(self.times, self.uff, t)
        k = interpolate(self.times, self.gains, t)
        xn = interpolate(self.times, self.x_nom, t)
        return uff + (k @ (x - xn).unsqueeze(-1)).squeeze(-1)


class FeedforwardController(NamedTuple):
    """u(t) ignoring the state."""

    times: Tensor
    uff: Tensor

    def __call__(self, t, x: Tensor) -> Tensor:
        del x
        return interpolate(self.times, self.uff, t)


def zero_controller(times: Tensor, nu: int, nx: int) -> LinearController:
    n = times.shape[0]
    z = lambda *s: torch.zeros(s, dtype=times.dtype, device=times.device)  # noqa: E731
    return LinearController(times=times, uff=z(n, nu), gains=z(n, nu, nx), x_nom=z(n, nx))
