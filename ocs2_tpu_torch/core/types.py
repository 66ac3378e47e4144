"""Core value types: Taylor-approximation containers and performance indices.

Counterpart of ``ocs2_tpu/core/types.py``.  All containers are
``NamedTuple``s of tensors that may carry leading batch/time axes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


def _add_optional(a, b):
    return None if a is None else a + b


class ScalarQuadraticApproximation(NamedTuple):
    """Second-order Taylor expansion of a scalar function (cost term).

    f(x+dx, u+du) ~= f + dfdx.dx + dfdu.du + 1/2 dx'dfdxx dx + du'dfdux dx
                     + 1/2 du'dfduu du
    """

    f: Tensor  # [] or [N]
    dfdx: Tensor  # [nx] or [N, nx]
    dfdu: Optional[Tensor]  # [nu]
    dfdxx: Tensor  # [nx, nx]
    dfdux: Optional[Tensor]  # [nu, nx]
    dfduu: Optional[Tensor]  # [nu, nu]

    def __add__(self, other: "ScalarQuadraticApproximation"):
        return ScalarQuadraticApproximation(
            *(_add_optional(a, b) for a, b in zip(self, other))
        )

    @staticmethod
    def zeros(nx: int, nu: Optional[int] = None, dtype=torch.float32,
              device="cuda"):
        has_u = nu is not None
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        return ScalarQuadraticApproximation(
            f=z(),
            dfdx=z(nx),
            dfdu=z(nu) if has_u else None,
            dfdxx=z(nx, nx),
            dfdux=z(nu, nx) if has_u else None,
            dfduu=z(nu, nu) if has_u else None,
        )


class VectorLinearApproximation(NamedTuple):
    """First-order Taylor expansion of a vector function (dynamics/constraint)."""

    f: Tensor  # [m] or [N, m]
    dfdx: Tensor  # [m, nx]
    dfdu: Optional[Tensor]  # [m, nu]

    @staticmethod
    def zeros(m: int, nx: int, nu: Optional[int] = None, dtype=torch.float32,
              device="cuda"):
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)  # noqa: E731
        return VectorLinearApproximation(
            f=z(m), dfdx=z(m, nx), dfdu=z(m, nu) if nu is not None else None
        )


class PerformanceIndex(NamedTuple):
    """Per-iteration solution quality record: merit = cost + constraint
    penalties + Lagrangian terms.  A batched solve gives every field a
    leading [B]."""

    merit: Tensor
    cost: Tensor
    dynamics_violation_sse: Tensor
    equality_constraints_sse: Tensor
    inequality_constraints_sse: Tensor
    equality_lagrangian: Tensor
    inequality_lagrangian: Tensor

    @staticmethod
    def zeros(dtype=torch.float32, device="cuda"):
        z = torch.zeros((), dtype=dtype, device=device)
        return PerformanceIndex(z, z, z, z, z, z, z)

    def __add__(self, other: "PerformanceIndex"):
        return PerformanceIndex(*(a + b for a, b in zip(self, other)))


def make_psd(mat: Tensor, min_eigenvalue: float = 0.0) -> Tensor:
    """Shift the symmetric part of ``mat`` [..., n, n] to have eigenvalues
    >= min_eigenvalue (symmetric eigendecomposition, clamped eigenvalues)."""
    sym = 0.5 * (mat + mat.transpose(-1, -2))
    w, v = torch.linalg.eigh(sym)
    w = torch.clamp(w, min=min_eigenvalue)
    return (v * w.unsqueeze(-2)) @ v.transpose(-1, -2)


def symmetrize(mat: Tensor) -> Tensor:
    return 0.5 * (mat + mat.transpose(-1, -2))
