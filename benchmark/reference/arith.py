"""Matrix products of the references, in float32 or, for the control, TF32.

Every matrix product of a reference goes through ``Arith.mm``.  With
``tf32=False`` it is a float32 product.  With ``tf32=True`` each operand is
first rounded to TF32 (8-bit exponent, 10-bit mantissa, round to nearest)
and the product is accumulated in float32, which is what a TF32 tensor core
does.  The rounding is done by the reference itself, so the control computes
the same numbers on the CPU and on the card.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

def to_tf32(a: Tensor) -> Tensor:
    """Round float32 ``a`` to the nearest TF32 value (11 significant bits);
    infinities and NaNs are left as they are.  The rounding is taken as the
    identity by automatic differentiation, so derivatives of a function
    computed in TF32 are computed in TF32 too."""
    v = a.detach()
    mant, expo = torch.frexp(v)
    rounded = torch.ldexp(torch.round(mant * 2048.0) / 2048.0, expo)
    return torch.where(torch.isfinite(v), a + (rounded - v), a)


class Arith:
    """The precision of a reference's matrix products."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b

    def mv(self, m: Tensor, v: Tensor) -> Tensor:
        """m [..., i, j] times v [..., j]."""
        return self.mm(m, v.unsqueeze(-1)).squeeze(-1)

    def quad(self, m: Tensor, d: Tensor) -> Tensor:
        """d' m d over the last axis of d [..., n], m [n, n]."""
        return torch.sum(d * self.mm(d, m.transpose(-1, -2)), dim=-1)


def sym(m: Tensor) -> Tensor:
    return 0.5 * (m + m.transpose(-1, -2))


def cholesky_solve(m: Tensor, rhs: Tensor) -> Tensor:
    """Solve m z = rhs for symmetric positive-definite m [..., n, n] and rhs
    [..., n, k]; NaN for a matrix that is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(m)
    z = torch.cholesky_solve(rhs, chol)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(z, float("nan")), z)


def rk_step(f, method: str, x: Tensor, u: Tensor, dt: Tensor, substeps: int = 1) -> Tensor:
    """``substeps`` explicit steps of ``method`` ("rk2": the midpoint rule,
    "rk4": the classical one) of x' = f(x, u) over dt, u held."""
    h = dt / substeps
    for _ in range(substeps):
        k1 = f(x, u)
        if method == "rk2":
            x = x + h * f(x + 0.5 * h * k1, u)
            continue
        if method != "rk4":
            raise ValueError(f"unknown integrator {method!r}")
        k2 = f(x + 0.5 * h * k1, u)
        k3 = f(x + 0.5 * h * k2, u)
        k4 = f(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def uniform_times(t0: float, tf: float, n: int, device) -> Tensor:
    """n + 1 node times from t0 to tf, as float32."""
    import numpy as np

    return torch.as_tensor(np.linspace(t0, tf, n + 1).astype(np.float32), device=device)
