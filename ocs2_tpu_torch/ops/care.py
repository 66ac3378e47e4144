"""Continuous-time algebraic Riccati equation / infinite-horizon LQR.

Counterpart of ``ocs2_tpu/ops/care.py``: the matrix sign-function iteration
on the Hamiltonian

    H = [[A, -B R^-1 B'], [-Q, -A']]
    Z_{k+1} = (c Z_k + (c Z_k)^{-1}) / 2,  c = |det Z_k|^{-1/(2n)}

whose limit sign(H) gives the stable invariant subspace; P solves
[W12; W22 + I] P = -[W11 + I; W21] in the least-squares sense.  Solves
A'P + PA - P B R^-1 B' P + Q = 0; K = R^-1 B' P.  Torch ops with a fixed
iteration count; any leading batch dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class CareSolution(NamedTuple):
    P: Tensor  # [..., nx, nx] value-function Hessian
    K: Tensor  # [..., nu, nx] LQR gain, u = -K x
    residual: Tensor  # [...] CARE residual inf-norm


def solve_care(A: Tensor, B: Tensor, Q: Tensor, R: Tensor, iterations: int = 40) -> CareSolution:
    nx = A.shape[-1]
    tr = lambda m: m.transpose(-1, -2)  # noqa: E731
    Rinv = torch.linalg.inv(R)
    G = B @ Rinv @ tr(B)
    H = torch.cat([torch.cat([A, -G], dim=-1), torch.cat([-Q, -tr(A)], dim=-1)], dim=-2)

    W = H
    for _ in range(iterations):
        # Determinant scaling accelerates the sign iteration.
        _, logdet = torch.linalg.slogdet(W)
        c = torch.exp(-logdet / (2.0 * nx))[..., None, None]
        Zs = c * W
        W = 0.5 * (Zs + torch.linalg.inv(Zs))
    W11, W12 = W[..., :nx, :nx], W[..., :nx, nx:]
    W21, W22 = W[..., nx:, :nx], W[..., nx:, nx:]
    eye = torch.eye(nx, dtype=A.dtype, device=A.device)
    lhs = torch.cat([W12, W22 + eye], dim=-2)
    rhs = -torch.cat([W11 + eye, W21], dim=-2)
    # The reference's least squares is SVD-based; torch's one driver on the
    # card is QR ("gels"), taken here on either device.  It gives the same P
    # wherever the tall system [2nx, nx] has full column rank, as it has for
    # a stabilizable, detectable (A, B, Q) (the stable subspace is a graph
    # over its first block).
    P = torch.linalg.lstsq(lhs, rhs, driver="gels").solution
    P = 0.5 * (P + tr(P))
    K = Rinv @ tr(B) @ P
    res = tr(A) @ P + P @ A - P @ G @ P + Q
    return CareSolution(P=P, K=K, residual=torch.amax(torch.abs(res), dim=(-2, -1)))


def solve_lqr(A: Tensor, B: Tensor, Q: Tensor, R: Tensor) -> CareSolution:
    """Infinite-horizon continuous-time LQR."""
    return solve_care(A, B, Q, R)
