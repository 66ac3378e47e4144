"""QR-based null-space projection of state-input equality constraints.

Counterpart of ``ocs2_tpu/ops/projection.py``.  Given g + C dx + D du = 0
with D [ne, nu] of full row rank (ne < nu), every feasible input increment is

    du = p0 + Px dx + Pu v,      v in R^{nu - ne}

with p0 = -D^+ g, Px = -D^+ C, Pu = a null-space basis of D.  Substituting
into the node's quadratic cost yields a reduced, unconstrained LQ stage: the
Riccati sweep then solves the equality-constrained QP exactly.  Every
function takes any leading dims (a solver passes ``[B, N]``).  The QR of all
nodes at once is ``householder_qr``, a dozen reflections written as batched
tensor ops: ``torch.linalg.qr(mode="complete")`` on CUDA forms Q matrix by
matrix, which at 25,600 nodes of 24 x 12 took 1.4 s against 3.5 ms (NVIDIA
H100 80GB HBM3 at 700 W, ``chip_smoke.py --profile``).

``Pu`` is not unique (column signs, any rotation of the null space): what is
determined is p0, Px, Pu Pu' and everything remapped to the full input.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import symmetrize
from .riccati import LqrCoeffs

Tensor = torch.Tensor


class Projection(NamedTuple):
    p0: Tensor  # [..., nu]        feasibility offset
    Px: Tensor  # [..., nu, nx]    state-feedback part
    Pu: Tensor  # [..., nu, nv]    null-space basis (orthonormal columns)


def _t(m: Tensor) -> Tensor:
    return m.transpose(-1, -2)


def _mv(m: Tensor, v: Tensor) -> Tensor:
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def householder_qr(a: Tensor):
    """Complete QR of a [..., m, n] (m >= n) by n Householder reflections
    written as batched tensor ops: Q [..., m, m] orthogonal, R [..., m, n]
    upper triangular.  LAPACK's conventions (``geqr2`` + ``org2r``, which
    ``torch.linalg.qr(mode="complete")`` and the reference's QR call): each
    reflector is H = I - tau v v' with v[0] = 1, a column that is already
    zero below the diagonal gets tau = 0 (H = I), and Q is accumulated from
    the last reflector to the first.  So a coordinate that no column touches
    keeps an exact unit vector in Q, as in LAPACK: the null-space basis does
    not mix an unconstrained input with the others by rounding, which keeps
    the reduced Hessian of a node whose cost is a rank-deficient sum (a jump
    node under IPM's condensation) as well conditioned as the reference's."""
    m, n = a.shape[-2:]
    r = a.clone()
    vs, taus = [], []
    for j in range(n):
        x = r[..., j:, j]
        alpha = x[..., 0]
        xnorm = torch.linalg.vector_norm(x[..., 1:], dim=-1)
        beta = -torch.copysign(torch.sqrt(alpha * alpha + xnorm * xnorm), alpha)
        untouched = xnorm == 0.0
        one = torch.ones_like(alpha)
        tau = torch.where(untouched, torch.zeros_like(alpha), (beta - alpha) / beta)
        scale = torch.where(untouched, torch.zeros_like(alpha), one / (alpha - beta))
        v = torch.cat([one.unsqueeze(-1), x[..., 1:] * scale.unsqueeze(-1)], dim=-1)
        w = (v.unsqueeze(-2) @ r[..., j:, j + 1:]).squeeze(-2)
        r[..., j:, j + 1:] -= (tau.unsqueeze(-1) * v).unsqueeze(-1) * w.unsqueeze(-2)
        r[..., j, j] = torch.where(untouched, alpha, beta)
        r[..., j + 1:, j] = 0.0
        vs.append(v)
        taus.append(tau)
    q = torch.eye(m, dtype=a.dtype, device=a.device).expand(a.shape[:-2] + (m, m)).clone()
    for j in reversed(range(n)):
        v, tau = vs[j], taus[j]
        w = (v.unsqueeze(-2) @ q[..., j:, j:]).squeeze(-2)
        q[..., j:, j:] -= (tau.unsqueeze(-1) * v).unsqueeze(-1) * w.unsqueeze(-2)
    return q, r


def constraint_projection(g: Tensor, C: Tensor, D: Tensor) -> Projection:
    """Projection of every node via the complete QR of D'.

    g [..., ne], C [..., ne, nx], D [..., ne, nu].
    D' = Q [R; 0];  D^+ = Q1 R^{-T};  null(D) = Q2.
    """
    ne = D.shape[-2]
    q_full, r_full = householder_qr(_t(D))  # [nu, nu], [nu, ne]
    q1 = q_full[..., :, :ne]
    q2 = q_full[..., :, ne:]
    r = r_full[..., :ne, :]
    # D^+ Z = Q1 R^{-T} Z  (solve R' W = Z), for g and all columns of C at once.
    rhs = torch.cat([g.unsqueeze(-1), C], dim=-1)
    w = torch.linalg.solve_triangular(_t(r), rhs, upper=False)
    dpinv = -(q1 @ w)
    return Projection(p0=dpinv[..., 0], Px=dpinv[..., 1:], Pu=q2)


def project_lqr_coeffs(coeffs: LqrCoeffs, g: Tensor, C: Tensor, D: Tensor):
    """Reduce stage coefficients onto the constraint null space.

    coeffs leaves [..., N, ...], g [..., N, ne], C [..., N, ne, nx],
    D [..., N, ne, nu].  Returns the coefficients in the reduced input v
    (dim nu - ne) and the projection for remapping."""
    proj = constraint_projection(g, C, D)
    p0, px, pu = proj
    quu_px = coeffs.Quu @ px
    qu_full = coeffs.qu + _mv(coeffs.Quu, p0)
    reduced = LqrCoeffs(
        A=coeffs.A + coeffs.B @ px,
        B=coeffs.B @ pu,
        b=coeffs.b + _mv(coeffs.B, p0),
        Qxx=symmetrize(
            coeffs.Qxx + _t(px) @ coeffs.Qux + _t(coeffs.Qux) @ px + _t(px) @ quu_px
        ),
        qx=coeffs.qx + _mv(_t(px), qu_full) + _mv(_t(coeffs.Qux), p0),
        Quu=_t(pu) @ coeffs.Quu @ pu,
        qu=_mv(_t(pu), qu_full),
        Qux=_t(pu) @ (coeffs.Qux + quu_px),
        Qf=coeffs.Qf,
        qf=coeffs.qf,
    )
    return reduced, proj


def remap_projected_input(proj: Projection, dxs: Tensor, dvs: Tensor) -> Tensor:
    """du_k = p0 + Px dx_k + Pu dv_k;  dxs [..., N, nx], dvs [..., N, nv]."""
    return proj.p0 + _mv(proj.Px, dxs) + _mv(proj.Pu, dvs)


def remap_projected_gain(proj: Projection, gains_v: Tensor) -> Tensor:
    """K_u = Px + Pu K_v;  gains_v [..., N, nv, nx]."""
    return proj.Px + proj.Pu @ gains_v
