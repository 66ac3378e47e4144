"""MPC-Net losses.

Counterpart of ``ocs2_tpu/learning/loss.py`` (the reference's
loss/hamiltonian.py, behavioral_cloning.py, cross_entropy.py).  The
Hamiltonian loss consumes the per-node quadratic expansion of the control
Hamiltonian that the solver computes anyway: the discrete-time Q-function
assembled from the LQ data and the Riccati value function.  Every function
is batched over any leading dims.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class HamiltonianApprox(NamedTuple):
    """Quadratic expansion of the node Hamiltonian (Q-function) in
    du = u - u*:  H(u) = h0 + hu'du + 1/2 du'Huu du, over leading dims."""

    h0: Tensor  # [...]
    hu: Tensor  # [..., nu]
    Huu: Tensor  # [..., nu, nu]

    def value(self, du: Tensor) -> Tensor:
        return (
            self.h0
            + torch.einsum("...u,...u->...", self.hu, du)
            + 0.5 * torch.einsum("...u,...uv,...v->...", du, self.Huu, du)
        )


def hamiltonian_loss(hammy: HamiltonianApprox, u_pred: Tensor, u_star: Tensor) -> Tensor:
    """Mean Hamiltonian of the predicted inputs: the policy minimizes the
    MPC's Q-function rather than cloning u*."""
    return torch.mean(hammy.value(u_pred - u_star))


def behavioral_cloning_loss(u_pred: Tensor, u_star: Tensor, R: Tensor) -> Tensor:
    """Weighted L2 imitation."""
    du = u_pred - u_star
    return torch.mean(torch.einsum("...u,uv,...v->...", du, R, du))


def cross_entropy_loss(gates: Tensor, mode_probs: Tensor, eps: float = 1e-8) -> Tensor:
    """Gating cross entropy against a target mode distribution."""
    return -torch.mean(torch.sum(mode_probs * torch.log(gates + eps), dim=-1))


def hamiltonian_from_lq(lq, value_S: Tensor, value_s: Tensor, xs: Tensor) -> HamiltonianApprox:
    """Per-node Hamiltonian expansions from the horizon LQ data and the
    value function of the Riccati pass, over any leading dims ([B] for the
    port's solves): lq leaves [..., N, ...], value_S [..., N+1, nx, nx],
    value_s [..., N+1, nx], xs [..., N+1, nx]; the result is [..., N, ...].

    Discrete Q-function at node k:  Q(dx, du) = l_k + V_{k+1}(A dx + B du + b).
    value_S / value_s live in DELTA coordinates around the solution, so the
    affine term is the multiple-shooting defect b = F(x_k, u_k) - x_{k+1},
    not the predicted next state lq.dynamics.f itself."""
    b_mat = lq.dynamics.dfdu
    b = lq.dynamics.f - xs[..., 1:, :]
    s_next = value_S[..., 1:, :, :]
    sv_b = value_s[..., 1:, :] + (s_next @ b[..., None])[..., 0]
    b_t = b_mat.transpose(-1, -2)
    hu = lq.cost.dfdu[..., :-1, :] + (b_t @ sv_b[..., None])[..., 0]
    huu = lq.cost.dfduu[..., :-1, :, :] + b_t @ s_next @ b_mat
    return HamiltonianApprox(h0=lq.cost.f[..., :-1], hu=hu, Huu=huu)
