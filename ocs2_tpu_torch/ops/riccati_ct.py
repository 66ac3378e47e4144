"""Continuous-time Riccati ODE backward pass — the SLQ backward sweep.

Counterpart of ``ocs2_tpu/ops/riccati_ct.py``.  The value-function
coefficients (S, s) solve the Riccati ODE

    -dS/dt = Q + A'S + SA - (P + B'S)' R^{-1} (P + B'S)
    -ds/dt = q + A's - (P + B'S)' R^{-1} (r + B's)

with A(t), B(t) the continuous-time dynamics linearization and (Q, q, R, r,
P) the running-cost rate quadratization along the nominal trajectory, the
coefficients interpolated linearly in time between the nodes.  Each interval
is integrated with ``substeps`` fixed RK4 steps; a jump interval applies the
discrete map  S- = Aj' S+ Aj + Qjump,  s- = Aj' s+ + qjump  instead, blended
by the jump mask as the reference blends it (both branches are computed, so a
NaN in either reaches the result).  Gains and feedforward come from the
continuous-time optimality condition at node k.

Every leaf carries a leading scenario dim [B]; ``times`` and ``is_jump`` are
shared by the scenarios.  The Cholesky solves keep STRICT pivots, as the
reference's un-customized ``vmap`` does: an ``R + reg I`` that is not positive
definite gives NaN, at B = 1 and for a batch alike.

``slq_backward`` dispatches: a CUDA tensor goes to the hand-written kernel
(``ops/riccati_ct_cuda.py``, ``csrc/riccati_ct_backward.cu``), a CPU tensor to
the plain version ``_slq_backward_plain`` (batched torch ops, a Python loop
over the intervals), which is also what ``force_plain`` selects on the card.
The result is the discrete sweep's ``LqrSolution`` with per-scenario dv1, dv2.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .riccati import LqrSolution

Tensor = torch.Tensor


class CtLqCoeffs(NamedTuple):
    """Node-sampled continuous-time LQ data of a batch of scenarios.

    Node arrays have N+1 rows (value at grid node k); within interval
    [t_k, t_{k+1}] coefficients are interpolated linearly.  Jump arrays have
    N rows (per interval; used only where is_jump = 1)."""

    A: Tensor       # [B, N+1, nx, nx]  continuous dfdx
    B: Tensor       # [B, N+1, nx, nu]  continuous dfdu
    Q: Tensor       # [B, N+1, nx, nx]  cost-rate Hessian d2l/dx2
    q: Tensor       # [B, N+1, nx]      cost-rate gradient dl/dx
    R: Tensor       # [B, N+1, nu, nu]
    r: Tensor       # [B, N+1, nu]
    P: Tensor       # [B, N+1, nu, nx]  cross term d2l/dudx
    A_jump: Tensor  # [B, N, nx, nx]    jump-map linearization
    Q_jump: Tensor  # [B, N, nx, nx]    pre-jump cost Hessian
    q_jump: Tensor  # [B, N, nx]        pre-jump cost gradient
    Qf: Tensor      # [B, nx, nx]       terminal quadratic
    qf: Tensor      # [B, nx]
    times: Tensor   # [N+1]             shared
    is_jump: Tensor  # [N]              shared, 1.0 where the interval is an event


def _sym(m: Tensor) -> Tensor:
    return 0.5 * (m + m.transpose(-1, -2))


def _solve_strict(rr: Tensor, rhs: Tensor) -> Tensor:
    """Solve rr z = rhs per scenario by Cholesky (rr [B, nu, nu], rhs
    [B, nu, m]); NaN for a scenario whose rr is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(rr)
    z = torch.cholesky_solve(rhs, chol)
    bad = (info != 0).reshape(-1, 1, 1)
    return torch.where(bad, torch.full_like(z, float("nan")), z)


def _riccati_rhs(S, s, a, b_mat, q_mat, q_vec, r_mat, r_vec, p_mat, reg_eye):
    """Forward-time dS/dt, ds/dt (both negated Riccati right-hand sides) of a
    batch: S [B, nx, nx], s [B, nx], coefficients [B, ...]."""
    bt = b_mat.transpose(-1, -2)
    g_mat = p_mat + bt @ S                          # [B, nu, nx]
    g_vec = r_vec + (bt @ s.unsqueeze(-1)).squeeze(-1)  # [B, nu]
    nx = S.shape[-1]
    z = _solve_strict(r_mat + reg_eye, torch.cat([g_mat, g_vec.unsqueeze(-1)], dim=-1))
    k_mat, k_vec = z[..., :nx], z[..., nx]
    gt = g_mat.transpose(-1, -2)
    dS = -(q_mat + a.transpose(-1, -2) @ S + S @ a - gt @ k_mat)
    ds = -(q_vec + (a.transpose(-1, -2) @ s.unsqueeze(-1)).squeeze(-1)
           - (gt @ k_vec.unsqueeze(-1)).squeeze(-1))
    return _sym(dS), ds


def _slq_backward_plain(coeffs: CtLqCoeffs, reg, substeps: int = 4) -> LqrSolution:
    """The plain PyTorch version of the CUDA kernel: batched torch ops over
    the scenarios, a Python loop over the intervals and the RK4 steps."""
    batch, n1, nx = coeffs.A.shape[0], coeffs.A.shape[1], coeffs.A.shape[2]
    n = n1 - 1
    nu = coeffs.B.shape[-1]
    dt_, dev = coeffs.A.dtype, coeffs.A.device
    reg = torch.as_tensor(reg, dtype=dt_, device=dev).expand(batch)
    reg_eye = reg[:, None, None] * torch.eye(nu, dtype=dt_, device=dev)
    times = coeffs.times.to(dt_)
    dts = times[1:] - times[:-1]
    fields = ("A", "B", "Q", "q", "R", "r", "P")

    s_mat, s_vec = coeffs.Qf, coeffs.qf
    ks, kffs, s_mats, s_vecs = [], [], [], []
    dv1 = torch.zeros((batch,), dtype=dt_, device=dev)
    dv2 = torch.zeros_like(dv1)
    for k in reversed(range(n)):
        c0 = [getattr(coeffs, f)[:, k] for f in fields]
        c1 = [getattr(coeffs, f)[:, k + 1] for f in fields]
        dt, m = dts[k], coeffs.is_jump[k].to(dt_)
        h = -dt / substeps  # negative step: integrate t_{k+1} -> t_k
        dt_safe = torch.clamp(dt, min=1e-12)

        def coeff_at(theta):
            """theta in [0, 1] measured from node k."""
            return [a0 + theta * (a1 - a0) for a0, a1 in zip(c0, c1)]

        S, s = s_mat, s_vec
        for i in range(substeps):
            th0 = 1.0 - torch.tensor(i, dtype=dt_, device=dev) / substeps
            thh = th0 + 0.5 * h / dt_safe
            th1 = th0 + h / dt_safe
            at_h = coeff_at(thh)
            k1 = _riccati_rhs(S, s, *coeff_at(th0), reg_eye)
            k2 = _riccati_rhs(S + 0.5 * h * k1[0], s + 0.5 * h * k1[1], *at_h, reg_eye)
            k3 = _riccati_rhs(S + 0.5 * h * k2[0], s + 0.5 * h * k2[1], *at_h, reg_eye)
            k4 = _riccati_rhs(S + h * k3[0], s + h * k3[1], *coeff_at(th1), reg_eye)
            S = _sym(S + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0]))
            s = s + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])

        # Jump branch: transversality update.
        aj = coeffs.A_jump[:, k]
        ajt = aj.transpose(-1, -2)
        s_jmp = _sym(ajt @ s_mat @ aj + coeffs.Q_jump[:, k])
        v_jmp = (ajt @ s_vec.unsqueeze(-1)).squeeze(-1) + coeffs.q_jump[:, k]
        s_mat = (1.0 - m) * S + m * s_jmp
        s_vec = (1.0 - m) * s + m * v_jmp

        # Node-k gains (continuous-time optimality condition).
        a0, b0, _, _, r0, rv0, p0 = c0
        rr = r0 + reg_eye
        bt = b0.transpose(-1, -2)
        g_mat = p0 + bt @ s_mat
        g_vec = rv0 + (bt @ s_vec.unsqueeze(-1)).squeeze(-1)
        z = -_solve_strict(rr, torch.cat([g_mat, g_vec.unsqueeze(-1)], dim=-1))
        kk, kf = z[..., :nx], z[..., nx]
        dv1 = dv1 + dt * (1.0 - m) * torch.sum(kf * g_vec, dim=-1)
        dv2 = dv2 + 0.5 * dt * (1.0 - m) * torch.sum(
            kf * (rr @ kf.unsqueeze(-1)).squeeze(-1), dim=-1)
        ks.append(kk)
        kffs.append(kf)
        s_mats.append(s_mat)
        s_vecs.append(s_vec)

    return LqrSolution(
        gains=torch.stack(ks[::-1], dim=1),
        kff=torch.stack(kffs[::-1], dim=1),
        value_S=torch.cat([torch.stack(s_mats[::-1], dim=1), coeffs.Qf[:, None]], dim=1),
        value_s=torch.cat([torch.stack(s_vecs[::-1], dim=1), coeffs.qf[:, None]], dim=1),
        dv1=dv1,
        dv2=dv2,
    )


def slq_backward(
    coeffs: CtLqCoeffs, reg=0.0, substeps: int = 4, force_plain: bool = False
) -> LqrSolution:
    """Integrate the Riccati ODE backward over the horizon of every scenario.

    Leaves [B, ...] (``times``, ``is_jump`` shared), reg [B] or a scalar.
    Tensors on the card go to the CUDA kernel, which launches or raises;
    tensors on the CPU, and ``force_plain`` on either device, take the plain
    version."""
    if coeffs.A.is_cuda and not force_plain:
        from .riccati_ct_cuda import slq_backward_cuda

        return slq_backward_cuda(coeffs, reg, substeps)
    return _slq_backward_plain(coeffs, reg, substeps)
