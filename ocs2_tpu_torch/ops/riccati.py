"""Time-varying LQR via the discrete Riccati recursion.

Counterpart of ``ocs2_tpu/ops/riccati.py`` (sequential paths, the forward
pass and the Hessian correction ``convexify``; the associative-scan
``lqr_backward_parallel`` is not ported yet).

Problem (increments around the nominal trajectory):
    min  sum_k [ q_k + qx_k'dx + qu_k'du + 1/2 dx'Qxx dx + du'Qux dx
                 + 1/2 du'Quu du ]  +  terminal quadratic
    s.t. dx_{k+1} = A_k dx_k + B_k du_k + b_k
with b_k the dynamics defect (zero for single-shooting DDP).

Three backward passes share one recursion:

* ``_lqr_backward_single`` — one scenario, matrix form, Cholesky from
  ``torch.linalg``; a non-positive-definite ``Quu_hat`` yields NaN from that
  node on (solvers mask non-finite steps on it).
* ``_lqr_backward_batched`` — a batch of scenarios in batch-minor entry form,
  with clamped Cholesky pivots or, ``strict``, with NaN from a pivot that is
  not positive.  This is the plain PyTorch version of the CUDA kernel in
  ``ops/riccati_cuda.py``, under either of its pivot policies.
* ``lqr_backward`` — the solvers' entry point, which takes the place of the
  reference's ``custom_vmap`` rule.  Tensors on the card go through the CUDA
  kernel: strict pivots for a batch of one (as the reference's un-vmapped
  solve fails), clamped pivots for a larger batch.  Tensors on the CPU go
  through the single-scenario sweep (a batch of one) or the plain version.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.types import symmetrize

Tensor = torch.Tensor

# Pivot clamp of the entry-form Cholesky: d = sqrt(max(s, PIVOT_EPS)).  The
# CUDA kernel uses the same constant.
PIVOT_EPS = 1e-12


class LqrSolution(NamedTuple):
    gains: Tensor  # K  [N, nu, nx]   du = kff + K dx
    kff: Tensor  # [N, nu]
    value_S: Tensor  # [N+1, nx, nx]  cost-to-go Hessian
    value_s: Tensor  # [N+1, nx]      cost-to-go gradient
    dv1: Tensor  # [] expected decrease, linear term  sum kff'Qu
    dv2: Tensor  # [] expected decrease, quadratic    sum 1/2 kff'Quu kff


class LqrCoeffs(NamedTuple):
    """Stage data [N, ...] + terminal [nx...]; the batched functions take a
    further leading [B] on every leaf."""

    A: Tensor
    B: Tensor
    b: Tensor
    Qxx: Tensor
    qx: Tensor
    Quu: Tensor
    qu: Tensor
    Qux: Tensor
    Qf: Tensor
    qf: Tensor


def _solve_psd(M: Tensor, rhs: Tensor) -> Tensor:
    """Solve M z = rhs for symmetric positive-definite M via Cholesky; NaN
    where M is not positive definite."""
    chol, info = torch.linalg.cholesky_ex(M)
    vec = rhs.ndim == 1
    z = torch.cholesky_solve(rhs[:, None] if vec else rhs, chol)
    z = torch.where(info != 0, torch.full_like(z, float("nan")), z)
    return z[:, 0] if vec else z


def convexify_stage_hessians(
    Qxx: Tensor, Qux: Tensor, Quu: Tensor, Qf: Tensor,
    min_eig: float = 1e-5, method: str = "gershgorin",
):
    """PSD-project the stage Hessians [[Qxx, Qux'], [Qux, Quu]] [..., N, ...]
    and the terminal Qf [..., nx, nx].  ``method`` "gershgorin" shifts the
    diagonal by the Gershgorin lower bound of the spectrum, "eigh" clamps the
    eigenvalues."""
    nx = Qxx.shape[-1]

    def correct(z):
        z = symmetrize(z)
        if method == "gershgorin":
            diag = torch.diagonal(z, dim1=-2, dim2=-1)
            radius = torch.sum(torch.abs(z), dim=-1) - torch.abs(diag)
            lb = torch.amin(diag - radius, dim=-1)
            shift = torch.clamp(min_eig - lb, min=0.0)
            eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
            return z + shift[..., None, None] * eye
        w, v = torch.linalg.eigh(z)
        return (v * torch.clamp(w, min=min_eig).unsqueeze(-2)) @ v.transpose(-1, -2)

    z = correct(torch.cat([
        torch.cat([Qxx, Qux.transpose(-1, -2)], dim=-1),
        torch.cat([Qux, Quu], dim=-1),
    ], dim=-2))
    return z[..., :nx, :nx], z[..., nx:, :nx], z[..., nx:, nx:], correct(Qf)


def convexify(
    coeffs: LqrCoeffs, min_eig: float = 1e-5, method: str = "gershgorin"
) -> LqrCoeffs:
    """Make every stage's joint Hessian (and the terminal Qf) positive
    semidefinite: exact Hessians of nonconvex terms can be indefinite, which
    breaks the Riccati Cholesky.  Any leading dims."""
    if method not in ("gershgorin", "eigh"):
        raise ValueError(f"unknown Hessian correction {method!r}")
    qxx, qux, quu, qf = convexify_stage_hessians(
        coeffs.Qxx, coeffs.Qux, coeffs.Quu, coeffs.Qf, min_eig, method
    )
    return coeffs._replace(
        Qxx=qxx.contiguous(), Qux=qux.contiguous(), Quu=quu.contiguous(), Qf=qf
    )


def _lqr_backward_single(coeffs: LqrCoeffs, reg) -> LqrSolution:
    """One scenario: coeffs leaves [N, ...], reg scalar."""
    n = coeffs.A.shape[0]
    nu = coeffs.B.shape[-1]
    eye_u = torch.eye(nu, dtype=coeffs.B.dtype, device=coeffs.B.device)

    s_mat, s_vec = coeffs.Qf, coeffs.qf
    ks, kffs, s_mats, s_vecs = [], [], [s_mat], [s_vec]
    dv1 = torch.zeros((), dtype=s_mat.dtype, device=s_mat.device)
    dv2 = torch.zeros_like(dv1)
    for k in reversed(range(n)):
        a, b_mat, b = coeffs.A[k], coeffs.B[k], coeffs.b[k]
        sv = s_vec + s_mat @ b
        qu_hat = coeffs.qu[k] + b_mat.T @ sv
        qx_hat = coeffs.qx[k] + a.T @ sv
        quu_hat = coeffs.Quu[k] + b_mat.T @ s_mat @ b_mat + reg * eye_u
        qux_hat = coeffs.Qux[k] + b_mat.T @ s_mat @ a
        qxx_hat = coeffs.Qxx[k] + a.T @ s_mat @ a
        kk = -_solve_psd(quu_hat, qux_hat)
        kf = -_solve_psd(quu_hat, qu_hat)
        s_mat = symmetrize(
            qxx_hat + kk.T @ quu_hat @ kk + kk.T @ qux_hat + qux_hat.T @ kk
        )
        s_vec = qx_hat + kk.T @ quu_hat @ kf + kk.T @ qu_hat + qux_hat.T @ kf
        dv1 = dv1 + kf @ qu_hat
        dv2 = dv2 + 0.5 * kf @ quu_hat @ kf
        ks.append(kk)
        kffs.append(kf)
        s_mats.append(s_mat)
        s_vecs.append(s_vec)
    return LqrSolution(
        gains=torch.stack(ks[::-1]),
        kff=torch.stack(kffs[::-1]),
        value_S=torch.stack(s_mats[::-1]),
        value_s=torch.stack(s_vecs[::-1]),
        dv1=dv1,
        dv2=dv2,
    )


# -- batch-minor batched backward pass ---------------------------------------
#
# Entry layout: matrices [n, m, B] / vectors [n, B] — the batch dim is minor,
# matrix dims are loop indices, every entry is a [B] vector.  (The CUDA kernel
# reads the standard [B, N, n, m] layout; only its arithmetic is repeated here.)


def _bm_mm(a, b):
    """[i, k, B] @ [k, j, B] -> [i, j, B]."""
    return torch.sum(a[:, :, None, :] * b[None, :, :, :], dim=1)


def _bm_mTm(a, b):
    """[k, i, B]' @ [k, j, B] -> [i, j, B]."""
    return torch.sum(a[:, :, None, :] * b[:, None, :, :], dim=0)


def _bm_mv(a, v):
    """[i, k, B] @ [k, B] -> [i, B]."""
    return torch.sum(a * v[None, :, :], dim=1)


def _bm_mTv(a, v):
    """[k, i, B]' @ [k, B] -> [i, B]."""
    return torch.sum(a * v[:, None, :], dim=0)


def _bm_cholesky(M, eps: float = PIVOT_EPS, strict: bool = False):
    """Entry-form Cholesky of [n, n, B]: L[i][j] are [B] vectors.  Pivots are
    clamped at ``eps``; ``strict`` instead makes a pivot that is not positive
    and finite NaN, which every later entry of that scenario inherits."""
    n = M.shape[0]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        if strict:
            ok = (s > 0) & torch.isfinite(s)
            d = torch.sqrt(torch.where(ok, s, torch.full_like(s, float("nan"))))
        else:
            d = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = M[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _bm_chol_solve(L, rhs):
    """Solve (L L') z = rhs, rhs [n, m, B]."""
    n = rhs.shape[0]
    ys = []
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k] * ys[k]
        ys.append(s / L[i][i])
    zs = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * zs[k]
        zs[i] = s / L[i][i]
    return torch.stack(zs, dim=0)


def _bm_sym(m):
    return 0.5 * (m + m.transpose(0, 1))


def _lqr_backward_batched(coeffs: LqrCoeffs, reg, strict: bool = False) -> LqrSolution:
    """Batch-minor backward pass: coeffs leaves carry a LEADING batch dim
    [B, N, ...]; reg is [B] (or scalar).  Same recursion as
    _lqr_backward_single, evaluated in entry form; a Python loop over time.
    Pivots are clamped, or with ``strict`` a ``Quu_hat`` that is not positive
    definite gives NaN in K, kff, S, s of that node and every earlier one of
    its scenario and in dv1, dv2, where _lqr_backward_single puts it.  Fields
    of the result have a leading [B]."""
    batch, n = coeffs.A.shape[0], coeffs.A.shape[1]
    dt, dev = coeffs.A.dtype, coeffs.A.device
    reg = torch.as_tensor(reg, dtype=dt, device=dev).expand(batch)

    # [B, N, n, m] -> [N, n, m, B] (time-leading, batch-minor).
    A = coeffs.A.permute(1, 2, 3, 0)
    Bm = coeffs.B.permute(1, 2, 3, 0)
    bv = coeffs.b.permute(1, 2, 0)
    Qxx = coeffs.Qxx.permute(1, 2, 3, 0)
    qx = coeffs.qx.permute(1, 2, 0)
    Quu = coeffs.Quu.permute(1, 2, 3, 0)
    qu = coeffs.qu.permute(1, 2, 0)
    Qux = coeffs.Qux.permute(1, 2, 3, 0)
    s_mat = coeffs.Qf.permute(1, 2, 0)  # [nx, nx, B]
    s_vec = coeffs.qf.permute(1, 0)  # [nx, B]
    nu = Bm.shape[2]
    reg_eye = reg * torch.eye(nu, dtype=dt, device=dev)[:, :, None]

    ks, kffs, s_mats, s_vecs = [], [], [], []
    dv1 = torch.zeros((batch,), dtype=dt, device=dev)
    dv2 = torch.zeros_like(dv1)
    for k in reversed(range(n)):
        a, b_mat = A[k], Bm[k]
        sv = s_vec + _bm_mv(s_mat, bv[k])
        qu_hat = qu[k] + _bm_mTv(b_mat, sv)
        qx_hat = qx[k] + _bm_mTv(a, sv)
        sB = _bm_mm(s_mat, b_mat)
        sA = _bm_mm(s_mat, a)
        quu_hat = Quu[k] + _bm_mTm(b_mat, sB) + reg_eye
        qux_hat = Qux[k] + _bm_mTm(b_mat, sA)
        qxx_hat = Qxx[k] + _bm_mTm(a, sA)
        L = _bm_cholesky(quu_hat, strict=strict)
        kk = -_bm_chol_solve(L, qux_hat)  # [nu, nx, B]
        kf = -_bm_chol_solve(L, qu_hat[:, None, :])[:, 0, :]  # [nu, B]
        quuk = _bm_mm(quu_hat, kk)
        s_mat = _bm_sym(
            qxx_hat + _bm_mTm(kk, quuk) + _bm_mTm(kk, qux_hat)
            + _bm_mTm(qux_hat, kk)
        )
        quukf = _bm_mv(quu_hat, kf)
        s_vec = (
            qx_hat + _bm_mTv(kk, quukf) + _bm_mTv(kk, qu_hat)
            + _bm_mTv(qux_hat, kf)
        )
        dv1 = dv1 + torch.sum(kf * qu_hat, dim=0)
        dv2 = dv2 + 0.5 * torch.sum(kf * quukf, dim=0)
        ks.append(kk)
        kffs.append(kf)
        s_mats.append(s_mat)
        s_vecs.append(s_vec)

    # Back to standard [B, N, ...] layout.
    return LqrSolution(
        gains=torch.stack(ks[::-1]).permute(3, 0, 1, 2),
        kff=torch.stack(kffs[::-1]).permute(2, 0, 1),
        value_S=torch.cat(
            [torch.stack(s_mats[::-1]).permute(3, 0, 1, 2), coeffs.Qf[:, None]],
            dim=1,
        ),
        value_s=torch.cat(
            [torch.stack(s_vecs[::-1]).permute(2, 0, 1), coeffs.qf[:, None]],
            dim=1,
        ),
        dv1=dv1,
        dv2=dv2,
    )


def lqr_backward(
    coeffs: LqrCoeffs, reg, force_plain: bool = False, force_single: bool = False
) -> LqrSolution:
    """Riccati backward pass of a batch: coeffs leaves [B, N, ...], reg [B]
    (or scalar); fields of the result have a leading [B].

    Tensors on the card go through the CUDA kernel (``riccati_cuda``), which
    raises on anything it cannot take: with strict pivots for a batch of one
    (NaN from the node whose ``Quu_hat`` is not positive definite, which the
    SQP solver's step masking relies on), with clamped pivots for a larger
    batch.  Tensors on the CPU take the single-scenario sweep for a batch of
    one (the same NaN) and the plain version, clamped, otherwise.

    Two test hooks, for either device, so that a whole solve can be held
    against the kernel's: ``force_plain`` runs the plain version with clamped
    pivots whatever the batch, ``force_single`` the single-scenario sweep (a
    batch of one only)."""
    batch = coeffs.A.shape[0]
    if force_plain:
        return _lqr_backward_batched(coeffs, reg)
    if force_single or (batch == 1 and not coeffs.A.is_cuda):
        if batch != 1:
            raise ValueError(f"the single-scenario sweep takes a batch of one, got {batch}")
        reg0 = torch.as_tensor(reg, dtype=coeffs.A.dtype, device=coeffs.A.device).reshape(())
        sol = _lqr_backward_single(LqrCoeffs(*(leaf[0] for leaf in coeffs)), reg0)
        return LqrSolution(*(leaf.unsqueeze(0) for leaf in sol))
    if coeffs.A.is_cuda:
        from .riccati_cuda import lqr_backward_cuda

        return lqr_backward_cuda(coeffs, reg, strict=batch == 1)
    return _lqr_backward_batched(coeffs, reg)


def lqr_forward(coeffs: LqrCoeffs, sol: LqrSolution, dx0: Tensor):
    """Roll the LQR policy through the linear dynamics (exact QP solution).

    Leaves [..., N, ...] with any leading batch dims, dx0 [..., nx].
    Returns (dxs [..., N+1, nx], dus [..., N, nu]) — the Newton/SQP step.
    """
    n = coeffs.A.shape[-3]
    mv = lambda m, v: (m @ v.unsqueeze(-1)).squeeze(-1)  # noqa: E731
    dx = dx0
    dxs, dus = [dx0], []
    for k in range(n):
        du = sol.kff[..., k, :] + mv(sol.gains[..., k, :, :], dx)
        dx = (
            mv(coeffs.A[..., k, :, :], dx) + mv(coeffs.B[..., k, :, :], du)
            + coeffs.b[..., k, :]
        )
        dxs.append(dx)
        dus.append(du)
    return torch.stack(dxs, dim=-2), torch.stack(dus, dim=-2)
