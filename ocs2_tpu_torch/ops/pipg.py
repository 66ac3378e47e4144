"""PIPG: proportional-integral projected gradient OCP-QP solver.

Counterpart of ``ocs2_tpu/ops/pipg.py`` (algorithm: Yu, Elango, Acikmese,
"Proportional-Integral Projected Gradient Method for Conic Optimization",
arXiv:2009.06980), for a batch of QPs: every leaf of ``LqrCoeffs`` carries a
leading ``[B]`` and every norm, inner product, min and max is taken per
scenario.  An iteration is a handful of batched matrix-vector products and
elementwise ops with no sequential dependency over the horizon: the only
coupling between nodes is the one-step neighbour exchange in G z and G' eta.
The JAX package's ``fori_loop``s are Python loops here, with no host read
inside; the power iterations start from ones, so no random generator is
involved.

Also here: the Ruiz-style equilibration of the stacked OCP data and the
power-iteration estimates of the extreme eigenvalues that set the PIPG step
sizes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .riccati import LqrCoeffs

Tensor = torch.Tensor


class PipgSettings(NamedTuple):
    num_iterations: int = 3000
    relaxation: float = 1.5  # rho in (0, 2)
    # Extra multiple of the estimated ||G||^2 for robustness of step sizes.
    sigma_safety: float = 1.1
    power_iterations: int = 30


class PipgSolution(NamedTuple):
    dxs: Tensor  # [B, N+1, nx]
    dus: Tensor  # [B, N, nu]
    eta: Tensor  # [B, N, nx] dynamics duals
    primal_residual: Tensor  # [B] ||G z - g||_inf at exit


def _per(v: Tensor, like: Tensor) -> Tensor:
    """A per-scenario value [B] broadcast against a leaf [B, ...]."""
    return v.reshape(v.shape + (1,) * (like.ndim - v.ndim))


def _sum2(a: Tensor) -> Tensor:
    """Sum over the node and entry dims of [B, K, m] -> [B]."""
    return torch.sum(a, dim=(-2, -1))


def _cost_matvec(coeffs: LqrCoeffs, dxs: Tensor, dus: Tensor):
    """(Q z)_k of the stage-block-diagonal cost with (x, u) cross terms."""
    x_k = dxs[:, :-1]
    gx = torch.einsum("bkxy,bky->bkx", coeffs.Qxx, x_k) + torch.einsum(
        "bkux,bku->bkx", coeffs.Qux, dus)
    gu = torch.einsum("bkuv,bkv->bku", coeffs.Quu, dus) + torch.einsum(
        "bkux,bkx->bku", coeffs.Qux, x_k)
    gxn = torch.einsum("bxy,by->bx", coeffs.Qf, dxs[:, -1])
    return torch.cat([gx, gxn[:, None]], dim=1), gu


def _g_matvec(coeffs: LqrCoeffs, dxs: Tensor, dus: Tensor) -> Tensor:
    """(G z)_k = A_k dx_k + B_k du_k - dx_{k+1}  (dynamics rows)."""
    return (
        torch.einsum("bkxy,bky->bkx", coeffs.A, dxs[:, :-1])
        + torch.einsum("bkxu,bku->bkx", coeffs.B, dus)
        - dxs[:, 1:]
    )


def _gt_matvec(coeffs: LqrCoeffs, eta: Tensor):
    """G' eta scattered to (dxs, dus).  dx_0 is pinned (not a variable) but
    its row is returned anyway; callers zero it."""
    gx_from_a = torch.einsum("bkxy,bkx->bky", coeffs.A, eta)  # to dx_k, k < N
    pad = torch.zeros_like(eta[:, :1])
    gx = torch.cat([gx_from_a, pad], dim=1) - torch.cat([pad, eta], dim=1)
    gu = torch.einsum("bkxu,bkx->bku", coeffs.B, eta)
    return gx, gu


def _zero_row0(gx: Tensor) -> Tensor:
    """dx_0 is not a decision variable."""
    return torch.cat([torch.zeros_like(gx[:, :1]), gx[:, 1:]], dim=1)


def estimate_sigma(coeffs: LqrCoeffs, iters: int = 30) -> Tensor:
    """lambda_max(G G') [B] by power iteration."""
    v = torch.ones_like(coeffs.b)
    v = v / _per(torch.sqrt(_sum2(v * v)), v)

    def apply(v):
        gx, gu = _gt_matvec(coeffs, v)
        return _g_matvec(coeffs, _zero_row0(gx), gu)

    for _ in range(iters):
        w = apply(v)
        v = w / _per(torch.clamp(torch.sqrt(_sum2(w * w)), min=1e-30), w)
    return _sum2(v * apply(v))


def estimate_cost_eigs(coeffs: LqrCoeffs, iters: int = 30):
    """(mu, lambda) [B] bounds on the stage-cost Hessian spectrum by power
    iteration on Q and on (lambda I - Q)."""
    batch, n, nx = coeffs.b.shape
    nu = coeffs.B.shape[-1]
    like = dict(dtype=coeffs.b.dtype, device=coeffs.b.device)

    def norm(gx, gu):
        return torch.sqrt(_sum2(gx * gx) + _sum2(gu * gu))

    vx = torch.ones((batch, n + 1, nx), **like)
    vu = torch.ones((batch, n, nu), **like)
    nrm = norm(vx, vu)
    vx, vu = vx / _per(nrm, vx), vu / _per(nrm, vu)
    for _ in range(iters):
        gx, gu = _cost_matvec(coeffs, vx, vu)
        nrm = torch.clamp(norm(gx, gu), min=1e-30)
        vx, vu = gx / _per(nrm, gx), gu / _per(nrm, gu)
    gx, gu = _cost_matvec(coeffs, vx, vu)
    lam = _sum2(vx * gx) + _sum2(vu * gu)

    # Smallest eigenvalue by power iteration on (lam I - Q).
    lam_x, lam_u = _per(lam, vx), _per(lam, vu)
    root = torch.sqrt(torch.tensor(float((n + 1) * nx + n * nu), **like))
    wx = torch.ones((batch, n + 1, nx), **like) / root
    wu = torch.ones((batch, n, nu), **like) / root
    for _ in range(iters):
        gx, gu = _cost_matvec(coeffs, wx, wu)
        gx, gu = lam_x * wx - gx, lam_u * wu - gu
        nrm = torch.clamp(norm(gx, gu), min=1e-30)
        wx, wu = gx / _per(nrm, gx), gu / _per(nrm, gu)
    gx, gu = _cost_matvec(coeffs, wx, wu)
    mu = lam - (_sum2(wx * (lam_x * wx - gx)) + _sum2(wu * (lam_u * wu - gu)))
    return torch.clamp(mu, min=0.0), lam


class RuizScaling(NamedTuple):
    """Diagonal equilibration: rows (dynamics duals) D_r [B, N, nx]; variable
    columns D_x [B, N+1, nx], D_u [B, N, nu]; cost scale c [B]."""

    d_row: Tensor
    d_x: Tensor
    d_u: Tensor
    c: Tensor


def ruiz_equilibrate(coeffs: LqrCoeffs, iterations: int = 5):
    """Ruiz-style row/column equilibration of the stacked (cost, dynamics)
    OCP data, stage by stage: every row/column inf-norm is a reduction over
    the stage blocks that touch it, never forming the stacked matrix.
    Returns the scaled coefficients and the scaling (to unscale the solution:
    dx = D_x dx_s, du = D_u du_s, eta = c^-1 D_r eta_s)."""
    batch, n, nx = coeffs.b.shape
    nu = coeffs.B.shape[-1]
    like = dict(dtype=coeffs.b.dtype, device=coeffs.b.device)

    def amax(a, dim):
        return torch.amax(torch.abs(a), dim=dim)

    def sc(mat, left, right):
        return left[..., :, None] * mat * right[..., None, :]

    cur = coeffs
    scal = RuizScaling(
        d_row=torch.ones((batch, n, nx), **like),
        d_x=torch.ones((batch, n + 1, nx), **like),
        d_u=torch.ones((batch, n, nu), **like),
        c=torch.ones((batch,), **like),
    )
    for _ in range(iterations):
        # Column inf-norms over all blocks touching each variable; the -I
        # block contributes 1 to every state column.
        colx = torch.cat([
            torch.clamp(torch.maximum(amax(cur.A, -2), torch.maximum(
                amax(cur.Qxx, -2), amax(cur.Qux, -2))), min=1.0),
            torch.clamp(amax(cur.Qf, -2), min=1.0)[:, None],
        ], dim=1)
        colu = torch.maximum(
            amax(cur.B, -2), torch.maximum(amax(cur.Quu, -2), amax(cur.Qux, -1)))
        dx_s = 1.0 / torch.sqrt(torch.clamp(colx, min=1e-6))
        du_s = 1.0 / torch.sqrt(torch.clamp(colu, min=1e-6))
        # The row scaling of the dynamics is tied to the next state's column
        # scaling so that the -I block stays exactly -I (the stage form
        # _g_matvec relies on): D_r[k] = 1 / D_x[k+1].
        dr = 1.0 / dx_s[:, 1:]
        x_k, x_n = dx_s[:, :-1], dx_s[:, -1]
        cur = LqrCoeffs(
            A=sc(cur.A, dr, x_k),
            B=sc(cur.B, dr, du_s),
            b=dr * cur.b,
            Qxx=sc(cur.Qxx, x_k, x_k),
            qx=x_k * cur.qx,
            Quu=sc(cur.Quu, du_s, du_s),
            qu=du_s * cur.qu,
            Qux=sc(cur.Qux, du_s, x_k),
            Qf=sc(cur.Qf, x_n, x_n),
            qf=x_n * cur.qf,
        )
        scal = RuizScaling(scal.d_row * dr, scal.d_x * dx_s, scal.d_u * du_s, scal.c)
    # Cost scale: the average stage-Hessian inf-norm toward 1.
    hnorm = (torch.mean(amax(cur.Qxx, (-2, -1)), dim=-1)
             + torch.mean(amax(cur.Quu, (-2, -1)), dim=-1)) * 0.5
    c_new = 1.0 / torch.clamp(hnorm, min=1e-6)
    cur = cur._replace(**{
        name: _per(c_new, getattr(cur, name)) * getattr(cur, name)
        for name in ("Qxx", "qx", "Quu", "qu", "Qux", "Qf", "qf")
    })
    return cur, scal._replace(c=c_new)


def pipg_solve(
    coeffs: LqrCoeffs,
    settings: PipgSettings = PipgSettings(),
    u_lower: Optional[Tensor] = None,
    u_upper: Optional[Tensor] = None,
    dxs0: Optional[Tensor] = None,
    dus0: Optional[Tensor] = None,
) -> PipgSolution:
    """Solve a batch of LQ OCP-QPs with the extrapolated PIPG iteration.

    min  sum_k 1/2 [dx;du]' H_k [dx;du] + q_k'[dx;du]  + terminal
    s.t. dx_{k+1} = A dx_k + B du_k + b_k,   dx_0 = 0,
         u_lower <= du_k <= u_upper          (optional box, by projection).

    Leaves [B, N, ...]; the box bounds broadcast against dus [B, N, nu]."""
    batch, n, nx = coeffs.b.shape
    nu = coeffs.B.shape[-1]
    like = dict(dtype=coeffs.b.dtype, device=coeffs.b.device)

    mu, lam = estimate_cost_eigs(coeffs, settings.power_iterations)
    sigma = settings.sigma_safety * torch.abs(estimate_sigma(coeffs, settings.power_iterations))
    # Step sizes (arXiv:2009.06980): alpha = 2 / (sqrt(mu^2 + 4 omega sigma)
    # + mu), beta = omega * alpha, with omega ~ lam a robust default.
    omega = torch.clamp(lam, min=1e-6)
    alpha = 2.0 / (torch.sqrt(mu * mu + 4.0 * omega * sigma) + mu)
    beta = omega * alpha
    rho = settings.relaxation

    def project(dus):
        if u_lower is not None:
            dus = torch.maximum(dus, u_lower)
        if u_upper is not None:
            dus = torch.minimum(dus, u_upper)
        return dus

    zx = torch.zeros((batch, n + 1, nx), **like) if dxs0 is None else dxs0
    zu = torch.zeros((batch, n, nu), **like) if dus0 is None else dus0
    w = torch.zeros((batch, n, nx), **like)  # integral dual state
    q_x = torch.cat([coeffs.qx, coeffs.qf[:, None]], dim=1)
    a_x, a_u, b_w = _per(alpha, zx), _per(alpha, zu), _per(beta, w)
    for _ in range(settings.num_iterations):
        # v = w + beta (G z + b); z+ = proj(z - alpha (Q z + q + G' v));
        # w+ = w + beta (G z+ + b); then over-relaxation of the primal pair.
        v = w + b_w * (_g_matvec(coeffs, zx, zu) + coeffs.b)
        gx, gu = _cost_matvec(coeffs, zx, zu)
        gtx, gtu = _gt_matvec(coeffs, v)
        zx_n = _zero_row0(zx - a_x * (gx + q_x + gtx))  # dx_0 = 0 pinned
        zu_n = project(zu - a_u * (gu + coeffs.qu + gtu))
        w = w + b_w * (_g_matvec(coeffs, zx_n, zu_n) + coeffs.b)
        zx = (1.0 - rho) * zx + rho * zx_n
        zu = (1.0 - rho) * zu + rho * zu_n
    res = _g_matvec(coeffs, zx, zu) + coeffs.b
    return PipgSolution(dxs=zx, dus=zu, eta=w,
                        primal_residual=torch.amax(torch.abs(res), dim=(-2, -1)))
