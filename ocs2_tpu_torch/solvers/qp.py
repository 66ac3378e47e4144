"""Dense KKT ground-truth solver for LQ optimal-control problems.

The port's own copy of ``ocs2_tpu/solvers/qp.py`` (numpy, float64): it
assembles the full dense KKT system of one equality-constrained LQ problem
and solves it directly.  Tests use it as the truth for the Riccati sweep and
PIPG; it never runs in a solve.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops.riccati import LqrCoeffs


class DenseQpSolution(NamedTuple):
    dxs: np.ndarray  # [N+1, nx]
    dus: np.ndarray  # [N, nu]
    cost: float


def solve_lq_dense(coeffs: LqrCoeffs, dx0) -> DenseQpSolution:
    """Solve min sum quadratic stage costs s.t. linear dynamics, dx_0 given,
    for ONE scenario (leaves [N, ...], numpy arrays or CPU tensors).

    Decision vector z = [dx_0, du_0, dx_1, du_1, ..., dx_N].
    """
    c = LqrCoeffs(*(np.asarray(f, np.float64) for f in coeffs))
    dx0 = np.asarray(dx0, np.float64)
    n, nx = c.b.shape
    nu = c.B.shape[-1]
    nz = (n + 1) * nx + n * nu
    h = np.zeros((nz, nz))
    g = np.zeros((nz,))

    def xi(k):
        return k * (nx + nu)

    def ui(k):
        return k * (nx + nu) + nx

    for k in range(n):
        sx = slice(xi(k), xi(k) + nx)
        su = slice(ui(k), ui(k) + nu)
        h[sx, sx] += c.Qxx[k]
        h[su, su] += c.Quu[k]
        h[su, sx] += c.Qux[k]
        h[sx, su] += c.Qux[k].T
        g[sx] += c.qx[k]
        g[su] += c.qu[k]
    sxn = slice(xi(n), xi(n) + nx)
    h[sxn, sxn] += c.Qf
    g[sxn] += c.qf

    # Equality constraints: dx_0 = dx0; dx_{k+1} = A dx_k + B du_k + b.
    nc = (n + 1) * nx
    e = np.zeros((nc, nz))
    d = np.zeros((nc,))
    e[0:nx, 0:nx] = np.eye(nx)
    d[0:nx] = dx0
    for k in range(n):
        row = slice((k + 1) * nx, (k + 2) * nx)
        e[row, xi(k): xi(k) + nx] = c.A[k]
        e[row, ui(k): ui(k) + nu] = c.B[k]
        e[row, xi(k + 1): xi(k + 1) + nx] = -np.eye(nx)
        d[row] = -c.b[k]

    kkt = np.block([[h, e.T], [e, np.zeros((nc, nc))]])
    rhs = np.concatenate([-g, d])
    z = np.linalg.solve(kkt, rhs)[:nz]

    dxs = np.stack([z[xi(k): xi(k) + nx] for k in range(n + 1)])
    dus = np.stack([z[ui(k): ui(k) + nu] for k in range(n)])
    cost = 0.5 * z @ h @ z + g @ z
    return DenseQpSolution(dxs=dxs, dus=dus, cost=float(cost))
