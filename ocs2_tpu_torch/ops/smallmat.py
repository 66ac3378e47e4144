"""Small-matrix linear algebra unrolled into plain tensor ops.

Counterpart of ``ocs2_tpu/ops/smallmat.py``.  For the tiny systems of the
perceptive terrain model (the 3x3 normal equations of ``terrain.plane_at``)
an unrolled Cholesky written as elementwise multiply/add/sqrt works under
``torch.func.vmap`` / ``jacfwd`` / ``jacrev`` and on any leading batch dims.

Unlike ``torch.linalg.cholesky`` it never raises: a pivot that is not
positive is clamped to ``eps`` (the JAX package's semantics), so a
degenerate patch gives a finite answer.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

# Above this size the library factorization takes over.
UNROLL_LIMIT = 16


def cholesky_small(M: Tensor, eps: float = 1e-12):
    """Lower Cholesky factor of a PSD matrix [..., n, n], unrolled over the
    static n.  Returns the list-of-columns form the solves below use:
    ``L[i][j]`` for j <= i, each [...]-shaped."""
    n = M.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = M[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(s, min=eps))
        L[j][j] = d
        inv_d = torch.reciprocal(d)  # not 1.0 / d: a 0-dim dual times a Python float is float64
        for i in range(j + 1, n):
            s = M[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _fwd_subst(L, B: Tensor):
    """Solve L y = B with L from cholesky_small; B [..., n, m]."""
    n = len(L)
    ys = []
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[i][k][..., None] * ys[k]
        ys.append(s / L[i][i][..., None])
    return ys


def _bwd_subst(L, ys):
    """Solve L^T z = y (y as a list of rows [..., m])."""
    n = len(L)
    zs = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for k in range(i + 1, n):
            s = s - L[k][i][..., None] * zs[k]
        zs[i] = s / L[i][i][..., None]
    return torch.stack(zs, dim=-2)


def solve_psd_small(M: Tensor, rhs: Tensor) -> Tensor:
    """Solve M z = rhs for symmetric PD M [..., n, n] and rhs [..., n, m] or
    [..., n]: unrolled Cholesky and substitution."""
    vec = rhs.ndim == M.ndim - 1
    if vec:
        rhs = rhs[..., None]
    L = cholesky_small(M)
    z = _bwd_subst(L, _fwd_subst(L, rhs))
    return z[..., 0] if vec else z


def solve_psd(M: Tensor, rhs: Tensor) -> Tensor:
    """Unrolled path for a small static n, the library Cholesky otherwise."""
    if M.shape[-1] <= UNROLL_LIMIT:
        return solve_psd_small(M, rhs)
    vec = rhs.ndim == M.ndim - 1
    chol = torch.linalg.cholesky(M)
    z = torch.cholesky_solve(rhs[..., None] if vec else rhs, chol)
    return z[..., 0] if vec else z
