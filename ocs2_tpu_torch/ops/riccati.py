"""Time-varying LQR via the discrete Riccati recursion.

Counterpart of ``ocs2_tpu/ops/riccati.py``: the sequential paths, the
associative-scan ``lqr_backward_parallel``, the forward pass and the Hessian
correction ``convexify``.

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

The parallel path, ``lqr_backward_parallel``, reformulates the recursion as
an associative operator over conditional value functions (the parallel LQT
elements of Särkkä & García-Fernández, "Temporal Parallelization of Bayesian
Smoothers") and scans it in O(log N) depth: torch ops on the whole batch, no
hand-written kernel.
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
    """Solve M z = rhs for symmetric positive-definite M [..., n, n] via
    Cholesky, rhs [..., n] or [..., n, m]; NaN in every entry of an M that is
    not positive definite (as the JAX package's ``cho_factor`` gives)."""
    chol, info = torch.linalg.cholesky_ex(M)
    vec = rhs.ndim == M.ndim - 1
    z = torch.cholesky_solve(rhs.unsqueeze(-1) if vec else rhs, chol)
    z = torch.where((info != 0)[..., None, None], torch.full_like(z, float("nan")), z)
    return z.squeeze(-1) if vec else z


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


# -- parallel (associative-scan) backward pass --------------------------------

# Calls of lqr_backward_parallel, for a caller that shows a path went through
# it (as riccati_cuda.launch_count does for the kernel).
parallel_calls = 0


def _mv(m: Tensor, v: Tensor) -> Tensor:
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _eliminate_cross_terms(coeffs: LqrCoeffs, reg: Tensor):
    """Complete the square in u: du = dv - Quu^{-1}(Qux dx + qu), which
    removes the cross term and the term linear in u so that the stages fit
    the parallel element form.  Leaves [B, N, ...], reg [B]."""
    nu = coeffs.B.shape[-1]
    eye_u = torch.eye(nu, dtype=coeffs.B.dtype, device=coeffs.B.device)
    quu_r = coeffs.Quu + reg[:, None, None, None] * eye_u
    w = _solve_psd(quu_r, torch.cat([coeffs.Qux, coeffs.qu.unsqueeze(-1)], dim=-1))
    w_ux, w_u = w[..., :-1], w[..., -1]  # Quu^{-1} Qux, Quu^{-1} qu
    qux_t = coeffs.Qux.transpose(-1, -2)
    a_t = coeffs.A - coeffs.B @ w_ux
    b_t = coeffs.b - _mv(coeffs.B, w_u)
    qxx_t = symmetrize(coeffs.Qxx - qux_t @ w_ux)
    qx_t = coeffs.qx - _mv(qux_t, w_u)
    return a_t, b_t, qxx_t, qx_t, quu_r


class _Element(NamedTuple):
    """Conditional value function of a span of nodes (Särkkä et al.): leaves
    [B, M, ...]."""

    F: Tensor  # [nx, nx]
    c: Tensor  # [nx]
    C: Tensor  # [nx, nx]
    eta: Tensor  # [nx]
    J: Tensor  # [nx, nx]


def _combine(later: _Element, earlier: _Element) -> _Element:
    """Associative combination of conditional value functions, elementwise
    over the leading dims.  In the reversed scan the first argument is the
    already-combined later span and the second the earlier one; the
    composition is earlier-then-later.  Each of the two systems, I + C1 J2
    and I + J2 C1, is LU-factored once (partial pivoting, as
    ``jnp.linalg.solve``) and solved for all its right-hand sides at once;
    a singular one gives inf / NaN, not an error."""
    a, b = earlier, later
    nx = a.F.shape[-1]
    eye = torch.eye(nx, dtype=a.F.dtype, device=a.F.device)
    m = eye + a.C @ b.J  # I + C1 J2
    lu_m, piv_m, _ = torch.linalg.lu_factor_ex(m)
    rhs_m = torch.cat([a.F, (a.c + _mv(a.C, b.eta)).unsqueeze(-1), a.C], dim=-1)
    sol_m = torch.linalg.lu_solve(lu_m, piv_m, rhs_m)
    m_inv_f1, m_inv_rhs, m_inv_c1 = sol_m[..., :nx], sol_m[..., nx], sol_m[..., nx + 1:]
    n = eye + b.J @ a.C  # I + J2 C1
    lu_n, piv_n, _ = torch.linalg.lu_factor_ex(n)
    rhs_n = torch.cat([(b.eta - _mv(b.J, a.c)).unsqueeze(-1), b.J @ a.F], dim=-1)
    sol_n = torch.linalg.lu_solve(lu_n, piv_n, rhs_n)
    n_inv_eta, n_inv_j2f1 = sol_n[..., 0], sol_n[..., 1:]
    f1_t = a.F.transpose(-1, -2)
    return _Element(
        F=b.F @ m_inv_f1,
        c=_mv(b.F, m_inv_rhs) + b.c,
        C=symmetrize(b.F @ m_inv_c1 @ b.F.transpose(-1, -2) + b.C),
        eta=_mv(f1_t, n_inv_eta) + a.eta,
        J=symmetrize(f1_t @ n_inv_j2f1 + a.J),
    )


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    """[even0, odd0, even1, odd1, ...] along dim 1; ``even`` is as long as
    ``odd`` or one longer."""
    k = odd.shape[1]
    pairs = torch.stack([even[:, :k], odd], dim=2).flatten(1, 2)
    return torch.cat([pairs, even[:, k:]], dim=1) if even.shape[1] > k else pairs


def _scan(elems: _Element) -> _Element:
    """Inclusive scan of ``elems`` along dim 1 with ``_combine(first,
    second)``, by the odd/even recursion of ``jax.lax.associative_scan``:
    combine adjacent pairs, scan the pairs, then fix up the even positions;
    about 2 log2(M) combines, each over the whole batch."""
    num = elems.F.shape[1]
    if num < 2:
        return elems
    reduced = _combine(
        _Element(*(e[:, 0:num - 1:2] for e in elems)), _Element(*(e[:, 1::2] for e in elems)))
    odd = _scan(reduced)
    rest = _Element(*(e[:, 2::2] for e in elems))
    if num % 2 == 0:
        even = _combine(_Element(*(e[:, :-1] for e in odd)), rest)
    else:
        even = _combine(odd, rest)
    return _Element(*(
        _interleave(torch.cat([e[:, :1], r], dim=1), o)
        for e, r, o in zip(elems, even, odd)
    ))


def lqr_backward_parallel(coeffs: LqrCoeffs, reg=0.0) -> LqrSolution:
    """Associative-scan Riccati backward pass of a batch, O(log N) depth:
    coeffs leaves [B, N, ...], reg [B] (or scalar); fields of the result
    have a leading [B], and dv1, dv2 are summed over the nodes of each
    scenario.  Exact: the same value function and gains as ``lqr_backward``
    up to rounding.  The stage solves with ``Quu + reg I`` give NaN where
    that is not positive definite, as the JAX package's do.  Torch ops on
    either device; no kernel."""
    global parallel_calls
    parallel_calls += 1
    batch, n, nx = coeffs.b.shape
    dt, dev = coeffs.b.dtype, coeffs.b.device
    reg = torch.as_tensor(reg, dtype=dt, device=dev).expand(batch)
    a_t, b_t, qxx_t, qx_t, quu_r = _eliminate_cross_terms(coeffs, reg)
    b_tr = coeffs.B.transpose(-1, -2)
    c_stage = coeffs.B @ _solve_psd(quu_r, b_tr)

    # Stage elements [0..N-1], then the terminal element, which pins the
    # value function to the terminal quadratic; the scan runs from the end.
    zeros = torch.zeros((batch, 1, nx, nx), dtype=dt, device=dev)
    elems = _Element(
        F=torch.cat([a_t, zeros], dim=1),
        c=torch.cat([b_t, zeros[..., 0]], dim=1),
        C=torch.cat([c_stage, zeros], dim=1),
        eta=torch.cat([-qx_t, -coeffs.qf[:, None]], dim=1),
        J=torch.cat([qxx_t, coeffs.Qf[:, None]], dim=1),
    )
    scanned = _scan(_Element(*(e.flip(1) for e in elems)))
    value_S = scanned.J.flip(1)  # [B, N+1, nx, nx]
    value_s = -scanned.eta.flip(1)

    # Gains of every node from V_{k+1}, all at once: no recursion left.
    s_next, sv_next = value_S[:, 1:], value_s[:, 1:]
    sv = sv_next + _mv(s_next, coeffs.b)
    b_s = b_tr @ s_next
    quu_hat = quu_r + b_s @ coeffs.B
    qux_hat = coeffs.Qux + b_s @ coeffs.A
    qu_hat = coeffs.qu + _mv(b_tr, sv)
    k = -_solve_psd(quu_hat, torch.cat([qux_hat, qu_hat.unsqueeze(-1)], dim=-1))
    kk, kf = k[..., :-1], k[..., -1]
    return LqrSolution(
        gains=kk,
        kff=kf,
        value_S=value_S,
        value_s=value_s,
        dv1=torch.sum(kf * qu_hat, dim=(1, 2)),
        dv2=torch.sum(0.5 * kf * _mv(quu_hat, kf), dim=(1, 2)),
    )


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
