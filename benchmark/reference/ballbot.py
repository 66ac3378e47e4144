"""Plain reference of the ``ballbot`` configuration: the ball-pendulum model
and SLQ (DDP whose backward sweep integrates the continuous-time Riccati
ODE), written from the configuration file.

Every array has a leading scenario dim [B]; a Python loop runs the
iterations, and a finished scenario's carry is frozen by a mask, so each
scenario's answer does not depend on the others of its batch.

The algorithm, per iteration:

* the continuous-time LQ data at the nodes: A = df/dx, B = df/du by
  ``torch.func.jacfwd``, the cost rate's Q, q, R, r (the input at node N
  repeats the last one), and the terminal quadratic;
* the Riccati ODE backward over every interval, ``riccati_substeps`` RK4
  steps with the coefficients interpolated linearly in time, then the gains
  of node k from the optimality condition, with the Levenberg-Marquardt
  regularization added to R;
* a line search over the step sizes alpha = decay^i, every candidate rolled
  out under u = u_k + alpha kff_k + K_k (x - x_k), priced by the trapezoidal
  rule, accepted by Armijo on the sweep's expected decrease, the lowest
  accepted merit taken;
* the regularization shrinks on success and grows on failure; a scenario is
  done when an accepted step lowers the merit by less than ``min_rel_cost``
  of it, or when the line search fails with the regularization at its cap.

The configuration has no constraints, so the merit is the cost.
"""
from __future__ import annotations

import torch

from .arith import Arith, cholesky_solve, rk_step, sym, uniform_times

Tensor = torch.Tensor


class Ballbot:
    """The configuration's model and cost on one device."""

    def __init__(self, cfg: dict, device):
        m = cfg["model"]
        self.radius = m["ball_radius"]
        self.m_total = m["ball_mass"] + m["body_mass"]
        self.ml = m["body_mass"] * m["body_com_height"]
        self.i_b = m["body_inertia"] + m["body_mass"] * m["body_com_height"] ** 2
        self.g = m["gravity"]
        self.yaw_inertia = m["yaw_inertia"]
        c = cfg["cost"]
        f32 = dict(dtype=torch.float32, device=device)
        self.Q = torch.diag(torch.tensor(c["Q_diag"], **f32))
        self.R = torch.diag(torch.tensor(c["R_diag"], **f32))
        self.Qf = c["final_factor"] * self.Q
        self.x_target = torch.tensor(c["target_state"], **f32)
        self.u_target = torch.tensor(c["target_input"], **f32)

    def _lean(self, theta, dtheta, tau):
        """Ball and body accelerations of one lean axis: the 2 x 2 mass
        matrix [[m_total, ml cos], [ml cos, I_b]] solved by Cramer's rule."""
        s, c = torch.sin(theta), torch.cos(theta)
        a12 = self.ml * c
        b1 = tau / self.radius + self.ml * dtheta * dtheta * s
        b2 = self.ml * self.g * s - tau
        det = self.m_total * self.i_b - a12 * a12
        return (self.i_b * b1 - a12 * b2) / det, (self.m_total * b2 - a12 * b1) / det

    def flow(self, x: Tensor, u: Tensor) -> Tensor:
        """dx/dt of x [..., 10] = (x, y, yaw, pitch, roll, and their rates)
        under u [..., 3] = (wheel torques x, y, yaw torque)."""
        ddx, ddpitch = self._lean(x[..., 3:4], x[..., 8:9], u[..., 0:1])
        ddy, ddroll = self._lean(x[..., 4:5], x[..., 9:10], u[..., 1:2])
        return torch.cat([x[..., 5:10], ddx, ddy, u[..., 2:3] / self.yaw_inertia, ddpitch, ddroll],
                         dim=-1)

    def rate(self, ar: Arith, x, u):
        """The running cost rate 0.5 dx'Q dx + 0.5 du'R du."""
        return 0.5 * ar.quad(self.Q, x - self.x_target) + 0.5 * ar.quad(self.R, u - self.u_target)


def _trajectory_cost(bb: Ballbot, ar: Arith, dts, xs, us):
    """Trapezoidal rule under zero-order-hold inputs, plus the terminal cost:
    xs [..., N+1, nx], us [..., N, nu] -> [...]."""
    run = 0.5 * dts * (bb.rate(ar, xs[..., :-1, :], us) + bb.rate(ar, xs[..., 1:, :], us))
    return torch.sum(run, dim=-1) + 0.5 * ar.quad(bb.Qf, xs[..., -1, :] - bb.x_target)


def _rollout(bb: Ballbot, policy, x0, dts, method, substeps):
    x, xs, us = x0, [x0], []
    for k in range(dts.shape[0]):
        u = policy(k, x)
        x = rk_step(bb.flow, method, x, u, dts[k], substeps)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=-2), torch.stack(us, dim=-2)


def _ct_lq(bb: Ballbot, ar: Arith, xs, us):
    """Node data [B, N+1, ...] of the Riccati ODE and the terminal
    quadratic."""
    us_ext = torch.cat([us, us[:, -1:]], dim=1)
    flat_x = xs.reshape(-1, xs.shape[-1])
    flat_u = us_ext.reshape(-1, us_ext.shape[-1])
    a = torch.func.vmap(torch.func.jacfwd(bb.flow, argnums=0))(flat_x, flat_u)
    b = torch.func.vmap(torch.func.jacfwd(bb.flow, argnums=1))(flat_x, flat_u)
    shape = xs.shape[:2]
    a = a.reshape(shape + a.shape[-2:])
    b = b.reshape(shape + b.shape[-2:])
    q = ar.mm(xs - bb.x_target, bb.Q.T)
    r = ar.mm(us_ext - bb.u_target, bb.R.T)
    qf = ar.mv(bb.Qf, xs[:, -1] - bb.x_target)
    return a, b, q, r, qf


def _riccati_rhs(ar: Arith, S, s, a, b, Q, q, R_reg, r):
    """Forward-time dS/dt, ds/dt of the Riccati ODE (both negated), P = 0."""
    bt = b.transpose(-1, -2)
    g_mat = ar.mm(bt, S)
    g_vec = r + ar.mv(bt, s)
    nx = S.shape[-1]
    z = cholesky_solve(R_reg, torch.cat([g_mat, g_vec.unsqueeze(-1)], dim=-1))
    k_mat, k_vec = z[..., :nx], z[..., nx]
    gt = g_mat.transpose(-1, -2)
    at = a.transpose(-1, -2)
    dS = -(Q + ar.mm(at, S) + ar.mm(S, a) - ar.mm(gt, k_mat))
    ds = -(q + ar.mv(at, s) - ar.mv(gt, k_vec))
    return sym(dS), ds


def _backward(bb: Ballbot, ar: Arith, lq, times, reg, substeps):
    """The Riccati ODE from the terminal quadratic back to node 0; returns
    gains [B, N, nu, nx], kff [B, N, nu], S [B, N+1, nx, nx], s [B, N+1, nx]
    and the expected decrease terms dv1, dv2 [B]."""
    a_n, b_n, q_n, r_n, qf = lq
    batch, nu = a_n.shape[0], b_n.shape[-1]
    n = times.shape[0] - 1
    eye_u = torch.eye(nu, dtype=a_n.dtype, device=a_n.device)
    R_reg = bb.R + reg[:, None, None] * eye_u
    Q = bb.Q.expand(batch, -1, -1)
    S, s = bb.Qf.expand(batch, -1, -1), qf
    gains, kffs, s_mats, s_vecs = [], [], [bb.Qf.expand(batch, -1, -1)], [qf]
    dv1 = torch.zeros(batch, dtype=a_n.dtype, device=a_n.device)
    dv2 = torch.zeros_like(dv1)
    for k in reversed(range(n)):
        dt = times[k + 1] - times[k]
        h = -dt / substeps
        dt_safe = torch.clamp(dt, min=1e-12)
        c0 = (a_n[:, k], b_n[:, k], q_n[:, k], r_n[:, k])
        c1 = (a_n[:, k + 1], b_n[:, k + 1], q_n[:, k + 1], r_n[:, k + 1])

        def at(theta):
            a, b, q, r = (v0 + theta * (v1 - v0) for v0, v1 in zip(c0, c1))
            return a, b, Q, q, R_reg, r

        for i in range(substeps):
            th0 = 1.0 - torch.tensor(i, dtype=dt.dtype, device=dt.device) / substeps
            thh = th0 + 0.5 * h / dt_safe
            th1 = th0 + h / dt_safe
            mid = at(thh)
            k1 = _riccati_rhs(ar, S, s, *at(th0))
            k2 = _riccati_rhs(ar, S + 0.5 * h * k1[0], s + 0.5 * h * k1[1], *mid)
            k3 = _riccati_rhs(ar, S + 0.5 * h * k2[0], s + 0.5 * h * k2[1], *mid)
            k4 = _riccati_rhs(ar, S + h * k3[0], s + h * k3[1], *at(th1))
            S = sym(S + (h / 6.0) * (k1[0] + 2 * k2[0] + 2 * k3[0] + k4[0]))
            s = s + (h / 6.0) * (k1[1] + 2 * k2[1] + 2 * k3[1] + k4[1])

        bt = c0[1].transpose(-1, -2)
        g_mat = ar.mm(bt, S)
        g_vec = c0[3] + ar.mv(bt, s)
        nx = S.shape[-1]
        z = -cholesky_solve(R_reg, torch.cat([g_mat, g_vec.unsqueeze(-1)], dim=-1))
        kk, kf = z[..., :nx], z[..., nx]
        dv1 = dv1 + dt * torch.sum(kf * g_vec, dim=-1)
        dv2 = dv2 + 0.5 * dt * torch.sum(kf * ar.mv(R_reg, kf), dim=-1)
        gains.append(kk)
        kffs.append(kf)
        s_mats.append(S)
        s_vecs.append(s)
    flip = lambda v: torch.stack(v[::-1], dim=1)  # noqa: E731
    return flip(gains), flip(kffs), flip(s_mats), flip(s_vecs), dv1, dv2


def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def solve(cfg: dict, x0: Tensor, arith: Arith) -> dict:
    """SLQ on the starts x0 [B, nx]; returns xs, us, gains, value_S, value_s,
    iterations and merit, each with a leading [B]."""
    st = cfg["solver"]["settings"]
    bb = Ballbot(cfg, x0.device)
    ar = arith
    f32 = dict(dtype=torch.float32, device=x0.device)
    times = uniform_times(0.0, cfg["horizon_s"], cfg["intervals"], x0.device)
    dts = times[1:] - times[:-1]
    n, nu, nx = cfg["intervals"], cfg["nu"], cfg["nx"]
    batch = x0.shape[0]
    method, substeps = st["integrator"], cfg["solver"]["rollout_substeps"]
    alphas = st["alpha_decay"] ** torch.arange(st["num_alphas"], **f32)
    rows = torch.arange(batch, device=x0.device)

    us_init = torch.zeros((batch, n, nu), **f32)
    xs, us = _rollout(bb, lambda k, x: us_init[:, k], x0, dts, method, substeps)
    merit = _trajectory_cost(bb, ar, dts, xs, us)
    reg = torch.full((batch,), st["reg_init"], **f32)
    it = torch.zeros(batch, dtype=torch.int32, device=x0.device)
    done = torch.zeros(batch, dtype=torch.bool, device=x0.device)
    gains = torch.zeros((batch, n, nu, nx), **f32)
    value_S = torch.zeros((batch, n + 1, nx, nx), **f32)
    value_s = torch.zeros((batch, n + 1, nx), **f32)

    for _ in range(st["max_iterations"]):
        active = (it < st["max_iterations"]) & ~done
        if not bool(active.any()):
            break
        K, kff, S, s, dv1, dv2 = _backward(
            bb, ar, _ct_lq(bb, ar, xs, us), times, reg, st["riccati_substeps"])

        x_nom, u_nom = xs[:, None], us[:, None]
        a_col = alphas[None, :, None]

        def policy(k, x):
            dx = x - x_nom[:, :, k]
            return u_nom[:, :, k] + a_col * kff[:, None, k] + ar.mv(K[:, None, k], dx)

        x0_cand = x0[:, None].expand(batch, alphas.shape[0], nx)
        xs_c, us_c = _rollout(bb, policy, x0_cand, dts, method, substeps)
        merits = _trajectory_cost(bb, ar, dts, xs_c, us_c)  # [B, A]
        expected = alphas * dv1[:, None] + alphas ** 2 * dv2[:, None]
        accept = merits <= merit[:, None] + st["armijo_coefficient"] * expected
        best = torch.argmin(torch.where(accept, merits, torch.full_like(merits, float("inf"))), 1)
        any_ok = accept.any(dim=1)
        merit_n = torch.where(any_ok, merits[rows, best], merit)
        rel = torch.abs(merit - merit_n) / torch.clamp(torch.abs(merit), min=1e-12)
        stalled = ~any_ok & (reg >= st["reg_max"] * 0.99)
        done_n = (any_ok & (rel < st["min_rel_cost"])) | stalled
        reg_n = torch.where(
            any_ok, torch.clamp(reg * st["reg_decrease"], min=st["reg_min"]),
            torch.clamp(reg * st["reg_increase"], max=st["reg_max"]))

        xs = _where(active, _where(any_ok, xs_c[rows, best], xs), xs)
        us = _where(active, _where(any_ok, us_c[rows, best], us), us)
        merit = torch.where(active, merit_n, merit)
        reg = torch.where(active, reg_n, reg)
        done = torch.where(active, done_n, done)
        it = torch.where(active, it + 1, it)
        gains = _where(active, K, gains)
        value_S = _where(active, S, value_S)
        value_s = _where(active, s, value_s)

    return {
        "xs": xs, "us": us, "gains": gains, "value_S": value_S, "value_s": value_s,
        "iterations": it, "merit": _trajectory_cost(bb, ar, dts, xs, us),
    }
