"""Plain reference of the ``legged_srbd_trot_ipm`` configuration: the
single-rigid-body quadruped trotting under the multiple-shooting
interior-point method, with the friction cone a hard inequality, written
from the configuration file.

The grid, the swing references, the model, the tracking and swing costs, the
foot constraint and its null-space projection, and the Riccati recursion are
those of ``legged_srbd_trot.py`` (imported, not copied); the relaxed barrier
on the cone is gone from the cost, and the cone

    h = mu f_z - sqrt(f_x^2 + f_y^2 + eps) >= 0   (a leg in stance; 1 in swing)

is the barrier's inequality, four rows a node.  Every array has a leading
scenario dim [B]; a Python loop runs the iterations and a mask freezes a
finished scenario, so each scenario's answer does not depend on the others
of its batch.

What it works out from the configuration, per iteration:

* slacks s = max(h, slack_init_min) and duals v = mu_init / s at the cold
  start;
* the LQ model of every node (``legged_srbd_trot``'s, without the cone's
  penalty) and the cone's value and Jacobians, condensed into the stage
  data: Q += H' diag(v / s) H, q -= H' (mu / s - (v / s)(h - s)), then
  ``hessian_reg`` on Quu;
* the foot constraint projected out and the Riccati step on the reduced
  inputs, unregularized;
* the slack and dual directions ds = H dz + (h - s), dv = mu / s - v -
  (v / s) ds, and the fraction-to-boundary limits of each, per scenario;
* the filter line search on the barrier merit (cost, the augmented
  Lagrangian of the foot constraint, -mu sum log s) over alpha = decay^i
  times the primal limit, the violation sqrt(|g|^2 + |h - s|^2 +
  |defects|^2);
* the slacks moved by the accepted step, the duals by the full dual limit,
  mu decreased to max(mu_target, min(linear mu, mu^power));
* the multiplier or the penalty of the foot constraint updated once the
  merit is stationary (LANCELOT), and the stop test: stationary, the
  violation under ``constraint_tol``, and mu at its target.

Where it departs from upstream OCS2's ``IpmSolver`` (``ocs2_ipm``), as the
program does:

* a cold batch solve of up to ``max_iterations`` from the stand's inputs,
  not a real-time iteration warm-started from the last tick;
* the foot constraint is projected out of the inputs, and the merit also
  carries its augmented Lagrangian, with the multiplier and penalty updates
  of the SQP solver;
* the slacks and duals start from the constraint and mu alone, with no
  lower bounds or margin rates on them;
* the primal step is chosen by the SQP solver's filter line search on the
  barrier merit; the dual step takes its full fraction-to-boundary limit
  whether or not the primal step was shortened;
* mu falls after every accepted step, not once the barrier problem has
  converged to a cost and a constraint tolerance;
* no Hessian correction: every cost term's Gauss-Newton quadratization is
  positive semidefinite, so the program's ``convexify="auto"`` adds none;
* the Cholesky factors of the reduced Quu are plain ones (NaN for a matrix
  that is not positive definite), where the program's sweep clamps pivots.
"""
from __future__ import annotations

import torch

from .arith import Arith, sym
from .legged_srbd_trot import Robot, _Problem, _where, project, riccati

Tensor = torch.Tensor

CONE_ROWS = 4


def _check_settings(cfg: dict) -> dict:
    """The solver settings, refused where the reference does not compute
    what they ask for."""
    st = cfg["solver"]["settings"]
    if cfg.get("friction_cone") != "hard":
        raise ValueError("this reference solves the hard friction cone only")
    if not st["project_equalities"] or st["convexify"] not in ("auto", False):
        raise ValueError("this reference projects the foot constraint and corrects no Hessian")
    if st["substeps"] != 1:
        raise ValueError("this reference takes one integration step an interval")
    return st


def _sqp_config(cfg: dict) -> dict:
    """The configuration as ``legged_srbd_trot``'s Robot reads it: the cone's
    constants under ``cost``, and no relaxed barrier (NaN weights, which the
    hard-cone robot never reads)."""
    cone = cfg["cone"]
    cost = dict(cfg["cost"], friction_mu=cone["friction_mu"], friction_cone_eps=cone["eps"],
                friction_barrier_mu=float("nan"), friction_barrier_delta=float("nan"))
    return dict(cfg, cost=cost)


class HardConeRobot(Robot):
    """The model and costs of ``legged_srbd_trot`` with the cone taken out of
    the cost."""

    def swing_penalties(self, e_z, e_vz):
        """Values, first and second derivatives of the swing penalties."""
        values = torch.cat([0.5 * self.w_z * e_z ** 2, 0.5 * self.w_vz * e_vz ** 2], -1)
        firsts = torch.cat([self.w_z * e_z, self.w_vz * e_vz], -1)
        seconds = torch.cat([torch.full_like(e_z, self.w_z), torch.full_like(e_vz, self.w_vz)], -1)
        return values, firsts, seconds

    def rate(self, x, u, flags, z_ref, vz_ref):
        """The running cost rate: tracking and the swing penalties."""
        _, e_z, e_vz, _ = self.residuals(x, u, flags, z_ref, vz_ref)
        values, _, _ = self.swing_penalties(e_z, e_vz)
        return (0.5 * self.ar.quad(self.Q, x - self.x_target)
                + 0.5 * self.ar.quad(self.R, u - self.u_target) + values.sum(-1))


class _IpmProblem(_Problem):
    """The configuration's grid, references and functions of a batch of
    trajectories, the cone the barrier's inequality."""

    def __init__(self, cfg, ar: Arith, device):
        cfg = _sqp_config(cfg)
        super().__init__(cfg, ar, device)
        self.robot = HardConeRobot(cfg, ar, device)

    def ipm_metrics(self, xs, us):
        """(cost, foot constraint g [..., N, 12], cone h [..., N, 4], defect
        sum of squares)."""
        cost, g, d_sse = self.metrics(xs, us)
        h = self.robot.residuals(xs[..., :-1, :], us, self.flags[:-1], self.z_ref[:-1],
                                 self.vz_ref[:-1])[0]
        return cost, g, h, d_sse

    def lq(self, xs, us):
        """The LQ model of every node of every scenario [B, N, ...] as
        ``legged_srbd_trot``'s, the cone's penalty left out, and the cone's
        value h and Jacobians Hx, Hu."""
        r, ar = self.robot, self.ar
        batch, n = us.shape[0], us.shape[1]
        nx = xs.shape[-1]
        x, u = xs[:, :-1].reshape(-1, nx), us.reshape(-1, us.shape[-1])
        node = lambda v: v[:-1].expand(batch, *v[:-1].shape).reshape(-1, *v.shape[1:])  # noqa: E731
        dt = self.dts.expand(batch, n).reshape(-1)
        flags, z_ref, vz_ref = node(self.flags), node(self.z_ref), node(self.vz_ref)

        a = torch.func.vmap(torch.func.jacfwd(self.step, argnums=0))(x, u, dt)
        b = torch.func.vmap(torch.func.jacfwd(self.step, argnums=1))(x, u, dt)
        f_next = self.step(x, u, dt[:, None])

        def stacked(xx, uu, fl, zr, vr):
            cone, e_z, e_vz, foot = r.residuals(xx, uu, fl, zr, vr)
            return torch.cat([cone, e_z, e_vz, foot], dim=-1)

        jx = torch.func.vmap(torch.func.jacfwd(stacked, argnums=0))(x, u, flags, z_ref, vz_ref)
        ju = torch.func.vmap(torch.func.jacfwd(stacked, argnums=1))(x, u, flags, z_ref, vz_ref)
        res = stacked(x, u, flags, z_ref, vz_ref)
        c4 = CONE_ROWS
        _, first, second = r.swing_penalties(res[:, c4:c4 + 4], res[:, c4 + 4:c4 + 8])
        jx_p, ju_p = jx[:, c4:c4 + 8], ju[:, c4:c4 + 8]
        wjx, wju = second[:, :, None] * jx_p, second[:, :, None] * ju_p
        dx, du = x - r.x_target, u - r.u_target
        w = dt[:, None]
        w2 = dt[:, None, None]
        qx = w * (ar.mm(dx, r.Q.T) + ar.mv(jx_p.transpose(1, 2), first))
        qu = w * (ar.mm(du, r.R.T) + ar.mv(ju_p.transpose(1, 2), first))
        Qxx = w2 * (r.Q + ar.mm(jx_p.transpose(1, 2), wjx))
        Quu = w2 * (r.R + ar.mm(ju_p.transpose(1, 2), wju))
        Qux = w2 * ar.mm(ju_p.transpose(1, 2), wjx)

        # Jump intervals: the state is carried over, the input has no effect.
        jump = self.is_jump.expand(batch, n).reshape(-1)
        eye = torch.eye(nx, dtype=x.dtype, device=x.device)
        a = torch.where(jump[:, None, None] > 0, eye, a)
        b = torch.where(jump[:, None, None] > 0, torch.zeros_like(b), b)
        f_next = torch.where(jump[:, None] > 0, x, f_next)

        shape = lambda v: v.reshape((batch, n) + v.shape[1:])  # noqa: E731
        xn = xs[:, -1]
        fc = c4 + 8
        return {
            "A": shape(a), "B": shape(b), "b": shape(f_next) - xs[:, 1:],
            "Qxx": shape(Qxx), "qx": shape(qx), "Quu": shape(Quu), "qu": shape(qu),
            "Qux": shape(Qux), "Qf": r.Qf.expand(batch, nx, nx),
            "qf": ar.mm(xn - r.x_target, r.Qf.T),
            "h": shape(res[:, :c4]), "Hx": shape(jx[:, :c4]), "Hu": shape(ju[:, :c4]),
            "g": shape(res[:, fc:]), "C": shape(jx[:, fc:]), "D": shape(ju[:, fc:]),
        }


def _ftb(s: Tensor, ds: Tensor, tau: float) -> Tensor:
    """The largest alpha <= 1 with s + alpha ds >= (1 - tau) s over one
    scenario's nodes and rows, [B]."""
    neg = ds < 0.0
    ratio = torch.where(neg, -tau * s / torch.where(neg, ds, torch.full_like(ds, -1.0)),
                        torch.ones_like(ds))
    return torch.clamp(torch.amin(ratio, dim=(-2, -1)), max=1.0)


def solve(cfg: dict, x0: Tensor, arith: Arith) -> dict:
    """The interior-point method on the starts x0 [B, nx] from the shared
    cold start (every input the stand's weight-compensating forces, every
    state x0); returns xs, us, gains, value_S, value_s, iterations and merit
    (the barrier merit of the final iterate), each with a leading [B]."""
    st = _check_settings(cfg)
    ar = arith
    pb = _IpmProblem(cfg, ar, x0.device)
    r = pb.robot
    f32 = dict(dtype=torch.float32, device=x0.device)
    batch, nx, nu, n = x0.shape[0], cfg["nx"], cfg["nu"], cfg["intervals"]
    rows = torch.arange(batch, device=x0.device)
    alphas = st["alpha_decay"] ** torch.arange(st["num_alphas"], **f32)
    reg_eye = st["hessian_reg"] * torch.eye(nu, **f32)
    tau = st["ftb_margin"]

    xs = x0[:, None].expand(batch, n + 1, nx).contiguous()
    us = r.u_target.expand(batch, n, nu).contiguous()
    lmbd = torch.zeros((batch, n, 12), **f32)
    rho = torch.full((batch,), st["al_rho_init"], **f32)
    mu = torch.full((batch,), st["mu_init"], **f32)

    def merit_of(cost, g, lm, rh, s, m):
        """Cost, the foot constraint's augmented Lagrangian and the barrier;
        the leading dims of lm, rh, s and m broadcast against cost's."""
        al = cost + torch.sum(-lm * g + 0.5 * rh[..., None, None] * g ** 2, dim=(-2, -1))
        return al - m * torch.sum(torch.log(s), dim=(-2, -1))

    def viol_of(g, h, s, d_sse):
        return torch.sqrt(torch.sum(g ** 2, dim=(-2, -1)) + torch.sum((h - s) ** 2, dim=(-2, -1))
                          + d_sse)

    cost, g, h, d_sse = pb.ipm_metrics(xs, us)
    s = torch.clamp(h, min=st["slack_init_min"])
    v = mu[:, None, None] / s
    merit = merit_of(cost, g, lmbd, rho, s, mu)
    viol = viol_of(g, h, s, d_sse)
    best_cviol = torch.sqrt(torch.sum(g ** 2, dim=(-2, -1)))
    it = torch.zeros(batch, dtype=torch.int32, device=x0.device)
    done = torch.zeros(batch, dtype=torch.bool, device=x0.device)
    gains = torch.zeros((batch, n, nu, nx), **f32)
    value_S = torch.zeros((batch, n + 1, nx, nx), **f32)
    value_s = torch.zeros((batch, n + 1, nx), **f32)
    reg0 = torch.zeros((batch,), **f32)

    for _ in range(st["max_iterations"]):
        active = (it < st["max_iterations"]) & ~done
        if not bool(active.any()):
            break
        c = pb.lq(xs, us)
        # The slack and dual blocks condensed into the stage data.
        sig = v / s
        grad = mu[:, None, None] / s - sig * (c["h"] - s)
        hxt, hut = c["Hx"].transpose(-1, -2), c["Hu"].transpose(-1, -2)
        sig_hx = sig[..., None] * c["Hx"]
        qx_c = c["qx"] - ar.mv(hxt, grad)
        qu_c = c["qu"] - ar.mv(hut, grad)
        Qxx = c["Qxx"] + ar.mm(hxt, sig_hx)
        Quu = c["Quu"] + ar.mm(hut, sig[..., None] * c["Hu"]) + reg_eye
        Qux = c["Qux"] + ar.mm(hut, sig_hx)

        p0, px, pu = project(ar, c["g"], c["C"], c["D"])
        pxt, put = px.transpose(-1, -2), pu.transpose(-1, -2)
        quu_px = ar.mm(Quu, px)
        qu_full = qu_c + ar.mv(Quu, p0)
        red = {
            "A": c["A"] + ar.mm(c["B"], px), "B": ar.mm(c["B"], pu),
            "b": c["b"] + ar.mv(c["B"], p0),
            "Qxx": sym(Qxx + ar.mm(pxt, Qux) + ar.mm(Qux.transpose(-1, -2), px)
                       + ar.mm(pxt, quu_px)),
            "qx": qx_c + ar.mv(pxt, qu_full) + ar.mv(Qux.transpose(-1, -2), p0),
            "Quu": ar.mm(put, ar.mm(Quu, pu)), "qu": ar.mv(put, qu_full),
            "Qux": ar.mm(put, Qux + quu_px), "Qf": c["Qf"], "qf": c["qf"],
        }
        kv, kffv, S, s_vec = riccati(ar, red, reg0)
        dx = torch.zeros((batch, nx), **f32)
        dxs, dvs = [dx], []
        for k in range(n):
            dv_k = kffv[:, k] + ar.mv(kv[:, k], dx)
            dx = ar.mv(red["A"][:, k], dx) + ar.mv(red["B"][:, k], dv_k) + red["b"][:, k]
            dxs.append(dx)
            dvs.append(dv_k)
        dxs, dvs = torch.stack(dxs, 1), torch.stack(dvs, 1)
        dus = p0 + ar.mv(px, dxs[:, :-1]) + ar.mv(pu, dvs)
        K = px + ar.mm(pu, kv)

        # Slack and dual directions and their fraction-to-boundary limits.
        ds = ar.mv(c["Hx"], dxs[:, :-1]) + ar.mv(c["Hu"], dus) + (c["h"] - s)
        dv = mu[:, None, None] / s - v - sig * ds
        a_primal, a_dual = _ftb(s, ds, tau), _ftb(v, dv, tau)

        # The filter line search on the barrier merit over the limited grid.
        a_eff = alphas[None, :] * a_primal[:, None]  # [B, A]
        a4 = a_eff[:, :, None, None]
        xs_c, us_c = xs[:, None] + a4 * dxs[:, None], us[:, None] + a4 * dus[:, None]
        s_c = s[:, None] + a4 * ds[:, None]
        cost_c, g_c, h_c, d_c = pb.ipm_metrics(xs_c, us_c)
        merits = merit_of(cost_c, g_c, lmbd[:, None], rho[:, None], s_c, mu[:, None])
        viols = viol_of(g_c, h_c, s_c, d_c)
        slope = (torch.sum(qx_c * dxs[:, :-1], dim=(1, 2)) + torch.sum(qu_c * dus, dim=(1, 2))
                 + torch.sum(c["qf"] * dxs[:, -1], dim=1))
        m0, v0 = merit[:, None], viol[:, None]
        armijo = merits <= m0 + st["armijo_factor"] * a_eff * slope[:, None]
        less_viol = viols < (1.0 - 1e-3) * v0
        accept = torch.where(
            v0 > st["g_max"], less_viol,
            torch.where((v0 < st["g_min"]) & (viols < st["g_min"]), armijo,
                        (merits < m0) | less_viol))
        first = torch.argmax(accept.to(torch.int8), dim=1)
        any_ok = accept.any(dim=1)
        a_star = torch.where(any_ok, a_eff[rows, first], torch.zeros_like(a_primal))
        xs_n = _where(any_ok, xs_c[rows, first], xs)
        us_n = _where(any_ok, us_c[rows, first], us)
        # The picked candidate's metrics, also where every step was refused.
        cost_n, g_n = cost_c[rows, first], g_c[rows, first]
        viol_n = torch.where(any_ok, viols[rows, first], viol)

        # Slacks by the accepted step (unguarded), duals by the dual limit,
        # mu down.
        s_n = s + a_star[:, None, None] * ds
        v_n = _where(any_ok, v + a_dual[:, None, None] * dv, v)
        mu_n = torch.where(
            any_ok,
            torch.clamp(torch.minimum(st["mu_linear_decrease"] * mu,
                                      mu ** st["mu_superlinear_power"]), min=st["mu_target"]),
            mu)

        # The foot constraint's multiplier or penalty once the merit is
        # stationary.
        merit_same = torch.where(any_ok, merit_of(cost_n, g_n, lmbd, rho, s_n, mu_n), merit)
        rel = torch.abs(merit - merit_same) / torch.clamp(torch.abs(merit), min=1e-12)
        inner = (any_ok & (rel < st["cost_tol"])) | ~any_ok
        cviol_n = torch.sqrt(torch.sum(g_n ** 2, dim=(-2, -1)))
        c_feasible = cviol_n < st["constraint_tol"]
        improved = (cviol_n <= 0.5 * best_cviol) | c_feasible
        lmbd_n = _where(inner & improved, lmbd - rho[:, None, None] * g_n, lmbd)
        rho_n = torch.where(inner & ~improved,
                            torch.clamp(rho * st["al_rho_growth"], max=st["al_rho_max"]), rho)
        best_n = torch.where(inner, torch.minimum(best_cviol, cviol_n), best_cviol)
        merit_n = torch.where(any_ok, merit_of(cost_n, g_n, lmbd_n, rho_n, s_n, mu_n), merit)
        at_target = mu <= st["mu_target"] * (1.0 + 1e-9)
        done_n = inner & (viol_n < st["constraint_tol"]) & at_target

        xs, us = _where(active, xs_n, xs), _where(active, us_n, us)
        s, v = _where(active, s_n, s), _where(active, v_n, v)
        mu = torch.where(active, mu_n, mu)
        lmbd, rho = _where(active, lmbd_n, lmbd), torch.where(active, rho_n, rho)
        merit, viol = torch.where(active, merit_n, merit), torch.where(active, viol_n, viol)
        best_cviol = torch.where(active, best_n, best_cviol)
        done = torch.where(active, done_n, done)
        it = torch.where(active, it + 1, it)
        gains = _where(active, K, gains)
        value_S, value_s = _where(active, S, value_S), _where(active, s_vec, value_s)

    cost, g, _, _ = pb.ipm_metrics(xs, us)
    return {
        "xs": xs, "us": us, "gains": gains, "value_S": value_S, "value_s": value_s,
        "iterations": it, "merit": merit_of(cost, g, lmbd, rho, s, mu),
    }
