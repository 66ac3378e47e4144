"""Plain reference of the ``legged_srbd_trot`` configuration: the
single-rigid-body quadruped trotting under multiple-shooting SQP, written
from the configuration file.

Every array has a leading scenario dim [B]; a Python loop runs the
iterations and a mask freezes a finished scenario, so each scenario's answer
does not depend on the others of its batch.

What it works out again from the configuration:

* the time grid: the gait's switching times inside the horizon become
  duplicated nodes (a jump interval of length 0, the state carried over),
  the remaining intervals spread over the segments in proportion to their
  lengths; the contact mode of every node;
* the swing references: on every run of nodes in which a leg is off the
  ground, the height h 16 s^2 (1 - s)^2 over the swing's phase s and its
  time derivative;
* the model: the body's linear and normalized angular momentum, base pose
  (position, ZYX Euler angles) and 12 joint angles; inputs the 12 contact
  forces and 12 joint velocities; foot positions and velocities from the
  leg kinematics;
* the costs: quadratic tracking of the stand (the foot-velocity weight
  mapped to the joints through each leg's Jacobian at the stand), a relaxed
  log barrier on the friction cone, quadratic penalties on the swing feet's
  height and vertical velocity, each penalty quadratized by Gauss-Newton;
  the terminal quadratic;
* the foot constraint, zero foot velocity in stance and zero force in
  swing, as an equality that the QP meets exactly: the inputs are written
  du = p0 + Px dx + Pu v over the null space of the constraint's input
  Jacobian, from LAPACK's QR (``torch.linalg.qr`` on the host) and a
  triangular solve, and a Riccati recursion on the reduced inputs v;
* SQP: the LQ model of every node around the current trajectory with the
  rk2 defects, the QP's step, a filter line search over alpha = decay^i,
  the Levenberg-Marquardt regularization, and the augmented-Lagrangian merit
  and multiplier schedule of the foot constraint.
"""
from __future__ import annotations

import numpy as np
import torch

from .arith import Arith, cholesky_solve, rk_step, sym

Tensor = torch.Tensor

LEGS = 4


# -- grid and references ----------------------------------------------------------

def time_grid(cfg: dict):
    """Node times [N+1] (float32), jump mask [N] and contact mode [N+1] of
    the configuration's gait over its horizon."""
    gait, horizon, n = cfg["gait"], float(cfg["horizon_s"]), cfg["intervals"]
    cycle = gait["cycle_s"]
    switch, modes = gait["switching_times_in_cycle"], gait["modes"]
    events, event_modes, k = [], [], 0
    while k * cycle < horizon:
        for s, m in zip(switch, modes):
            # Switching times are kept in float32, as a schedule stores them.
            t = float(np.float32(k * cycle + s))
            if 0.0 < t < horizon:
                events.append(t)
                event_modes.append(m)
        k += 1
    mode_seq = [modes[0]] + event_modes  # the first mode is active at t = 0
    n_int = n - len(events)
    bounds = [0.0] + events + [horizon]
    lens = np.diff(bounds)
    alloc = np.maximum(1, np.floor(n_int * lens / lens.sum()).astype(int))
    while alloc.sum() > n_int:
        alloc[np.argmax(alloc)] -= 1
    while alloc.sum() < n_int:
        alloc[np.argmax(lens / alloc)] += 1
    times, jumps, node_modes = [0.0], [], [mode_seq[0]]
    for seg, count in enumerate(alloc):
        times += np.linspace(bounds[seg], bounds[seg + 1], count + 1)[1:].tolist()
        jumps += [0.0] * count
        node_modes += [mode_seq[seg]] * count
        if seg < len(events):
            times.append(bounds[seg + 1])
            jumps.append(1.0)
            node_modes.append(mode_seq[seg + 1])
    return (np.asarray(times, np.float32), np.asarray(jumps, np.float32),
            np.asarray(node_modes, np.int64))


def contact(modes: np.ndarray) -> np.ndarray:
    """[..., 4] float flags of integer modes: bit i set = leg i in contact."""
    return ((modes[..., None] >> np.arange(LEGS)) & 1).astype(np.float32)


def swing_references(times: np.ndarray, flags: np.ndarray, height: float):
    """Foot height and vertical velocity references [N+1, 4]: over each run
    of swing nodes, from the node before the run (lift-off) to the node
    after it (touch-down), z = h 16 s^2 (1 - s)^2 of the phase s."""
    t = times.astype(np.float64)
    n1 = t.shape[0]
    z = np.zeros((n1, LEGS), np.float32)
    vz = np.zeros((n1, LEGS), np.float32)
    for leg in range(LEGS):
        swing = flags[:, leg] < 0.5
        k = 0
        while k < n1:
            if not swing[k]:
                k += 1
                continue
            start = k
            while k < n1 and swing[k]:
                k += 1
            t_lo, t_hi = t[max(start - 1, 0)], t[min(k, n1 - 1)]
            duration = max(t_hi - t_lo, 1e-3)
            s = np.clip((t[start:k] - t_lo) / duration, 0.0, 1.0)
            z[start:k, leg] = height * 16.0 * s ** 2 * (1.0 - s) ** 2
            dz_ds = height * 16.0 * (2.0 * s * (1.0 - s) ** 2 - 2.0 * s ** 2 * (1.0 - s))
            vz[start:k, leg] = dz_ds / max(duration, 1e-6)
    return z, vz


# -- model --------------------------------------------------------------------------

class Robot:
    """The configuration's model, costs and constraint on one device."""

    def __init__(self, cfg: dict, ar: Arith, device):
        self.ar = ar
        m, c = cfg["model"], cfg["cost"]
        f32 = dict(dtype=torch.float32, device=device)
        self.mass, self.gravity = m["mass"], m["gravity"]
        self.inertia = torch.tensor(m["inertia"], **f32)
        self.hip = torch.tensor(m["hip_offsets"], **f32)
        self.lateral = torch.tensor(m["leg_side"], **f32)[:, None] * m["hip_lateral"]
        self.thigh, self.shank = m["thigh_length"], m["shank_length"]
        self.cos_floor = m["euler_rate_cos_floor"]
        self.mu, self.cone_eps = c["friction_mu"], c["friction_cone_eps"]
        self.barrier_mu, self.barrier_delta = c["friction_barrier_mu"], c["friction_barrier_delta"]
        self.w_z, self.w_vz = c["swing_height_weight"], c["swing_velocity_weight"]

        joints = torch.tensor(m["default_joints"], dtype=torch.float64)
        stand = (self.thigh + self.shank) * np.cos(m["stand_pitch_angle"])
        x_t = torch.zeros(cfg["nx"], dtype=torch.float64)
        x_t[8], x_t[12:] = stand, joints
        u_t = torch.zeros(cfg["nu"], dtype=torch.float64)
        u_t[2:12:3] = self.mass * self.gravity / LEGS
        self.x_target, self.u_target = x_t.to(**f32), u_t.to(**f32)
        self.Q = torch.diag(torch.tensor(c["Q_diag"], **f32))
        self.Qf = c["final_factor"] * self.Q
        r = torch.zeros((cfg["nu"], cfg["nu"]), dtype=torch.float64)
        r[:12, :12] = c["force_weight"] * torch.eye(12, dtype=torch.float64)
        hip64, lat64 = self.hip.double().cpu(), self.lateral.double().cpu()
        for leg in range(LEGS):
            q = joints[3 * leg:3 * leg + 3]
            jac = torch.func.jacfwd(lambda qq: self._foot_in_base(qq, lat64[leg], hip64[leg]))(q)
            r[12 + 3 * leg:15 + 3 * leg, 12 + 3 * leg:15 + 3 * leg] = (
                c["foot_velocity_weight"] * jac.T @ jac)
        self.R = r.to(**f32)

    # Leg kinematics: hip offset, HAA about x, lateral offset, HFE and KFE
    # about y, thigh and shank along -z.
    def _plane(self, q):
        hfe, kfe = q[..., 1:2], q[..., 2:3]
        x_p = -self.thigh * torch.sin(hfe) - self.shank * torch.sin(hfe + kfe)
        z_p = -self.thigh * torch.cos(hfe) - self.shank * torch.cos(hfe + kfe)
        return x_p, z_p

    def _foot_in_base(self, q, lateral, hip):
        x_p, z_p = self._plane(q)
        c, s = torch.cos(q[..., 0:1]), torch.sin(q[..., 0:1])
        return hip + torch.cat([x_p, c * lateral - s * z_p, s * lateral + c * z_p], dim=-1)

    def _foot_velocity_in_base(self, q, dq):
        """d/dt of _foot_in_base along joint rates dq, written out."""
        x_p, z_p = self._plane(q)
        c, s = torch.cos(q[..., 0:1]), torch.sin(q[..., 0:1])
        hfe_kfe = q[..., 1:2] + q[..., 2:3]
        dx_p = z_p * dq[..., 1:2] - self.shank * torch.cos(hfe_kfe) * dq[..., 2:3]
        dz_p = -x_p * dq[..., 1:2] + self.shank * torch.sin(hfe_kfe) * dq[..., 2:3]
        lat = self.lateral
        return torch.cat([
            dx_p,
            (-s * lat - c * z_p) * dq[..., 0:1] - s * dz_p,
            (c * lat - s * z_p) * dq[..., 0:1] + c * dz_p,
        ], dim=-1)

    def rotation(self, euler):
        """R = Rz(yaw) Ry(pitch) Rx(roll) of euler [..., 3]."""
        one, zero = torch.ones_like(euler[..., 0:1]), torch.zeros_like(euler[..., 0:1])

        def mat(rows):
            return torch.stack([torch.cat(r, dim=-1) for r in rows], dim=-2)

        cy, sy = torch.cos(euler[..., 0:1]), torch.sin(euler[..., 0:1])
        cp, sp = torch.cos(euler[..., 1:2]), torch.sin(euler[..., 1:2])
        cr, sr = torch.cos(euler[..., 2:3]), torch.sin(euler[..., 2:3])
        rz = mat([[cy, -sy, zero], [sy, cy, zero], [zero, zero, one]])
        ry = mat([[cp, zero, sp], [zero, one, zero], [-sp, zero, cp]])
        rx = mat([[one, zero, zero], [zero, cr, -sr], [zero, sr, cr]])
        return self.ar.mm(self.ar.mm(rz, ry), rx)

    def _euler_rates(self, euler, omega):
        """ZYX Euler rates of the body angular velocity omega [..., 3]."""
        cp = torch.clamp(torch.cos(euler[..., 1:2]), min=self.cos_floor)
        sp = torch.sin(euler[..., 1:2])
        cr, sr = torch.cos(euler[..., 2:3]), torch.sin(euler[..., 2:3])
        wy, wz = omega[..., 1:2], omega[..., 2:3]
        return torch.cat([
            (sr * wy + cr * wz) / cp,
            cr * wy - sr * wz,
            omega[..., 0:1] + (sr * wy + cr * wz) * sp / cp,
        ], dim=-1)

    def _legs(self, v):
        return v.reshape(v.shape[:-1] + (LEGS, 3))

    def _feet_relative(self, x):
        """World-frame foot positions relative to the base, [..., 4, 3]."""
        feet_b = self._foot_in_base(self._legs(x[..., 12:24]), self.lateral, self.hip)
        return self.ar.mm(feet_b, self.rotation(x[..., 9:12]).transpose(-1, -2))

    def _omega(self, x):
        return self.mass * x[..., 3:6] / self.inertia

    def flow(self, x, u):
        """dx/dt of the single rigid body: forces at the feet about the base
        origin, gravity, the base moving with the CoM velocity."""
        forces = self._legs(u[..., :12])
        lever = self._feet_relative(x)
        lever, forces = torch.broadcast_tensors(lever, forces)
        torque = torch.sum(torch.linalg.cross(lever, forces, dim=-1), dim=-2)
        dv = torch.sum(forces, dim=-2) / self.mass
        dv = torch.cat([dv[..., :2], dv[..., 2:3] - self.gravity], dim=-1)
        return torch.cat([dv, torque / self.mass, x[..., 0:3],
                          self._euler_rates(x[..., 9:12], self._omega(x)), u[..., 12:24]], dim=-1)

    def foot_positions(self, x):
        return x[..., None, 6:9] + self._feet_relative(x)

    def foot_velocities(self, x, u):
        """v_com + omega x (R p) + R J dq for every foot, [..., 4, 3]."""
        rot = self.rotation(x[..., 9:12])
        p_rel = self.ar.mm(self._foot_in_base(self._legs(x[..., 12:24]), self.lateral, self.hip),
                           rot.transpose(-1, -2))
        omega = self._omega(x)[..., None, :]
        omega, p_rel_b = torch.broadcast_tensors(omega, p_rel)
        v_b = self._foot_velocity_in_base(self._legs(x[..., 12:24]), self._legs(u[..., 12:24]))
        return (x[..., None, 0:3] + torch.linalg.cross(omega, p_rel_b, dim=-1)
                + self.ar.mm(v_b, rot.transpose(-1, -2)))

    # -- constraint and penalty residuals of one node -------------------------------
    def residuals(self, x, u, flags, z_ref, vz_ref):
        """(cone [..., 4], swing height error [..., 4], swing vertical
        velocity error [..., 4], foot constraint [..., 12])."""
        f = self._legs(u[..., :12])
        cone = self.mu * f[..., 2] - torch.sqrt(f[..., 0] ** 2 + f[..., 1] ** 2 + self.cone_eps)
        cone = flags * cone + (1.0 - flags)
        v = self.foot_velocities(x, u)
        e_z = (1.0 - flags) * (self.foot_positions(x)[..., 2] - z_ref)
        e_vz = (1.0 - flags) * (v[..., 2] - vz_ref)
        foot = flags[..., None] * v + (1.0 - flags[..., None]) * f
        return cone, e_z, e_vz, foot.reshape(foot.shape[:-2] + (12,))

    def penalties(self, cone, e_z, e_vz):
        """Values, first and second derivatives of the three penalties."""
        mu, d = self.barrier_mu, self.barrier_delta
        above = cone > d
        safe = torch.clamp(cone, min=d)
        value = torch.where(above, -mu * torch.log(safe),
                            mu * (0.5 * ((cone - 2 * d) / d) ** 2 - 0.5 - float(np.log(d))))
        first = torch.where(above, -mu / safe, mu * (cone - 2 * d) / d ** 2)
        second = torch.where(above, mu / safe ** 2, torch.full_like(cone, mu / d ** 2))
        values = torch.cat([value, 0.5 * self.w_z * e_z ** 2, 0.5 * self.w_vz * e_vz ** 2], -1)
        firsts = torch.cat([first, self.w_z * e_z, self.w_vz * e_vz], -1)
        seconds = torch.cat([second, torch.full_like(e_z, self.w_z),
                             torch.full_like(e_vz, self.w_vz)], -1)
        return values, firsts, seconds

    def rate(self, x, u, flags, z_ref, vz_ref):
        """The running cost rate."""
        cone, e_z, e_vz, _ = self.residuals(x, u, flags, z_ref, vz_ref)
        values, _, _ = self.penalties(cone, e_z, e_vz)
        return (0.5 * self.ar.quad(self.Q, x - self.x_target)
                + 0.5 * self.ar.quad(self.R, u - self.u_target) + values.sum(-1))


# -- the solver ---------------------------------------------------------------------

def _where(mask, new, old):
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


class _Problem:
    """The configuration's grid and references and the functions that price
    and linearize a batch of trajectories."""

    def __init__(self, cfg, ar: Arith, device):
        self.cfg, self.ar = cfg, ar
        self.robot = Robot(cfg, ar, device)
        times, jumps, modes = time_grid(cfg)
        flags = contact(modes)
        z, vz = swing_references(times, flags, cfg["cost"]["swing_height_m"])
        f32 = dict(dtype=torch.float32, device=device)
        self.times = torch.as_tensor(times, **f32)
        self.dts = self.times[1:] - self.times[:-1]
        self.is_jump = torch.as_tensor(jumps, **f32)
        self.flags = torch.as_tensor(flags, **f32)
        self.z_ref, self.vz_ref = torch.as_tensor(z, **f32), torch.as_tensor(vz, **f32)
        st = cfg["solver"]["settings"]
        self.method, self.substeps = st["integrator"], st["substeps"]

    def step(self, x, u, dt):
        return rk_step(self.robot.flow, self.method, x, u, dt, self.substeps)

    def next_states(self, xs, us):
        """x_{k+1} that the model gives from x_k, u_k: the integration step
        or, on a jump interval, the state itself."""
        m = self.is_jump[:, None]
        x_int = self.step(xs[..., :-1, :], us, self.dts[:, None])
        return (1.0 - m) * x_int + m * xs[..., :-1, :]

    def metrics(self, xs, us):
        """(cost, foot constraint g [..., N, 12], defect sum of squares)."""
        r = self.robot
        lo = r.rate(xs[..., :-1, :], us, self.flags[:-1], self.z_ref[:-1], self.vz_ref[:-1])
        hi = r.rate(xs[..., 1:, :], us, self.flags[1:], self.z_ref[1:], self.vz_ref[1:])
        cost = torch.sum(0.5 * self.dts * (lo + hi), dim=-1)
        cost = cost + 0.5 * self.ar.quad(r.Qf, xs[..., -1, :] - r.x_target)
        g = r.residuals(xs[..., :-1, :], us, self.flags[:-1], self.z_ref[:-1],
                        self.vz_ref[:-1])[3]
        defects = self.next_states(xs, us) - xs[..., 1:, :]
        return cost, g, torch.sum(defects ** 2, dim=(-2, -1))

    def lq(self, xs, us):
        """The LQ model of every node of every scenario [B, N, ...]: dynamics
        A, B and defects b, the cost's Gauss-Newton quadratic scaled by the
        interval, the terminal quadratic, and the foot constraint's value
        and Jacobians C, D."""
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
        _, first, second = r.penalties(res[:, 0:4], res[:, 4:8], res[:, 8:12])
        jx_p, ju_p = jx[:, :12], ju[:, :12]
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
        return {
            "A": shape(a), "B": shape(b), "b": shape(f_next) - xs[:, 1:],
            "Qxx": shape(Qxx), "qx": shape(qx), "Quu": shape(Quu), "qu": shape(qu),
            "Qux": shape(Qux), "Qf": r.Qf.expand(batch, nx, nx),
            "qf": ar.mm(xn - r.x_target, r.Qf.T),
            "g": shape(res[:, 12:]), "C": shape(jx[:, 12:]), "D": shape(ju[:, 12:]),
        }


def project(ar: Arith, g, C, D):
    """du = p0 + Px dx + Pu v solves g + C dx + D du = 0 for every v: with
    D' = Q [R; 0] (LAPACK's complete QR), p0 = -Q1 R^-T g, Px = -Q1 R^-T C,
    Pu = Q2, an orthonormal basis of D's null space."""
    ne = D.shape[-2]
    dev = D.device
    q_full, r_full = torch.linalg.qr(D.transpose(-1, -2).cpu(), mode="complete")
    q_full, r_full = q_full.to(dev), r_full.to(dev)
    q1, pu = q_full[..., :ne], q_full[..., ne:]
    rhs = torch.cat([g.unsqueeze(-1), C], dim=-1)
    w = torch.linalg.solve_triangular(r_full[..., :ne, :].transpose(-1, -2), rhs, upper=False)
    dpinv = -ar.mm(q1, w)
    return dpinv[..., 0], dpinv[..., 1:], pu


def riccati(ar: Arith, c: dict, reg):
    """The discrete Riccati recursion of the reduced QP (matrix form, one
    batched Cholesky a node): gains [B, N, nv, nx], feedforward [B, N, nv],
    S [B, N+1, nx, nx], s [B, N+1, nx]."""
    batch, n, nv = c["B"].shape[0], c["B"].shape[1], c["B"].shape[-1]
    eye = torch.eye(nv, dtype=c["B"].dtype, device=c["B"].device)
    S, s = c["Qf"], c["qf"]
    gains, kffs, s_mats, s_vecs = [], [], [S], [s]
    for k in reversed(range(n)):
        a, bm = c["A"][:, k], c["B"][:, k]
        at, bt = a.transpose(-1, -2), bm.transpose(-1, -2)
        sv = s + ar.mv(S, c["b"][:, k])
        qu = c["qu"][:, k] + ar.mv(bt, sv)
        qx = c["qx"][:, k] + ar.mv(at, sv)
        sa, sb = ar.mm(S, a), ar.mm(S, bm)
        quu = c["Quu"][:, k] + ar.mm(bt, sb) + reg[:, None, None] * eye
        qux = c["Qux"][:, k] + ar.mm(bt, sa)
        qxx = c["Qxx"][:, k] + ar.mm(at, sa)
        z = -cholesky_solve(quu, torch.cat([qux, qu.unsqueeze(-1)], dim=-1))
        kk, kf = z[..., :-1], z[..., -1]
        kkt = kk.transpose(-1, -2)
        S = sym(qxx + ar.mm(kkt, ar.mm(quu, kk)) + ar.mm(kkt, qux) + ar.mm(qux.transpose(-1, -2), kk))
        s = qx + ar.mv(kkt, ar.mv(quu, kf)) + ar.mv(kkt, qu) + ar.mv(qux.transpose(-1, -2), kf)
        gains.append(kk)
        kffs.append(kf)
        s_mats.append(S)
        s_vecs.append(s)
    flip = lambda v: torch.stack(v[::-1], dim=1)  # noqa: E731
    return flip(gains), flip(kffs), flip(s_mats), flip(s_vecs)


def solve(cfg: dict, x0: Tensor, arith: Arith) -> dict:
    """SQP on the starts x0 [B, nx] from the shared cold start (every input
    the stand's weight-compensating forces, every state x0); returns xs, us,
    gains, value_S, value_s, iterations and merit, each with a leading [B]."""
    st = cfg["solver"]["settings"]
    ar = arith
    pb = _Problem(cfg, ar, x0.device)
    r = pb.robot
    f32 = dict(dtype=torch.float32, device=x0.device)
    batch, nx, nu, n = x0.shape[0], cfg["nx"], cfg["nu"], cfg["intervals"]
    rows = torch.arange(batch, device=x0.device)
    alphas = st["alpha_decay"] ** torch.arange(st["num_alphas"], **f32)
    eye_u = torch.eye(nu, **f32)

    xs = x0[:, None].expand(batch, n + 1, nx).contiguous()
    us = r.u_target.expand(batch, n, nu).contiguous()
    lmbd = torch.zeros((batch, n, 12), **f32)
    rho = torch.full((batch,), st["al_rho_init"], **f32)

    def merit_of(cost, g, lm, rh):
        return cost + torch.sum(-lm * g + 0.5 * rh[..., None, None] * g ** 2, dim=(-2, -1))

    cost, g, d_sse = pb.metrics(xs, us)
    merit = merit_of(cost, g, lmbd, rho)
    eq_sse = torch.sum(g ** 2, dim=(-2, -1))
    viol = torch.sqrt(eq_sse + d_sse)
    best_cviol = torch.sqrt(eq_sse)
    since_outer = torch.zeros(batch, dtype=torch.int32, device=x0.device)
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
        c = pb.lq(xs, us)
        c["Quu"] = c["Quu"] + st["hessian_reg"] * eye_u
        p0, px, pu = project(ar, c["g"], c["C"], c["D"])
        pxt, put = px.transpose(-1, -2), pu.transpose(-1, -2)
        quu_px = ar.mm(c["Quu"], px)
        qu_full = c["qu"] + ar.mv(c["Quu"], p0)
        red = {
            "A": c["A"] + ar.mm(c["B"], px), "B": ar.mm(c["B"], pu),
            "b": c["b"] + ar.mv(c["B"], p0),
            "Qxx": sym(c["Qxx"] + ar.mm(pxt, c["Qux"]) + ar.mm(c["Qux"].transpose(-1, -2), px)
                       + ar.mm(pxt, quu_px)),
            "qx": c["qx"] + ar.mv(pxt, qu_full) + ar.mv(c["Qux"].transpose(-1, -2), p0),
            "Quu": ar.mm(put, ar.mm(c["Quu"], pu)), "qu": ar.mv(put, qu_full),
            "Qux": ar.mm(put, c["Qux"] + quu_px), "Qf": c["Qf"], "qf": c["qf"],
        }
        kv, kffv, S, s = riccati(ar, red, reg)
        dx = torch.zeros((batch, nx), **f32)
        dxs, dvs = [dx], []
        for k in range(n):
            dv = kffv[:, k] + ar.mv(kv[:, k], dx)
            dx = ar.mv(red["A"][:, k], dx) + ar.mv(red["B"][:, k], dv) + red["b"][:, k]
            dxs.append(dx)
            dvs.append(dv)
        dxs, dvs = torch.stack(dxs, 1), torch.stack(dvs, 1)
        dus = p0 + ar.mv(px, dxs[:, :-1]) + ar.mv(pu, dvs)
        K = px + ar.mm(pu, kv)

        finite = torch.isfinite(dxs).all(dim=(1, 2)) & torch.isfinite(dus).all(dim=(1, 2))
        dxs = _where(finite, dxs, torch.zeros_like(dxs))
        dus = _where(finite, dus, torch.zeros_like(dus))

        a4 = alphas[None, :, None, None]
        xs_c, us_c = xs[:, None] + a4 * dxs[:, None], us[:, None] + a4 * dus[:, None]
        cost_c, g_c, d_c = pb.metrics(xs_c, us_c)
        merits = merit_of(cost_c, g_c, lmbd[:, None], rho[:, None])
        eq_c = torch.sum(g_c ** 2, dim=(-2, -1))
        viols = torch.sqrt(eq_c + d_c)
        slope = (torch.sum(c["qx"] * dxs[:, :-1], dim=(1, 2)) + torch.sum(c["qu"] * dus, dim=(1, 2))
                 + torch.sum(c["qf"] * dxs[:, -1], dim=1))
        m0, v0 = merit[:, None], viol[:, None]
        armijo = merits <= m0 + st["armijo_factor"] * alphas * slope[:, None]
        less_viol = viols < (1.0 - 1e-3) * v0
        accept = torch.where(
            v0 > st["g_max"], less_viol,
            torch.where((v0 < st["g_min"]) & (viols < st["g_min"]), armijo,
                        (merits < m0) | less_viol))
        accept = accept & finite[:, None]
        first = torch.argmax(accept.to(torch.int8), dim=1)
        any_ok = accept.any(dim=1)
        reg_n = torch.where(
            any_ok, torch.clamp(reg * st["reg_decrease"], min=st["reg_min"]),
            torch.clamp(torch.clamp(reg, min=st["reg_init"]) * st["reg_increase"],
                        max=st["reg_max"]))
        xs_n = _where(any_ok, xs_c[rows, first], xs)
        us_n = _where(any_ok, us_c[rows, first], us)
        g_n = g_c[rows, first]
        viol_n = torch.where(any_ok, viols[rows, first], viol)
        merit_n = torch.where(any_ok, merits[rows, first], merit)

        rel = torch.abs(merit - merit_n) / torch.clamp(torch.abs(merit), min=1e-12)
        inner = (any_ok & (rel < st["cost_tol"])) | ~any_ok
        outer_due = inner | (since_outer >= st["outer_update_every"])
        cviol_n = torch.sqrt(eq_c[rows, first])
        c_feasible = cviol_n < st["constraint_tol"]
        improved = (cviol_n <= 0.5 * best_cviol) | c_feasible
        lmbd_n = _where(outer_due & improved, lmbd - rho[:, None, None] * g_n, lmbd)
        rho_n = torch.where(outer_due & ~improved,
                            torch.clamp(rho * st["al_rho_growth"], max=st["al_rho_max"]), rho)
        best_n = torch.where(outer_due, torch.minimum(best_cviol, cviol_n), best_cviol)
        merit_carry = torch.where(any_ok, merit_of(cost_c[rows, first], g_n, lmbd_n, rho_n), merit)
        step = alphas[first]
        dx_rms = step * torch.sqrt(torch.mean(dxs ** 2, dim=(1, 2)))
        du_rms = step * torch.sqrt(torch.mean(dus ** 2, dim=(1, 2)))
        primal = any_ok & (dx_rms < st["delta_tol"]) & (du_rms < st["delta_tol"])
        done_n = ((primal & c_feasible) | (inner & any_ok & (viol_n < st["constraint_tol"]))
                  | (~any_ok & (reg >= st["reg_max"])))

        xs, us = _where(active, xs_n, xs), _where(active, us_n, us)
        lmbd, rho = _where(active, lmbd_n, lmbd), torch.where(active, rho_n, rho)
        merit, viol = torch.where(active, merit_carry, merit), torch.where(active, viol_n, viol)
        best_cviol = torch.where(active, best_n, best_cviol)
        since_outer = torch.where(active, torch.where(outer_due, 0, since_outer + 1), since_outer)
        reg = torch.where(active, reg_n, reg)
        done = torch.where(active, done_n, done)
        it = torch.where(active, it + 1, it)
        gains = _where(active, K, gains)
        value_S, value_s = _where(active, S, value_S), _where(active, s, value_s)

    cost, g, _ = pb.metrics(xs, us)
    return {
        "xs": xs, "us": us, "gains": gains, "value_S": value_S, "value_s": value_s,
        "iterations": it, "merit": merit_of(cost, g, lmbd, rho),
    }
