"""K10's side of the legged SRBD problem: what the kernel computes, read from
the problem's terms and the model, and the per-node inputs it is handed.

``interface.make_problem`` attaches an ``SrbdLqKernel`` to the problem it
builds with the SRBD model and the projected foot constraint
(``OptimalControlProblem.lq_kernel``); ``oc/approx.approximate_lq`` hands it
a call only where ``kernel_takes`` holds.  The kernel's variant follows the
problem's friction cone, read from its terms:

* soft, a relaxed-barrier cost term: K10 writes the cost with the barrier,
  the dynamics and the foot constraint (``ineq`` None);
* hard, the inequality ``constraints.friction_cone`` (no barrier in the
  cost): K10 writes the cost without it, the dynamics, the foot constraint
  and the cone's linearization as ``ineq`` (f [B, N, 4], dfdu [B, N, 4, 24]
  and dfdx [B, N, 4, 24] of exact zeros), which ``solvers/ipm`` condenses.
  At (4096, 100) these add 2 x 157 MB and 6.6 MB to the soft variant's
  5.91 GB of traffic: a bytes bound of about 1.86 ms for 1.76.

The weights and constants come from the term objects (the tracking weights Q
and R, the terminal weight, the penalties' parameters) and from ``model.py``
/ ``constraints.py``; the kernel (``csrc/lq_srbd.cu``) holds none of them.
"""
from __future__ import annotations

import torch

from ...core.integrate import DiscreteTransition
from ...core.interpolation import interpolate_batch
from ...core.types import ScalarQuadraticApproximation, VectorLinearApproximation
from ...oc.approx import LQData
from ...ops import lq_srbd_cuda
from . import constraints as con
from . import model

_FIELDS = (
    "dynamics", "cost_terms", "state_cost_terms", "final_cost_terms", "pre_jump_cost_terms",
    "equality_terms", "state_equality_terms", "inequality_terms", "state_inequality_terms",
    "final_equality_terms", "jump_map",
)


def _penalty_form(term, g_fn, name: str) -> tuple:
    if getattr(term, "g_fn", None) is not g_fn or term.penalty.form[0] != name:
        raise ValueError(f"the SRBD LQ kernel has no form for the term {term!r}")
    return term.penalty.form[1:]


class SrbdLqKernel:
    """K10 for one problem: the terms it computes, their constants, and the
    variant ("soft" or "hard") that the problem's friction cone asks for."""

    method = lq_srbd_cuda.METHOD

    def __init__(self, problem):
        track, velocity, *soft_cone = problem.cost_terms
        (height,) = problem.state_cost_terms
        (final,) = problem.final_cost_terms
        (velocity_scale,) = _penalty_form(velocity, con.swing_normal_velocity, "quadratic")
        (height_scale,) = _penalty_form(height, con._swing_height_error, "quadratic")
        if soft_cone:  # a relaxed barrier in the cost
            (cone,) = soft_cone
            barrier_mu, barrier_delta = _penalty_form(cone, con.friction_cone, "relaxed_barrier")
            self.variant, inequalities = "soft", ()
        else:  # an inequality; the kernel reads no barrier constant
            barrier_mu = barrier_delta = float("nan")
            self.variant, inequalities = "hard", (con.friction_cone,)
        if (problem.equality_terms != (con.foot_constraint,)
                or problem.dynamics is not model.dynamics):
            raise ValueError("the SRBD LQ kernel takes the SRBD model's projected foot constraint")
        if problem.inequality_terms != inequalities:
            raise ValueError("the SRBD LQ kernel takes the friction cone either as a cost term "
                             "or as the only inequality")
        self._terms = tuple(getattr(problem, f) for f in _FIELDS)
        self.weights = lq_srbd_cuda.Weights(track.Q, track.R, final.Qf)
        self.target_key = track.target_key
        self.final_target_key = final.target_key
        lateral = [model.leg_side_sign(leg) * model.HIP_LATERAL for leg in range(model.NUM_LEGS)]
        self.constants = tuple(float(v) for v in (
            model.MASS, 0.0, 0.0, model.GRAVITY, *model.INERTIA, *model.HIP_OFFSETS.reshape(-1),
            *lateral, model.THIGH_LENGTH, model.SHANK_LENGTH, model.EULER_RATE_COS_FLOOR,
            con.FRICTION_MU, con.CONE_EPS, barrier_mu, barrier_delta, height_scale,
            velocity_scale,
        ))

    def computes(self, problem) -> bool:
        """Whether ``problem`` has exactly the terms this kernel was made for."""
        return (problem.nx, problem.nu) == (model.NX, model.NU) and all(
            _same(getattr(problem, f), mine) for f, mine in zip(_FIELDS, self._terms))

    def node_inputs(self, grid, params) -> lq_srbd_cuda.NodeInputs:
        """The per-node inputs of ``grid`` (a TimeGrid of tensors), shared by
        every scenario: the targets evaluated once for all nodes."""
        n = grid.num_intervals
        times = grid.times
        track, final = params[self.target_key], params[self.final_target_key]
        x_ref = torch.cat([interpolate_batch(track.times, track.states, times[:n]),
                           interpolate_batch(final.times, final.states, times[n:])])
        return lq_srbd_cuda.NodeInputs(
            dt=(times[1:] - times[:-1]).contiguous(),
            is_jump=grid.is_jump.contiguous(),
            modes=grid.modes[:n].to(torch.int32),
            swing_z=params["swing_z"][:n].contiguous(),
            swing_vz=params["swing_vz"][:n].contiguous(),
            x_ref=x_ref.contiguous(),
            u_ref=interpolate_batch(track.times, track.inputs, times[:n]).contiguous(),
        )

    def approximate(self, grid, xs, us, params):
        """``approximate_lq``'s LQData of the batch (rk2 in one step), by one
        launch of K10's variant."""
        grid = grid.device(xs.device)
        hard = self.variant == "hard"
        r = lq_srbd_cuda.lq_srbd_cuda(
            xs.contiguous(), us.contiguous(), self.node_inputs(grid, params),
            self.weights, self.constants, hard_cone=hard)
        ineq = (VectorLinearApproximation(f=r.ineq_f, dfdx=r.ineq_dfdx, dfdu=r.ineq_dfdu)
                if hard else None)
        return LQData(
            cost=ScalarQuadraticApproximation(
                f=r.cost_f, dfdx=r.cost_dfdx, dfdu=r.cost_dfdu, dfdxx=r.cost_dfdxx,
                dfdux=r.cost_dfdux, dfduu=r.cost_dfduu),
            dynamics=DiscreteTransition(f=r.dyn_f, dfdx=r.dyn_dfdx, dfdu=r.dyn_dfdu),
            eq=VectorLinearApproximation(f=r.eq_f, dfdx=r.eq_dfdx, dfdu=r.eq_dfdu),
            state_eq=None, ineq=ineq, state_ineq=None, final_eq=None,
        )


def _same(a, b) -> bool:
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(x is y for x, y in zip(a, b))
    return a is b

