"""K10's side of the legged SRBD problem: what the kernel computes, read from
the problem's terms and the model, and the per-node inputs it is handed.

``interface.make_problem`` attaches an ``SrbdLqKernel`` to the problem it
builds with the SRBD model, the soft friction cone and the projected foot
constraint (``OptimalControlProblem.lq_kernel``); ``oc/approx.approximate_lq``
hands it a call only where ``kernel_takes`` holds.  The weights and
constants come from the term objects (the tracking weights Q and R, the
terminal weight, the penalties' parameters) and from ``model.py`` /
``constraints.py``; the kernel (``csrc/lq_srbd.cu``) holds none of them.
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
    """K10 for one problem: the terms it computes and their constants."""

    method = lq_srbd_cuda.METHOD

    def __init__(self, problem):
        track, velocity, cone = problem.cost_terms
        (height,) = problem.state_cost_terms
        (final,) = problem.final_cost_terms
        (velocity_scale,) = _penalty_form(velocity, con.swing_normal_velocity, "quadratic")
        barrier_mu, barrier_delta = _penalty_form(cone, con.friction_cone, "relaxed_barrier")
        (height_scale,) = _penalty_form(height, con._swing_height_error, "quadratic")
        if (problem.equality_terms != (con.foot_constraint,)
                or problem.dynamics is not model.dynamics):
            raise ValueError("the SRBD LQ kernel takes the SRBD model's projected foot constraint")
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
        launch of K10."""
        grid = grid.device(xs.device)
        r = lq_srbd_cuda.lq_srbd_cuda(
            xs.contiguous(), us.contiguous(), self.node_inputs(grid, params),
            self.weights, self.constants)
        return LQData(
            cost=ScalarQuadraticApproximation(
                f=r.cost_f, dfdx=r.cost_dfdx, dfdu=r.cost_dfdu, dfdxx=r.cost_dfdxx,
                dfdux=r.cost_dfdux, dfduu=r.cost_dfduu),
            dynamics=DiscreteTransition(f=r.dyn_f, dfdx=r.dyn_dfdx, dfdu=r.dyn_dfdu),
            eq=VectorLinearApproximation(f=r.eq_f, dfdx=r.eq_dfdx, dfdu=r.eq_dfdu),
            state_eq=None, ineq=None, state_ineq=None, final_eq=None,
        )


def _same(a, b) -> bool:
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(x is y for x, y in zip(a, b))
    return a is b

