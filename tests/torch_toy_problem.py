"""A small constrained problem written twice — for the JAX package (one
sample per call) and for the port (batch-polymorphic) — so that tests can
hold the generic constraint / augmented-Lagrangian code of both against each
other.  nx = 2, nu = 1: a damped pendulum with one state-input equality, one
state-input inequality, one state-only inequality and one terminal equality,
a quadratic tracking cost and one plain (AD-quadratized) cost term.  With
``nu=2`` a second input pushes on the same state: the equality's input
Jacobian [1, 0.3] then has a one-dimensional null space, which the nu = 1
problem lacks, so the projected SQP route has something left to optimize."""
import jax.numpy as jnp
import numpy as np
import torch

NX, NU = 2, 1
Q = np.diag(np.float32([2.0, 0.5]))
R = np.diag(np.float32([0.3]))
R2 = np.diag(np.float32([0.3, 0.6]))
QF = np.diag(np.float32([4.0, 1.0]))


def _target_inputs(nu):
    return [[0.0] * nu, [0.1] + [0.0] * (nu - 1)]


def jax_problem(nu=NU):
    from ocs2_tpu.oc.problem import OptimalControlProblem, quadratic_cost, quadratic_final_cost

    # The second input's coefficient: 0 drops it from a term.
    w = 1.0 if nu == 2 else 0.0

    def dynamics(t, x, u, p):
        return jnp.stack([x[1], -jnp.sin(x[0]) - 0.1 * x[1] + u[0] + 0.5 * w * u[-1]])

    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(quadratic_cost(Q, R if nu == 1 else R2),
                    lambda t, x, u, p: 0.1 * jnp.cos(x[0]) * u[0] ** 2),
        final_cost_terms=(quadratic_final_cost(QF),),
        equality_terms=(lambda t, x, u, p: u[0] + 0.3 * w * u[-1] + 0.5 * x[0] - 0.1 * t,),
        inequality_terms=(lambda t, x, u, p: jnp.stack([1.5 - u[0] - x[1]]),),
        state_inequality_terms=(lambda t, x, p: jnp.stack([0.8 - x[1] ** 2]),),
        final_equality_terms=(lambda t, x, p: jnp.stack([x[0] + x[1]]),),
        nx=NX, nu=nu,
    )


def jax_params(nu=NU):
    from ocs2_tpu.core.reference import TargetTrajectories

    return {"target": TargetTrajectories.create(
        [0.0, 1.0], [[0.0, 0.0], [0.5, 0.0]], _target_inputs(nu))}


def torch_problem(nu=NU):
    from ocs2_tpu_torch.oc.problem import (
        OptimalControlProblem, quadratic_cost, quadratic_final_cost)

    w = 1.0 if nu == 2 else 0.0

    def dynamics(t, x, u, p):
        x0, x1, u0, u1 = x[..., 0:1], x[..., 1:2], u[..., 0:1], u[..., -1:]
        return torch.cat([x1, -torch.sin(x0) - 0.1 * x1 + u0 + 0.5 * w * u1], dim=-1)

    return OptimalControlProblem(
        dynamics=dynamics,
        cost_terms=(
            quadratic_cost(Q, R if nu == 1 else R2, device="cpu"),
            lambda t, x, u, p: 0.1 * torch.cos(x[..., 0]) * u[..., 0] ** 2,
        ),
        final_cost_terms=(quadratic_final_cost(QF, device="cpu"),),
        # One scalar per sample: the problem turns it into one row.
        equality_terms=(
            lambda t, x, u, p: u[..., 0] + 0.3 * w * u[..., -1] + 0.5 * x[..., 0] - 0.1 * t,),
        inequality_terms=(lambda t, x, u, p: 1.5 - u[..., 0:1] - x[..., 1:2],),
        state_inequality_terms=(lambda t, x, p: 0.8 - x[..., 1:2] ** 2,),
        final_equality_terms=(lambda t, x, p: x[..., 0:1] + x[..., 1:2],),
        nx=NX, nu=nu,
    )


def torch_params(nu=NU):
    from ocs2_tpu_torch.core.reference import TargetTrajectories

    return {"target": TargetTrajectories.create(
        [0.0, 1.0], [[0.0, 0.0], [0.5, 0.0]], _target_inputs(nu), device="cpu")}


def random_al_numpy(batch, n, rng):
    """AL state with random multipliers, leaves [B, ...], as numpy."""
    r = lambda *s: rng.uniform(0.0, 1.0, (batch,) + s).astype(np.float32)  # noqa: E731
    return dict(
        lmbd_eq=r(n, 1), lmbd_state_eq=np.zeros((batch, n + 1, 0), np.float32),
        lmbd_ineq=r(n, 1), lmbd_state_ineq=r(n + 1, 1), lmbd_final_eq=r(1),
        rho=rng.uniform(5.0, 20.0, (batch,)).astype(np.float32),
    )
