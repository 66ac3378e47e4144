"""``ocs2_tpu_torch/entry.py`` vs the repository's ``__graft_entry__.py``, on
the CPU.

``entry()``'s step (the flagship legged-robot trot SQP solve at N = 32)
against the JAX package's jitted step, stored by
``tools/torch_test_records.py --record test_torch_entry`` with the
iterations of the same solve: iterations equal, ``xs`` / ``us`` within
1e-3 + 1e-4 |value| (as ``tests/test_torch_sqp.py`` holds the trot), the cost
within 1e-5 relative.  ``dryrun_multichip(2)`` on two CPU shards, and on two
entries that name the CPU differently, runs to its end with finite results.
"""
import jax
import numpy as np
import pytest
import torch

from ocs2_tpu_torch import entry
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.


def _jax_entry():
    """The step of ``__graft_entry__.entry()``, jitted, and the same
    solve's iterations (its step returns none), from the same construction."""
    import __graft_entry__ as graft
    from ocs2_tpu.models.legged_robot import interface, model
    from ocs2_tpu.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu.oc.time_discretization import make_time_grid
    from ocs2_tpu.solvers import sqp

    step, (x0,) = graft.entry()
    xs, us, cost = jax.jit(step)(x0)
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, 1.0)
    grid = make_time_grid(0.0, 1.0, 32, event_times=np.asarray(ms.event_times),
                          mode_sequence=np.asarray(ms.mode_sequence))
    u0 = model.weight_compensating_input(jax.numpy.ones(4))
    sol = jax.jit(lambda x: sqp.solve(
        interface.make_problem(), grid, x, interface.make_params(grid),
        us_init=jax.numpy.tile(u0[None], (32, 1)),
        settings=sqp.SqpSettings(max_iterations=10, integrator="rk2")))(x0)
    np.testing.assert_allclose(np.asarray(sol.xs), np.asarray(xs), atol=1e-6)
    return dict(x0=x0, xs=xs, us=us, cost=cost, iterations=sol.iterations)


JAX_RECORDS = {"entry_step": _jax_entry}
RECORDS = Records(__file__)


def test_entry_step_matches_the_reference(monkeypatch):
    from ocs2_tpu_torch.solvers import sqp

    rec = RECORDS["entry_step"]
    step, (x0,) = entry.entry(device="cpu")
    np.testing.assert_array_equal(x0.numpy(), rec["x0"])
    solutions, solve = [], sqp.solve

    def solve_and_keep(*args, **kwargs):
        solutions.append(solve(*args, **kwargs))
        return solutions[-1]

    monkeypatch.setattr(sqp, "solve", solve_and_keep)
    xs, us, cost = step(x0)
    assert xs.shape == (33, 24) and us.shape == (32, 24) and cost.shape == ()
    assert len(solutions) == 1 and int(solutions[0].iterations[0]) == int(rec["iterations"])
    np.testing.assert_allclose(xs.numpy(), rec["xs"], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(us.numpy(), rec["us"], atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(float(cost), float(rec["cost"]), rtol=1e-5)


@pytest.mark.parametrize("devices", [["cpu"] * 2, ["cpu:0", "cpu:1"]], ids=["one", "two"])
def test_dryrun_multichip_runs_to_its_end(devices):
    out = entry.dryrun_multichip(2, devices=devices)
    assert out["scenario_cost"].shape == (4,) and bool(torch.isfinite(out["scenario_cost"]).all())
    assert out["qp_dxs"].shape == (1, 9, 6) and float(out["qp_residual"][0]) < 1.0
    assert out["sqp"].xs.shape == (1, 5, 10) and int(out["sqp"].iterations[0]) >= 1
    with pytest.raises(AssertionError, match="need 3 devices"):
        entry.dryrun_multichip(3, devices=devices)
