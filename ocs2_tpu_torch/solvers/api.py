"""Unified solver interface — the object-style facade over the solvers.

Counterpart of ``ocs2_tpu/solvers/api.py``: algorithm selection by name,
initializer plumbing, last-solution state, and the value-function /
Hamiltonian query surface (``oc/queries.py``).  The solvers return every
field with a leading scenario dim; the queries read one scenario
(``scenario=0`` unless asked).

``"sqp"``, ``"ipm"``, ``"slp"``, ``"ilqr"`` and ``"slq"`` are available (the
last two are ``solvers/ddp.py`` with the discrete or the continuous-time
Riccati sweep).  PIPG (SLP) computes no value function: the queries of an SLP
solve read NaN.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..oc.initialization import DefaultInitializer, Initializer
from ..oc.problem import OptimalControlProblem
from ..oc.queries import hamiltonian, hamiltonian_approx, value_function
from ..oc.time_discretization import TimeGrid
from . import ddp as _ddp
from . import ipm as _ipm
from . import slp as _slp
from . import sqp as _sqp

Tensor = torch.Tensor

ALGORITHMS = {
    "sqp": _sqp.SqpSettings,
    "ipm": _ipm.IpmSettings,
    "slp": _slp.SlpSettings,
    "ilqr": _ddp.DdpSettings,
    "slq": _ddp.DdpSettings,
}
_MULTIPLE_SHOOTING = {"sqp": _sqp.solve, "ipm": _ipm.solve, "slp": _slp.solve}


class Solver:
    """Object-style solver with a value-function / Hamiltonian query surface.

    >>> solver = Solver(problem, algorithm="sqp", device="cpu")
    >>> sol = solver.run(grid, x0, params)
    >>> V = solver.get_value_function(t, x)
    >>> H = solver.get_hamiltonian(t, x, u)
    """

    def __init__(
        self,
        problem: OptimalControlProblem,
        algorithm: str = "sqp",
        settings: Optional[Any] = None,
        initializer: Optional[Initializer] = None,
        device="cuda",
    ):
        if algorithm not in ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {algorithm!r}; one of {sorted(ALGORITHMS)}"
            )
        self.problem = problem
        self.algorithm = algorithm
        if settings is None:
            settings = ALGORITHMS[algorithm]()
        if algorithm in ("ilqr", "slq"):
            settings = dataclasses.replace(settings, algorithm=algorithm)
        self.settings = settings
        self.initializer = initializer or DefaultInitializer()
        self.device = device
        self._last = None  # (grid, sol, params)

    def run(self, grid: TimeGrid, x0, params: dict, xs_init=None, us_init=None):
        """Solve from x0 ([nx], or [B, nx] with shared initial guesses)."""
        x0 = torch.as_tensor(x0, dtype=torch.float32, device=self.device)
        if xs_init is None or us_init is None:
            xs0, us0 = self.initializer(grid, x0.reshape(-1, x0.shape[-1])[0], self.problem.nu)
            xs_init = xs0 if xs_init is None else xs_init
            us_init = us0 if us_init is None else us_init
        if self.algorithm in ("ilqr", "slq"):
            sol = _ddp.solve(
                self.problem, grid, x0.reshape(-1, x0.shape[-1]), params,
                us_init=us_init, settings=self.settings, device=self.device,
            )
        else:
            sol = _MULTIPLE_SHOOTING[self.algorithm](
                self.problem, grid, x0, params, xs_init=xs_init, us_init=us_init,
                settings=self.settings, device=self.device,
            )
        self._last = (grid, sol, params)
        return sol

    # -- solution getters -----------------------------------------------------
    @property
    def last_solution(self):
        return self._require()[1]

    def primal_solution(self):
        """(times, xs, us, gains) of the last solve."""
        grid, sol, _ = self._require()
        return grid.times, sol.xs, sol.us, sol.gains

    def performance_indices(self):
        return self._require()[1].performance

    def _require(self):
        assert self._last is not None, "run() first"
        return self._last

    # -- value-function / Hamiltonian queries ---------------------------------
    def get_value_function(self, t, x, scenario: int = 0):
        grid, sol, _ = self._require()
        return value_function(
            grid, sol.xs[scenario], sol.value_S[scenario], sol.value_s[scenario], t, x)

    def get_hamiltonian(self, t, x, u, quadratic: bool = False, scenario: int = 0):
        grid, sol, params = self._require()
        fn = hamiltonian_approx if quadratic else hamiltonian
        return fn(
            self.problem, grid, sol.xs[scenario], sol.value_S[scenario],
            sol.value_s[scenario], t, x, u, params,
        )
