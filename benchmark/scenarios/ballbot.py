"""The ``ballbot`` configuration on the program: its problem built by the
program's own constructors, solved by ``ocs2_tpu_torch.solvers.ddp.solve``
with the configuration's settings, one batch of starts a call."""
from __future__ import annotations


class Scenario:
    """What the benchmark drives: ``solve(x0)`` on a batch of starts, and
    ``outputs(sol, rows)``, the answers of some scenarios of a solution."""

    def __init__(self, cfg: dict, device):
        import torch

        from ocs2_tpu_torch.models import ballbot
        from ocs2_tpu_torch.oc.time_discretization import uniform_grid
        from ocs2_tpu_torch.solvers import ddp

        self._ddp = ddp
        self.device = device
        self.problem = ballbot.make_problem(device=device)
        self.params = ballbot.make_params(device=device)
        self.grid = uniform_grid(0.0, cfg["horizon_s"], cfg["intervals"])
        self.settings = ddp.DdpSettings(**cfg["solver"]["settings"])
        self.nominal = torch.zeros(cfg["nx"], dtype=torch.float32, device=device)

    def solve(self, x0):
        return self._ddp.solve(self.problem, self.grid, x0, self.params,
                               settings=self.settings, device=self.device)

    @staticmethod
    def outputs(sol, rows) -> dict:
        return {
            "xs": sol.xs[rows], "us": sol.us[rows], "gains": sol.gains[rows],
            "value_S": sol.value_S[rows], "value_s": sol.value_s[rows],
            "iterations": sol.iterations[rows], "merit": sol.performance.merit[rows],
        }


def build(cfg: dict, device) -> Scenario:
    return Scenario(cfg, device)
