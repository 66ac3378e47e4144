"""The ``legged_srbd_trot_ipm`` configuration on the program: the SRBD
legged problem of ``models/legged_robot`` with the friction cone a hard
inequality, the trot's mode schedule, grid and swing references made by the
program's own gait machinery, solved by ``ocs2_tpu_torch.solvers.ipm.solve``
with the configuration's settings from the shared cold start (every input
the stand's weight-compensating forces, every state the start), one batch of
starts a call."""
from __future__ import annotations

import numpy as np


class Scenario:
    def __init__(self, cfg: dict, device):
        from ocs2_tpu_torch.models.legged_robot import interface, model
        from ocs2_tpu_torch.models.legged_robot.gait import (
            GaitSchedule,
            ModeSequenceTemplate,
        )
        from ocs2_tpu_torch.oc.time_discretization import make_time_grid
        from ocs2_tpu_torch.solvers import ipm

        self._ipm = ipm
        self.device = device
        gait = cfg["gait"]
        template = ModeSequenceTemplate(
            tuple(gait["switching_times_in_cycle"]) + (gait["cycle_s"],), tuple(gait["modes"]))
        ms = GaitSchedule(template).mode_schedule(0.0, cfg["horizon_s"])
        self.grid = make_time_grid(0.0, cfg["horizon_s"], cfg["intervals"],
                                   event_times=ms.event_times, mode_sequence=ms.mode_sequence)
        self.problem = interface.make_problem(friction_cone=cfg["friction_cone"], device=device)
        self.params = interface.make_params(
            self.grid, swing_height=cfg["cost"]["swing_height_m"], device=device)
        u0 = model.weight_compensating_input(np.ones(4, np.float32), device)
        self.us_init = u0[None].expand(cfg["intervals"], cfg["nu"]).contiguous()
        self.settings = ipm.IpmSettings(**cfg["solver"]["settings"])
        self.nominal = model.default_state(device)

    def solve(self, x0):
        return self._ipm.solve(self.problem, self.grid, x0, self.params, us_init=self.us_init,
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
