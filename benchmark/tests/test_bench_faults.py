"""A run on the CPU with the timed path broken underneath comes out not
correct, once for each fault a solver cell can have: a solve whose
iterations return the state unchanged, half of the batch left out (its rows
answered by the other half's), an answer altered where it is produced, and
the same in a block of a sixteenth of the rows only.
(No cell spans chips, so there is no exchange between chips to leave out.)"""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

import run
from harness.spec import load_module
from helpers import CELLS, cpu_cell



class Broken:
    """The cell's scenario with one fault in its solve."""

    def __init__(self, inner, fault: str):
        self.inner, self.fault = inner, fault
        self.nominal, self.outputs = inner.nominal, inner.outputs
        if fault == "unchanged":
            inner.settings = dataclasses.replace(inner.settings, max_iterations=0)

    def solve(self, x0):
        if self.fault == "half_batch":
            half = x0.shape[0] // 2
            sol = self.inner.solve(x0[:half])
            idx = torch.arange(x0.shape[0]) % half
            return SimpleNamespace(
                xs=sol.xs[idx], us=sol.us[idx], gains=sol.gains[idx],
                value_S=sol.value_S[idx], value_s=sol.value_s[idx],
                iterations=sol.iterations[idx],
                performance=SimpleNamespace(merit=sol.performance.merit[idx]))
        sol = self.inner.solve(x0)
        if self.fault == "altered":
            return sol._replace(xs=sol.xs * 1.01)
        if self.fault == "block_altered":
            block = torch.arange(x0.shape[0], device=x0.device) < max(1, x0.shape[0] // 16)
            return sol._replace(xs=torch.where(block[:, None, None], sol.xs * 1.01, sol.xs))
        return sol


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "block_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    cell = cpu_cell(name)
    module = load_module("scenarios", cell.config["name"])
    out = run.run_cell(cell, 2 ** 31 + 1, 0.0, False, device="cpu",
                       build_scenario=lambda cfg, dev: Broken(module.build(cfg, dev), fault))
    assert out["correct"] is False, out["checks"]
