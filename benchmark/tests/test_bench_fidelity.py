"""The plain references against the program on the CPU, at the full widths,
N and iteration budgets and a small batch, judged by the rule and the limits
that decide ``correct`` on the card; and the control, each reference with
its matrix products in TF32, failing that rule."""
import pytest
import torch

import run
from harness import compare, starts
from harness.spec import load_module
from helpers import CELLS, cpu_cell
from reference.arith import Arith



@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_the_reference(name):
    out = run.run_cell(cpu_cell(name), 2 ** 31 + 99, 0.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert out["window"]["compared"]["sampled"] == cpu_cell(name).traffic["batch"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = cpu_cell(name)
    cfg = cell.config
    nominal = load_module("scenarios", cfg["name"]).build(cfg, "cpu").nominal
    x0 = starts.draw(cell.traffic, nominal, 2 ** 31 + 5).batch(0)
    ref = __import__(f"reference.{cfg['name']}", fromlist=["solve"])
    fp32 = ref.solve(cfg, x0, Arith(tf32=False))
    tf32 = ref.solve(cfg, x0, Arith(tf32=True))
    correct, checks = compare.judge(compare.numbers(tf32, fp32), cell.checks)
    assert not correct, checks


def test_tf32_rounding():
    from reference.arith import to_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -12, 1.0 + 2 ** -9, -3.0, float("inf"), 0.0])
    y = to_tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 2 ** -9, -3.0]
    assert y[4] == float("inf") and y[5] == 0.0
    a = torch.randn(64, 64)
    rel = ((to_tf32(a) - a).abs() / a.abs()).max()
    assert 0 < rel <= 2 ** -11
