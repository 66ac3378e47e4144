"""The benchmark's ``legged-ipm-b4096`` cell on the CPU at a small size:
``ipm.solve`` on the legged problem with the hard friction cone against the
cell's plain reference (``benchmark/reference/legged_srbd_trot_ipm.py``),
judged by the rule and the limits that decide ``correct`` on the card
(``benchmark/checks/legged-ipm-b4096.json``); the reference with its matrix
products in TF32 failing that rule; and the phase spans of ``ipm.solve``
(``utils/timers.SPANS``): one of each of the eight phases an iteration, in
order, tiling the loop, nothing recorded while recording is off, and the
answers unchanged to the bit.

The configuration's widths, gait, costs and settings, 4 starts from the
cell's traffic generator (the stand + 1e-3 N(0, 1) per state) and N = 30 in
place of the cell's 100, so that the file runs in seconds.
"""
import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parent.parent / "benchmark"
if str(BENCH_DIR) not in sys.path:
    sys.path.append(str(BENCH_DIR))

from harness import compare, starts  # noqa: E402
from harness.spec import load_module, read_json  # noqa: E402
from reference import legged_srbd_trot_ipm as reference  # noqa: E402
from reference.arith import Arith  # noqa: E402

from ocs2_tpu_torch.utils import timers  # noqa: E402

torch.set_num_threads(1)  # one intra-op thread a test process, as the other port tests

CELL = "legged-ipm-b4096"
BATCH, N = 4, 30
SEEDS = (2 ** 31 + 11, 3 ** 20)
PHASES = ("ipm.host_read", "ipm.approx", "ipm.condense", "ipm.projection", "ipm.riccati",
          "ipm.forward", "ipm.line_search", "ipm.update")
SOLUTION_FIELDS = ("xs", "us", "gains", "value_S", "value_s")


def _config() -> dict:
    cfg = read_json(BENCH_DIR / "configs" / "legged_srbd_trot_ipm.json")
    return dict(cfg, intervals=N)


CFG = _config()
LIMITS = read_json(BENCH_DIR / "checks" / f"{CELL}.json")["limits"]
TRAFFIC = read_json(BENCH_DIR / "traffic" / "closed-b4096-scale1e-3.json")


@pytest.fixture(scope="module")
def scenario():
    return load_module("scenarios", CFG["name"]).build(CFG, "cpu")


def _starts(scenario, seed):
    traffic = dict(TRAFFIC, batch=BATCH, pool_batches=1)
    return starts.draw(traffic, scenario.nominal, seed).batch(0)


@pytest.fixture(scope="module", params=SEEDS)
def solved(request, scenario):
    """(starts, the program's answers with recording off, the solution with
    recording on, its span records, host and device aggregates)."""
    x0 = _starts(scenario, request.param)
    timers.SPANS.reset()
    off = scenario.solve(x0)
    assert timers.SPANS.last_solve == [] and timers.SPANS.timers("host") == {}
    with timers.recording():
        on = scenario.solve(x0)
    records = list(timers.SPANS.last_solve)
    host, device = timers.SPANS.timers("host"), timers.SPANS.timers("device")
    timers.SPANS.reset()
    return x0, off, on, records, host, device


def _answers(scenario, sol):
    return scenario.outputs(sol, torch.arange(BATCH))


def test_program_agrees_with_the_reference(scenario, solved):
    x0, off, *_ = solved
    values = compare.numbers(_answers(scenario, off), reference.solve(CFG, x0, Arith(tf32=False)))
    correct, checks = compare.judge(values, LIMITS)
    assert correct, checks
    assert values["sampled"] == BATCH


def test_the_tf32_control_fails(scenario):
    x0 = _starts(scenario, SEEDS[0])
    fp32 = reference.solve(CFG, x0, Arith(tf32=False))
    tf32 = reference.solve(CFG, x0, Arith(tf32=True))
    correct, checks = compare.judge(compare.numbers(tf32, fp32), LIMITS)
    assert not correct, checks


def test_the_reference_refuses_what_it_does_not_compute():
    settings = dict(CFG["solver"]["settings"], convexify=True)
    with pytest.raises(ValueError):
        reference.solve(dict(CFG, solver=dict(CFG["solver"], settings=settings)),
                        torch.zeros((1, CFG["nx"])), Arith())
    with pytest.raises(ValueError):
        reference.solve(dict(CFG, friction_cone="soft"), torch.zeros((1, CFG["nx"])), Arith())


def test_phases_tile_each_iteration_in_order(solved):
    _, _, on, records, host, device = solved
    iterations = int(on.iterations.max())
    assert [r.name for r in records] == list(PHASES) * iterations
    assert [r.iteration for r in records] == [i for i in range(iterations) for _ in PHASES]
    assert len({r.solve for r in records}) == 1 and {r.parent for r in records} == {"ipm.solve"}
    for a, b in zip(records, records[1:]):
        assert a.host_start_ns <= a.host_end_ns == b.host_start_ns
    # On the CPU the host interval stands in for the device's.
    assert all(r.device_s == (r.host_end_ns - r.host_start_ns) * 1e-9 for r in records)
    for clock in (host, device):
        assert set(clock) == set(PHASES)
        # One of each phase, the host read among them, an iteration.
        assert all(t.count == iterations and t.total > 0 for t in clock.values())


def test_recording_leaves_the_answers_bitwise_equal(solved):
    _, off, on, *_ = solved
    for f in SOLUTION_FIELDS:
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    assert torch.equal(off.iterations, on.iterations)
    assert torch.equal(off.ipm.slack_ineq, on.ipm.slack_ineq)
    assert torch.equal(off.performance.merit, on.performance.merit)


def test_recording_off_opens_no_range(scenario, monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    timers.SPANS.reset()
    assert not timers.SPANS.is_recording()
    sol = scenario.solve(_starts(scenario, SEEDS[1]))
    assert int(sol.iterations.max()) >= 1
    assert opened == []
    assert timers.SPANS.last_solve == [] and timers.SPANS.timers("device") == {}
