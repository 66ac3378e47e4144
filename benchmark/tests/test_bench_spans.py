"""The legged cell's traced run on the CPU reads the program's phase spans:
the seven span metrics are in the line, the six device phases tile the
traced window's loop, and the idle gaps are named by the spans."""
import math

import pytest

import run
from harness import trace
from helpers import cpu_cell

CELL = "legged-sqp-b4096"
SPAN_METRICS = ("host_wait_ms", "approx_ms", "projection_ms", "riccati_ms", "forward_ms",
                "line_search_ms", "update_ms")
DEVICE_PHASES = SPAN_METRICS[1:]


@pytest.fixture(scope="module")
def traced():
    """The traced run's line and the traced window (``harness.trace.Trace``)."""
    from ocs2_tpu_torch.utils import timers

    timers.SPANS.reset()
    windows, real = [], trace.run

    def keep(*args, **kwargs):
        windows.append(real(*args, **kwargs))
        return windows[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(trace, "run", keep)
    try:
        out = run.run_cell(cpu_cell(CELL, 2), 2 ** 31 + 17, 0.0, True, device="cpu")
    finally:
        mp.undo()
    timers.SPANS.reset()
    return out, windows[0]


def test_the_line_reports_the_span_metrics(traced):
    out, _ = traced
    assert out["correct"], out["checks"]
    for name in SPAN_METRICS:
        value = out["metrics"][name]
        assert value["unit"] == "ms/iter"
        assert math.isfinite(value["value"]) and value["value"] > 0, name


def test_the_device_phases_cover_the_traced_window(traced):
    out, window = traced
    loop_s = 1e-3 * window.iterations_run * sum(out["metrics"][m]["value"] for m in DEVICE_PHASES)
    assert 0.9 <= loop_s / window.window_s <= 1.0


def test_the_idle_gaps_are_named_by_the_spans(traced):
    # On the CPU the device never runs: the window is one gap, named by the
    # span open at its middle.
    out, _ = traced
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps and all(name.startswith("sqp.") for name, _ in gaps)


def test_the_readers_find_nothing_where_nothing_was_recorded(monkeypatch):
    import sys
    import types

    from harness.spec import load_module

    from ocs2_tpu_torch.utils import timers

    timers.SPANS.reset()
    readers = [load_module("metrics", name) for name in SPAN_METRICS]
    assert all(r.read(None) is None for r in readers)
    # A program without the recorder.
    monkeypatch.setitem(sys.modules, "ocs2_tpu_torch.utils.timers", types.ModuleType("timers"))
    assert all(r.read(None) is None for r in readers)
