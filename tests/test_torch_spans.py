"""The phase spans of ``solvers/sqp.solve`` (``utils/timers.SpanRecorder``)
on the CPU: nothing recorded while recording is off; with it on, one span of
each phase an iteration, in order, under one solve id; the ranges on the
profiler's timeline; the solve's answers unchanged to the bit; and the CUDA
events' bookkeeping (read only once completed, reused from a pool),
rehearsed with stand-in events."""
import numpy as np
import pytest
import torch

from ocs2_tpu_torch.models.legged_robot import interface, model
from ocs2_tpu_torch.oc.time_discretization import make_time_grid
from ocs2_tpu_torch.solvers import sqp
from ocs2_tpu_torch.utils import observers, timers

torch.set_num_threads(1)  # one intra-op thread a test process, as the other port tests

N = 10
PHASES = ("sqp.host_read", "sqp.approx", "sqp.projection", "sqp.riccati", "sqp.forward",
          "sqp.line_search", "sqp.update")
# Standing at N = 10, three starts: 3, 4 and 3 iterations, so the loop ends
# on the host read (one scenario frozen before); a budget of 2 ends it on
# the budget.
BUDGETS = {"converged": 10, "budget": 2}
SOLUTION_FIELDS = ("xs", "us", "gains", "value_S", "value_s")


def _solve(max_iterations):
    grid = make_time_grid(0.0, 1.0, N, event_times=(), mode_sequence=np.asarray([15]))
    x0 = model.default_state("cpu")
    x0s = x0[None] + 1e-2 * torch.sin(torch.arange(3.0)[:, None] * torch.arange(24.0)[None] + 1.0)
    u0 = model.weight_compensating_input(np.ones(4, np.float32), "cpu")
    return sqp.solve(
        interface.make_problem(device="cpu"), grid, x0s, interface.make_params(grid, device="cpu"),
        us_init=u0[None].expand(N, 24).contiguous(),
        settings=sqp.SqpSettings(max_iterations=max_iterations), device="cpu")


@pytest.fixture(scope="module", params=list(BUDGETS))
def solves(request):
    """The solve with recording off, then on: (off, on, the on solve's
    records, its host and device aggregates)."""
    budget = BUDGETS[request.param]
    timers.SPANS.reset()
    off = _solve(budget)
    assert timers.SPANS.last_solve == [] and timers.SPANS.timers("host") == {}
    with timers.recording():
        on = _solve(budget)
    records = list(timers.SPANS.last_solve)
    host, device = timers.SPANS.timers("host"), timers.SPANS.timers("device")
    timers.SPANS.reset()
    return off, on, records, host, device


def test_recording_off_makes_no_record_and_opens_no_range(monkeypatch):
    opened = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args):
        opened.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    timers.SPANS.reset()
    assert not timers.SPANS.is_recording()
    _solve(2)
    assert opened == []
    assert timers.SPANS.last_solve == [] and timers.SPANS.timers("device") == {}


def test_phases_come_in_order_one_of_each_an_iteration(solves):
    _, on, records, host, device = solves
    iterations = int(on.iterations.max())
    assert [r.name for r in records] == list(PHASES) * iterations
    assert [r.iteration for r in records] == [i for i in range(iterations) for _ in PHASES]
    assert len({r.solve for r in records}) == 1 and {r.parent for r in records} == {"sqp.solve"}
    for a, b in zip(records, records[1:]):
        assert a.host_start_ns <= a.host_end_ns == b.host_start_ns
    # On the CPU the host interval stands in for the device's.
    assert all(r.device_s == (r.host_end_ns - r.host_start_ns) * 1e-9 for r in records)
    for clock in (host, device):
        assert set(clock) == set(PHASES)
        assert all(t.count == iterations and t.total > 0 for t in clock.values())


def test_recording_leaves_the_answers_bitwise_equal(solves):
    off, on, *_ = solves
    for f in SOLUTION_FIELDS:
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    assert torch.equal(off.iterations, on.iterations)
    assert torch.equal(off.history.merit.nan_to_num(-1.0), on.history.merit.nan_to_num(-1.0))


def test_benchmark_report_prints_the_aggregates(solves):
    *_, host, device = solves
    for clock in (host, device):
        report = observers.benchmark_report(clock)
        lines = report.splitlines()
        assert lines[0].startswith("Benchmarking")
        assert [ln.split()[0] for ln in lines[1:]] == list(PHASES)
        total = sum(t.total for t in clock.values())
        assert f"{100.0 * clock['sqp.approx'].total / total:5.1f}%" in report


def test_the_profiler_turns_recording_on_and_shows_the_ranges():
    from torch.profiler import ProfilerActivity, profile

    timers.SPANS.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert timers.SPANS.is_recording()
        sol = _solve(2)
    assert not timers.SPANS.is_recording()
    events = sorted((e.start_ns(), e.name()) for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("sqp."))
    assert [name for _, name in events] == list(PHASES) * int(sol.iterations.max())
    assert len(timers.SPANS.last_solve) == len(events)
    timers.SPANS.reset()


def test_recording_blocks_nest():
    rec = timers.SpanRecorder()
    with rec.recording():
        with rec.recording():
            assert rec.is_recording()
        assert rec.is_recording()
    assert not rec.is_recording()
    assert rec.solve("sqp.solve", "cpu") is timers.OFF


class _Stream:
    """A stand-in for a CUDA stream: its events complete when the host reads
    the device."""

    def __init__(self):
        self.queued = []

    def drain(self):
        for ev in self.queued:
            ev.done = True
        self.queued = []


class _Event:
    """A stand-in for ``torch.cuda.Event(enable_timing=True)`` that fails as
    the real one does when read before it has completed."""

    made = clock = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _Event.made += 1
        self.t, self.done = None, False

    def record(self, stream):
        _Event.clock += 1
        self.t, self.done = _Event.clock, False
        stream.queued.append(self)

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, other):
        if not (self.done and other.done):
            raise RuntimeError("cudaErrorNotReady")
        return 1e3 * (other.t - self.t)


def _marked_solve(rec, stream, iterations, ends_on_read):
    """The marks of ``sqp.solve``'s loop (three phases an iteration) on the
    stand-in stream."""
    spans = rec.solve("sqp.solve", "cuda")
    for i in range(iterations + ends_on_read):
        spans.mark("sqp.host_read", iteration=i)
        stream.drain()  # bool(active.any())
        if i == iterations:
            spans.drop()
            break
        spans.mark("sqp.approx", synced=True)
        spans.mark("sqp.update")
    spans.end()


def test_device_intervals_are_read_only_once_their_events_completed(monkeypatch):
    stream = _Stream()
    _Event.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    rec = timers.SpanRecorder()
    phases = ["sqp.host_read", "sqp.approx", "sqp.update"]
    with rec.recording():
        for ends_on_read in (True, True, False):
            _marked_solve(rec, stream, 2, ends_on_read)
            # The last iteration's phases wait for a later host read.
            assert [r.device_s is None for r in rec.last_solve] == [False] * 3 + [True] * 3
    assert [r.name for r in rec.last_solve] == phases * 2
    assert len({r.solve for r in rec.last_solve}) == 1
    # The last solve ended on its budget: its closing event has not
    # completed, and a reader waits for it.
    assert not rec._pending[-1][2].query()
    device = rec.timers("device")
    assert rec._pending == []
    assert all(r.device_s > 0 for r in rec.last_solve)
    assert {k: t.count for k, t in device.items()} == dict.fromkeys(phases, 6)
    # The phases tile the stream: each solve's device intervals add up to
    # the stretch from its first event to its last.
    assert sum(r.device_s for r in rec.last_solve) == pytest.approx(6.0)
    # Spent events go back to the pool: three solves of seven boundaries
    # made no more than two solves' worth.
    assert _Event.made <= 2 * 7 and len(rec._pool) == _Event.made
