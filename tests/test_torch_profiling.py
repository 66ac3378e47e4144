"""``utils/profiling`` of the port vs the JAX package's, on the CPU.

``profile_sqp_phases`` on the projected toy problem (nu = 2: an equality to
project, a plain cost term): the report has the JAX package's keys (its report
on the same problem is stored by ``tools/torch_test_records.py --record
test_torch_profiling``; only its keys are compared, its times are the CPU's
of another run) and every time is finite and positive; ``format_report``
prints the JAX package's text for the same report; ``time_call`` runs its
warm-ups and repeats and returns their median.
"""
import math

import numpy as np
import pytest
import torch

import torch_toy_problem as toy
from ocs2_tpu.oc.time_discretization import uniform_grid as juniform_grid
from ocs2_tpu.solvers import sqp as jsqp
from ocs2_tpu.utils import profiling as jprofiling

from ocs2_tpu_torch.oc.time_discretization import uniform_grid
from ocs2_tpu_torch.solvers import sqp
from ocs2_tpu_torch.utils import profiling
from tools._records import Records

torch.set_num_threads(1)  # one intra-op thread a test process: the suite runs in several
# processes at once (pytest-xdist), and these small tensors gain nothing from more.

N, X0 = 8, (0.3, -0.2)
SETTINGS = dict(max_iterations=2)


def _jax_report():
    import jax.numpy as jnp

    return jprofiling.profile_sqp_phases(
        toy.jax_problem(2), juniform_grid(0.0, 1.0, N), jnp.asarray(X0, jnp.float32),
        toy.jax_params(2), jsqp.SqpSettings(**SETTINGS))


JAX_RECORDS = {"report": _jax_report}
RECORDS = Records(__file__)


@pytest.fixture(scope="module")
def report():
    return profiling.profile_sqp_phases(
        toy.torch_problem(2), uniform_grid(0.0, 1.0, N), np.float32(X0), toy.torch_params(2),
        sqp.SqpSettings(**SETTINGS), device="cpu", warmup=1, reps=2)


def test_report_has_the_reference_keys(report):
    ref = RECORDS["report"]
    assert set(report) == set(ref)
    assert set(report) == {"lq_approx", "convexify_eigh", "projection", "riccati_seq",
                           "riccati_parallel", "qp_forward", "linesearch", "full_solve"}


def test_every_phase_time_is_finite_and_positive(report):
    assert all(math.isfinite(v) and v > 0.0 for v in report.values()), report


def test_format_report_prints_the_reference_text(report):
    assert profiling.format_report(report) == jprofiling.format_report(report)
    assert profiling.format_report({}) == jprofiling.format_report({})


def test_time_call_runs_warmups_and_repeats_and_returns_the_median(monkeypatch):
    calls = []

    def fn(x):
        calls.append(x)
        return torch.zeros(1)

    assert profiling.time_call(fn, 7, warmup=2, reps=3) >= 0.0
    assert calls == [7] * 5
    clock = iter([0.0, 5.0, 10.0, 11.0, 20.0, 23.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    assert profiling.time_call(fn, 1, warmup=0, reps=3) == 3.0  # the median of 5, 1 and 3
