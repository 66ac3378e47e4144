"""Solver observability: performance-index history, term probes, benchmarks.

Counterpart of ``ocs2_tpu/utils/observers.py`` (the reference's
SolverObserver term probes of constraints and multipliers, the
PerformanceIndex iteration history of SolverBase, and the per-phase
benchmark printout built from ``utils/timers.RepeatedTimer``).  Probes read
a solution after each solve; observed values are copied to the host as
numpy.  Solutions of the port carry a leading batch dim: a term probe reads
one scenario of it (``scenario``, 0 by default).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.types import PerformanceIndex
from ..oc.approx import example_params, node_params
from ..oc.problem import _as_rows
from .recorder import to_host
from .timers import RepeatedTimer

Tensor = torch.Tensor


def tree_to_host(tree):
    """Tensors of a nested NamedTuple / tuple / list / dict as numpy."""
    if isinstance(tree, torch.Tensor):
        return to_host(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_to_host(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to_host(v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_to_host(v) for k, v in tree.items()}
    return tree


@dataclasses.dataclass
class SolverObserver:
    """Observes a named quantity of each solve.  ``extractor(solution)``
    gives a tree of tensors; every observation is appended to ``history``
    with its solve time."""

    name: str
    extractor: Callable[[Any], Any]
    history: List[tuple] = dataclasses.field(default_factory=list)

    def observe(self, t: float, solution: Any) -> None:
        self.history.append((t, tree_to_host(self.extractor(solution))))

    def latest(self):
        return self.history[-1] if self.history else None


def constraint_observer(name: str = "equality_sse") -> SolverObserver:
    """Probe of the equality-constraint SSE."""
    return SolverObserver(
        name=name, extractor=lambda sol: sol.performance.equality_constraints_sse
    )


def multiplier_observer(name: str = "multipliers") -> SolverObserver:
    """Probe of the AL multipliers."""
    return SolverObserver(name=name, extractor=lambda sol: sol.al)


@dataclasses.dataclass
class PerformanceLog:
    """Per-solve PerformanceIndex history of one scenario (every field one
    value)."""

    entries: List[PerformanceIndex] = dataclasses.field(default_factory=list)

    def append(self, perf: PerformanceIndex) -> None:
        self.entries.append(PerformanceIndex(*(float(to_host(v).item()) for v in perf)))

    def latest(self) -> Optional[PerformanceIndex]:
        return self.entries[-1] if self.entries else None

    def as_arrays(self) -> Dict[str, np.ndarray]:
        if not self.entries:
            return {}
        return {
            field: np.asarray([getattr(e, field) for e in self.entries])
            for field in PerformanceIndex._fields
        }


# --------------------------------------------------------------------------
# Term-wise probes (the reference's ConstraintTermObserver and
# LagrangianTermObserver): extract ONE named term's per-node constraint
# values and AL multipliers from a solution, with optional callbacks.
# --------------------------------------------------------------------------

_FAMILY_ATTR = {
    "equality": ("equality_terms", True),
    "state_equality": ("state_equality_terms", False),
    "inequality": ("inequality_terms", True),
    "state_inequality": ("state_inequality_terms", False),
    "final_equality": ("final_equality_terms", False),
}
_FAMILY_MULT = {
    "equality": "lmbd_eq",
    "state_equality": "lmbd_state_eq",
    "inequality": "lmbd_ineq",
    "state_inequality": "lmbd_state_ineq",
    "final_equality": "lmbd_final_eq",
}


def term_name(fn) -> str:
    """Display name of a term callable: an explicit ``fn.name``, else the
    function's or class's name."""
    return getattr(fn, "name", None) or getattr(fn, "__name__", type(fn).__name__)


def term_slices(problem, family: str, params_example, device="cuda") -> Dict[str, slice]:
    """{term name: row slice} inside the family's stacked constraint vector
    (stacking order = the term tuple's order), from one evaluation of each
    term on zeros on ``device``."""
    attr, with_u = _FAMILY_ATTR[family]
    t = torch.zeros((), device=device)
    x = torch.zeros((problem.nx,), device=device)
    u = torch.zeros((problem.nu,), device=device)
    p = example_params(params_example, device=device)
    out, off = {}, 0
    for fn in getattr(problem, attr):
        args = (t, x, u, p) if with_u else (t, x, p)
        rows = _as_rows(fn(*args), x).shape[-1]
        out[term_name(fn)] = slice(off, off + rows)
        off += rows
    return out


def evaluate_term(problem, grid, xs, us, params, family: str, name: str):
    """Per-node values [..., N (+1), dim] of the named constraint term over a
    trajectory xs [..., N+1, nx], us [..., N, nu] (the extraction half of the
    reference's ConstraintTermObserver); [..., 1, dim] for a final term."""
    attr, with_u = _FAMILY_ATTR[family]
    fn = next(f for f in getattr(problem, attr) if term_name(f) == name)
    grid = grid.device(xs.device)
    n = us.shape[-2]
    if family == "final_equality":
        p = node_params(params, grid, n)
        return _as_rows(fn(grid.times[n], xs[..., n, :], p), xs[..., n, :]).unsqueeze(-2)
    count = n if with_u else n + 1
    nodes = torch.arange(count, device=xs.device)
    p = node_params(params, grid, nodes)
    x = xs[..., :count, :]
    out = fn(grid.times[:count], x, us, p) if with_u else fn(grid.times[:count], x, p)
    return _as_rows(out, x)


@dataclasses.dataclass
class TermObserver:
    """Named-term probe with constraint / multiplier callbacks.

    ``observe(t, grid, sol, params)`` extracts the term's per-node values of
    scenario ``scenario`` (and, when the solution carries an AlState, its
    multiplier rows), appends them to the history, and calls the callbacks
    with (timestamps [N], values [N, dim]) as numpy."""

    problem: Any
    family: str
    term: str
    constraint_callback: Optional[Callable] = None
    multiplier_callback: Optional[Callable] = None
    scenario: int = 0
    history: List[tuple] = dataclasses.field(default_factory=list)

    def observe(self, t: float, grid, sol, params) -> None:
        b = self.scenario
        vals = to_host(evaluate_term(
            self.problem, grid, sol.xs[b], sol.us[b], params, self.family, self.term))
        times = to_host(grid.times)[: vals.shape[0]]
        mults = None
        al = getattr(sol, "al", None)
        if al is not None:
            sl = term_slices(self.problem, self.family, params, device=sol.xs.device)[self.term]
            mults = to_host(getattr(al, _FAMILY_MULT[self.family])[b])[..., sl]
        self.history.append((t, times, vals, mults))
        if self.constraint_callback is not None:
            self.constraint_callback(times, vals)
        if self.multiplier_callback is not None and mults is not None:
            self.multiplier_callback(times, mults)

    def latest(self):
        return self.history[-1] if self.history else None


def benchmark_report(timers: Dict[str, RepeatedTimer]) -> str:
    """Percentage breakdown string (the reference's getBenchmarkingInfo)."""
    total = sum(t.total for t in timers.values()) or 1.0
    lines = ["Benchmarking [ms and % of total]:"]
    for name, t in timers.items():
        lines.append(
            f"  {name:<24s} avg {t.average * 1e3:8.3f} ms  "
            f"max {t.max * 1e3:8.3f} ms  ({100.0 * t.total / total:5.1f}%)"
        )
    return "\n".join(lines)
