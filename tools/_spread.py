"""The JAX package's own spread on a recorded solve, for the record tools
(``tools/{cartpole,manipulator,slq}_reference.py``).

A record holds one route of the JAX package's solve: its solve as it is, or
mapped by ``jax.vmap`` over the recorded batch.  Its spread is how far the
JAX package's other routes to the same scenario land from it: its solve of
the scenario alone, and its vmapped solve of a batch of that one scenario
(the JAX package's batched Riccati sweep takes another path there).  Where
that exceeds the tolerance, the JAX package itself decides the scenario by
float32 rounding, and ``chip_smoke.hold_within_spread`` holds the port there
to the spread, never past it.  (Its solve in float64, the third route of
``tools/perceptive_reference.py --force-spread``, does not run for SQP or
SLQ: their loop carries keep float32 leaves.)  Imports only JAX.
"""
from __future__ import annotations

import numpy as np


def routes_of(solve, batched, starts):
    """The JAX package's two other routes to each of ``starts`` (its leading
    axis): ``solve`` jitted one start at a time ("single"), and ``batched``
    (the jitted vmapped solve) on a batch of that one start ("vmapped_one").
    Each as (xs, us, iterations) stacked over the starts."""
    import jax

    single = jax.jit(solve)
    out = {}
    for name, fn in (("single", lambda s: single(s)),
                     ("vmapped_one", lambda s: jax.tree.map(lambda v: v[0], batched(s[None])))):
        sols = [fn(s) for s in starts]
        out[name] = (np.stack([np.asarray(o.xs) for o in sols]),
                     np.stack([np.asarray(o.us) for o in sols]),
                     np.asarray([int(o.iterations) for o in sols]))
    return out


def spread_fields(prefix, xs, us, iterations, routes):
    """Record fields of the spread of a batch (xs [B, N+1, nx], us, iterations
    [B]) against the other routes ({name: (xs, us, iterations)}, each with the
    same leading [B]): per scenario the largest difference in xs and in us
    over the routes (``spread_xs``, ``spread_us``), each route's own
    (``{name}_spread_xs``, ...) and iterations, and the range of the
    iteration counts over the record and every route
    (``iterations_lo``, ``iterations_hi``)."""
    out = {}
    spread_xs = np.zeros(len(xs), np.float32)
    spread_us = np.zeros(len(xs), np.float32)
    lo, hi = np.asarray(iterations).copy(), np.asarray(iterations).copy()
    for name, (r_xs, r_us, r_its) in routes.items():
        dx = np.abs(np.asarray(r_xs, np.float64) - xs).reshape(len(xs), -1).max(axis=1)
        du = np.abs(np.asarray(r_us, np.float64) - us).reshape(len(xs), -1).max(axis=1)
        out.update({f"{prefix}{name}_spread_xs": dx.astype(np.float32),
                    f"{prefix}{name}_spread_us": du.astype(np.float32),
                    f"{prefix}{name}_iterations": np.asarray(r_its)})
        spread_xs, spread_us = np.maximum(spread_xs, dx), np.maximum(spread_us, du)
        lo, hi = np.minimum(lo, r_its), np.maximum(hi, r_its)
    out.update({f"{prefix}spread_xs": spread_xs, f"{prefix}spread_us": spread_us,
                f"{prefix}iterations_lo": lo, f"{prefix}iterations_hi": hi})
    return out


def describe(rec, prefix):
    """One line on a record's spread."""
    routes = sorted({k[len(prefix):-len("_spread_xs")] for k in rec
                     if k.startswith(prefix) and k.endswith("_spread_xs")
                     and k != prefix + "spread_xs"})
    parts = [f"{r} xs {rec[f'{prefix}{r}_spread_xs'].max():.3g} us "
             f"{rec[f'{prefix}{r}_spread_us'].max():.3g}" for r in routes]
    return "spread: " + ", ".join(parts)
