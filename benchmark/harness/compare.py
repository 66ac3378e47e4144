"""The comparison that decides ``correct``: the program's answers for the
sampled scenarios against the plain reference's on the same starts.

The numbers; a cell's ``checks/<cell>.json`` names those it is held to, each
with its limit:

* ``iterations_differ_share``: the share of sampled scenarios whose solve
  ran another number of iterations than the reference's;
* ``nonfinite_differ_share``: the share of sampled scenarios in which an
  entry of xs, us, gains, value_S or value_s is not finite on one side only,
  or not finite on both sides but not the same (NaN and NaN, or one
  infinity);
* ``merit_rel_gap``: the largest |merit - reference| / |reference| (a
  merit that is NaN on both sides counts 0, on one side infinite), and
  ``merit_rel_gap_q90`` its 90th percentile over the sampled scenarios;
* ``<field>_gap`` for xs, us, gains, value_S and value_s, over the
  scenarios whose iterations agree: the largest per-scenario gap (below),
  infinite with no scenario whose iterations agree;
* ``<field>_gap_q90``, ``<field>_gap_q99``: the 90th and 99th percentiles of
  the per-scenario gaps over the scenarios whose iterations agree and whose
  entries of the field are all finite on both sides (infinite where there
  is none).

A scenario's gap in a field is its largest difference over the larger of
its largest reference entry and the median scenario's; entries that are the
same non-finite value on both sides are left out, and entries that are not
finite differently make the gap infinite.
"""
from __future__ import annotations

import math

import torch

FIELDS = ("xs", "us", "gains", "value_S", "value_s")


def per_scenario(a: torch.Tensor, b: torch.Tensor) -> tuple:
    """(gap, finite, differ) per scenario of program ``a`` against reference
    ``b``: the gap as above, whether every entry is finite on both sides, and
    whether the entries that are not finite differ."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    fin_a, fin_b = torch.isfinite(a), torch.isfinite(b)
    same_off = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    differ = ((fin_a != fin_b) | (~fin_a & ~same_off)).any(1)
    both = fin_a & fin_b
    diff = torch.where(both, (a - b).abs(), torch.zeros_like(a)).amax(1)
    size = torch.where(both, b.abs(), torch.zeros_like(b)).amax(1)
    if a.shape[0]:
        size = torch.clamp(size, min=float(size.median()))
    scale = torch.where(size > 0, size, torch.ones_like(size))
    gap = torch.where(differ, torch.full_like(diff, math.inf), diff / scale)
    return gap, both.all(1), differ


def _quantile(v: torch.Tensor, q: float) -> float:
    return float(v.quantile(q)) if v.numel() else math.inf


def numbers(program: dict, reference: dict) -> dict:
    """The comparison's numbers for two dicts of the same sampled scenarios
    (computed on the program's device)."""
    ref = {k: v.to(program[k].device) for k, v in reference.items()}
    same = program["iterations"] == ref["iterations"]
    m_p, m_r = program["merit"].double(), ref["merit"].double()
    rel = (m_p - m_r).abs() / m_r.abs().clamp(min=1e-30)
    rel = torch.where(torch.isnan(m_p) & torch.isnan(m_r), torch.zeros_like(rel), rel)
    rel = torch.nan_to_num(rel, nan=math.inf)
    out = {
        "sampled": int(same.shape[0]),
        "iterations_differ_share": float((~same).double().mean()),
        "merit_rel_gap": float(rel.max()),
        "merit_rel_gap_q90": float(rel.quantile(0.9)),
    }
    differ_any = torch.zeros_like(same)
    for f in FIELDS:
        gap, finite, differ = per_scenario(program[f], ref[f])
        differ_any |= differ
        out[f"{f}_gap"] = float(gap[same].max()) if bool(same.any()) else math.inf
        held = gap[same & finite]
        out[f"{f}_gap_q90"] = _quantile(held, 0.9)
        out[f"{f}_gap_q99"] = _quantile(held, 0.99)
    out["nonfinite_differ_share"] = float(differ_any.double().mean())
    return out


def nonfinite_shares(program: dict) -> dict:
    """For the look at a comparison, not for ``correct``: per field, the
    share of sampled scenarios with an entry that is not finite."""
    return {f"{f}_nonfinite_share": float((~torch.isfinite(program[f].flatten(1)).all(1))
                                          .double().mean()) for f in FIELDS}


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) for the numbers that have a
    limit; a number that is missing or not finite fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name, math.nan)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks


def concat(parts: list) -> dict:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
