"""A cell's definition, gathered by name from ``BENCHMARK.json`` and the
files of the benchmark's own directories.

``BENCHMARK.json`` names the cell's configuration and traffic, and the
metrics it reports; ``configs/<config>.json`` holds the configuration,
``traffic/<traffic>.json`` the traffic's parameters, ``checks/<cell>.json``
the numbers that decide ``correct`` with their limits.  Code of one
configuration, metric or kernel lives in ``scenarios/<config>.py``,
``reference/<config>.py``, ``metrics/<metric>.py`` and
``roofline/<kernel>.py`` and is loaded by file name, so a new cell, metric or
configuration is new files and new entries, and no edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class SpecError(ValueError):
    """A cell, file or entry that the benchmark cannot find or read."""


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of BENCHMARK.json with everything its files hold."""

    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict  # number -> limit
    end_to_end: tuple  # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def read_json(path: Path) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError as e:
        raise SpecError(f"missing file {path}") from e


def _reports(metric: dict, cell: str, end_to_end_names=None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` list
    names or, without a list, every cell (an end-to-end metric) or every cell
    that reports the end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end_names is None or metric["moves"] in end_to_end_names


def load_cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of ``bench``, by default BENCHMARK.json."""
    bench = bench or read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r}; known: {', '.join(sorted(cells))}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = read_json(ROOT / configs[w["config"]]["file"])
    traffic = read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    checks = read_json(BENCH_DIR / "checks" / f"{name}.json")
    e2e = tuple(m for m in bench["end_to_end"] if _reports(m, name))
    e2e_names = {m["name"] for m in e2e}
    layer = tuple(m for m in bench["per_layer"] if _reports(m, name, e2e_names))
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                checks=checks["limits"], end_to_end=e2e, per_layer=layer)


def load_module(kind: str, name: str) -> ModuleType:
    """``<kind>/<name>.py`` of the benchmark's directory as a module (a
    scenario, a metric's reader or a kernel's roofline count; the
    references are a package, imported as ``reference.<config>``)."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise SpecError(f"missing {kind} module {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
