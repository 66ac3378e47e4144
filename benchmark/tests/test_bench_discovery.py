"""Every name in BENCHMARK.json and in the held-out cells finds its files,
and the contract's shape holds."""
import json
import re

import pytest

from harness import spec
from helpers import BENCH as ALL

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]


@pytest.mark.parametrize("workload", [w["name"] for w in ALL["workloads"]])
def test_cell_found_by_name(workload):
    cell = spec.load_cell(workload, ALL)
    assert cell.config["name"] == next(w for w in ALL["workloads"]
                                       if w["name"] == workload)["config"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.checks and all(v >= 0 for v in cell.checks.values())
    for key in ("batch", "start_scale", "pool_batches", "sample_per_batch", "trace_batches",
                "reference_block"):
        assert key in cell.traffic


@pytest.mark.parametrize("config", [c["name"] for c in ALL["configs"]])
def test_config_files(config):
    entry = next(c for c in ALL["configs"] if c["name"] == config)
    cfg = spec.read_json(spec.ROOT / entry["file"])
    assert cfg["name"] == config and cfg["reduced"] == entry["reduced"]
    assert hasattr(spec.load_module("scenarios", config), "build")
    assert (spec.BENCH_DIR / "reference" / f"{config}.py").is_file()
    kernel = cfg["solver"]["kernel"]
    counts = sorted(p.stem for p in (spec.BENCH_DIR / "roofline").glob("*.py")
                    if p.stem != "__init__")
    assert any(spec.load_module("roofline", k).KERNEL == kernel for k in counts)


@pytest.mark.parametrize("metric", [m["name"] for m in ALL["end_to_end"] + ALL["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.load_module("metrics", metric).read)


@pytest.mark.parametrize("bench", [BENCH, ALL], ids=["benchmark", "with_held_out"])
def test_names_and_lists(bench):
    for kinds in (("configs",), ("workloads",), ("end_to_end", "per_layer")):
        names = [x["name"] for k in kinds for x in bench[k]]
        assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    moved = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= cells and m["moves"] in moved
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    chips = [w["chips"] for w in bench["workloads"]]
    assert all(isinstance(c, int) and c in (1, 4) for c in chips)
    assert sum(c == 4 for c in chips) <= max(1, len(chips) // 4)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_unknown_cell_is_refused():
    with pytest.raises(spec.SpecError):
        spec.load_cell("no-such-cell")
