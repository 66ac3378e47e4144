"""A run on the CPU end to end: the result line's keys, and nothing more;
run.py refuses to run without a card; and what a run leaves in sys.modules."""
import json
import subprocess
import sys

import pytest

import run
from helpers import RUN_CELLS, cpu_cell
from harness.spec import ROOT

LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(scope="module")
def ballbot_runs():
    cell = cpu_cell("ballbot-slq-b4096")
    return cell, run.run_cell(cell, 7, 0.0, False, device="cpu"), \
        run.run_cell(cell, 7, 0.0, True, device="cpu")


def test_line_keys(ballbot_runs):
    cell, plain, traced = ballbot_runs
    for out, extra in ((plain, set()), (traced, {"breakdown"})):
        out = dict(out)
        out.pop("window")
        assert set(out.pop("sides")) == {"starts", "program", "reference"}
        assert set(out) == LINE_KEYS | extra
        assert list(out)[-1] == "checks"
        assert out["correct"] is True and out["failed"] == 0
        assert out["attempted"] == cell.traffic["batch"]
        assert set(out["device"]) >= {"platform", "count", "memory_peak_bytes"}
        json.dumps(run.finite_json(out), allow_nan=False)
    assert set(plain["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(set(v) == {"value", "unit"} for v in plain["metrics"].values())
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    # On the CPU the device metrics find nothing to read and are left out.
    assert set(traced["metrics"]) == {"iteration_ms", "iterations_mean"}
    assert set(plain["checks"]) == set(cell.checks)
    assert all(set(c) == {"value", "limit"} for c in plain["checks"].values())


def test_same_seed_same_starts():
    import torch

    from harness import starts

    traffic = {"batch": 8, "start_scale": 0.1, "pool_batches": 3, "sample_per_batch": 4}
    nominal = torch.zeros(10)
    seed = 2 ** 31 + 12345
    a, b = starts.draw(traffic, nominal, seed), starts.draw(traffic, nominal, seed)
    c = starts.draw(traffic, nominal, seed + 1)
    assert torch.equal(a.pool, b.pool) and torch.equal(a.sample_rows, b.sample_rows)
    assert not torch.equal(a.pool, c.pool)
    assert torch.equal(a.batch(4), a.pool[1])


def _run_script(*args, cwd=ROOT):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = _run_script("--workload", RUN_CELLS[0], "--seed", "1", "--seconds", "1",
                    "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA device" in p.stderr


def test_refuses_an_unknown_cell():
    p = _run_script("--workload", "nope", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, the
    program is missing: no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_script("--workload", RUN_CELLS[0], "--seed", "1", "--seconds", "1",
                    "--trace", "0", cwd=tmp_path)
    assert p.returncode != 0 and p.stdout == ""




def _modules_after(code: str) -> set:
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_a_run_imports_no_jax_and_no_jax_package():
    code = (
        "import sys, json, dataclasses\n"
        "sys.path.insert(0, 'benchmark'); sys.path.insert(1, 'benchmark/tests'); sys.path.append('.')\n"
        "import run\n"
        "from helpers import CELLS, cpu_cell\n"
        "for name in CELLS:\n"
        "    cell = cpu_cell(name, 2)\n"
        "    out = run.run_cell(cell, 3, 0.0, False, device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules_after(code)
    assert not tops & {"jax", "jaxlib", "flax", "ocs2_tpu"}
    assert "ocs2_tpu_torch" in tops


def test_the_reference_imports_nothing_of_the_program():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'benchmark')\n"
        "import torch\n"
        "from harness.spec import read_json, ROOT\n"
        "from reference.arith import Arith\n"
        "import reference.ballbot as b, reference.legged_srbd_trot as l\n"
        "for mod, cfg in ((b, 'ballbot'), (l, 'legged_srbd_trot')):\n"
        "    c = read_json(ROOT / 'benchmark' / 'configs' / f'{cfg}.json')\n"
        "    mod.solve(c, torch.zeros((1, c['nx'])) + (0.1 if cfg == 'ballbot' else 0.0), Arith())\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = _modules_after(code)
    assert not tops & {"jax", "jaxlib", "flax", "ocs2_tpu", "ocs2_tpu_torch"}


def test_no_source_names_the_jax_package():
    """A look at the sources too: no import of jax, flax or ocs2_tpu in the
    benchmark, none of ocs2_tpu_torch in the reference."""
    import ast

    bench = ROOT / "benchmark"
    for path in bench.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            tops = {n.split(".")[0] for n in names}
            assert not tops & {"jax", "jaxlib", "flax", "ocs2_tpu"}, path
            if "reference" in path.parts:
                assert "ocs2_tpu_torch" not in tops, path
