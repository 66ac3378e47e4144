"""Small CPU-sized versions of the cells for the tests."""
from __future__ import annotations

import dataclasses
import json

from harness.spec import ROOT, load_cell

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
RUN_CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def _with_held_out(bench: dict) -> dict:
    """BENCHMARK.json with the cells of ``held_out/*.json`` added: their
    configs, workloads and per-layer metrics, and their names in the
    workloads lists of the metrics their ``also_in`` names."""
    bench = json.loads(json.dumps(bench))
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]}
    for path in sorted((ROOT / "benchmark" / "held_out").glob("*.json")):
        frag = json.loads(path.read_text())
        for key in ("configs", "workloads", "per_layer"):
            bench[key] += frag.get(key, [])
        for name in frag.get("also_in", []):
            if "workloads" in metrics[name]:
                metrics[name]["workloads"] += [w["name"] for w in frag["workloads"]]
    return bench


# The cells the tests run on the CPU: BENCHMARK.json's and the held-out ones.
BENCH = _with_held_out(BENCHMARK)
CELLS = [w["name"] for w in BENCH["workloads"]]
# Scenarios per batch on the CPU, by configuration: the full widths, N and
# iteration budgets, a small batch.
CPU_BATCH = {"ballbot": 12, "legged_srbd_trot": 4}


def cpu_cell(name: str, batch: int = 0):
    cell = load_cell(name, BENCH)
    b = batch or CPU_BATCH.get(cell.config["name"], 4)
    traffic = dict(cell.traffic, batch=b, pool_batches=2, sample_per_batch=b,
                   reference_block=b)
    return dataclasses.replace(cell, traffic=traffic)
