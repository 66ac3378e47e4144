#!/usr/bin/env python3
"""One run of one cell of the ocs2_tpu_torch benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  A run:

1. refuses to start without as many CUDA devices as the cell asks for;
2. builds the cell's problem through the program's own constructors (the
   program builds its CUDA kernels at first use into ``ocs2_tpu_torch/build/``
   inside the checkout, where every later run finds them);
3. draws the starts from ``--seed`` on the device (``harness/starts.py``);
4. warms up with one solve of a batch of the cell's shape;
5. measures: closed loop, batch after batch, for ``--seconds`` seconds;
6. with ``--trace 1``, profiles a few more batches for the per-layer
   metrics;
7. compares the sampled answers of the window with the plain reference
   (``reference/<config>.py``) run on the same starts after the window, and
   prints one JSON line: ``--trace 0`` the cell's end-to-end metrics,
   ``--trace 1`` its per-layer metrics.

The cell's configuration, traffic, checks and metrics are found by name
(``harness/spec.py``); nothing here is particular to a cell.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(BENCH_DIR) not in sys.path:
    sys.path.insert(0, str(BENCH_DIR))
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))

# Modules that no run may hold once its window has closed, compared by the
# whole top-level name (the program's own name begins with the last one).
FORBIDDEN = ("jax", "jaxlib", "flax", "ocs2_tpu")
CACHE_DIR = ROOT / ".bench_cache"


def set_cache_dirs() -> None:
    """Build caches at fixed paths inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def finite_json(obj):
    """``obj`` with every float that is not finite written as a string, so
    that the line is strict JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: finite_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite_json(v) for v in obj]
    return obj


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.strip().splitlines()[0].strip() if out.strip() else "unknown"


def solve_reference(cell, x0s, tf32: bool) -> dict:
    """The plain reference's answers for starts ``x0s``, in blocks of the
    traffic's ``reference_block`` rows, its matrix products in float32 or,
    for the control, TF32."""
    from harness import compare
    from reference.arith import Arith

    cfg = cell.config
    ref_module = importlib.import_module(f"reference.{cfg['name']}")
    block = int(cell.traffic["reference_block"])
    return compare.concat([ref_module.solve(cfg, x0s[i:i + block], Arith(tf32=tf32))
                           for i in range(0, x0s.shape[0], block)])


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             build_scenario=None) -> dict:
    """Run the cell once and return the result line's fields (without the
    device's name), under "window" what the window did, and under "sides"
    the compared starts with the program's and the reference's answers.
    ``build_scenario(cfg, device)`` replaces the cell's scenario module; the
    tests use it to break the timed path."""
    import torch

    from harness import compare, observe, starts, window
    from harness import trace as tracing
    from harness.spec import load_module

    cfg, traffic = cell.config, cell.traffic
    tf32 = bool(cfg["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    cuda = torch.device(device).type == "cuda"

    build = build_scenario or load_module("scenarios", cfg["name"]).build
    scenario = build(cfg, device)
    draws = starts.draw(traffic, scenario.nominal, seed)
    scenario.solve(draws.warmup)
    window.sync(device)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START

    win = window.run(scenario, draws, seconds, device)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    traced = (tracing.run(scenario, draws, win.batches, int(traffic["trace_batches"]), device)
              if trace else None)
    obs = observe.Observation(window=win, trace=traced, peak_bytes=window_peak, setup_s=setup_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = observe.read_metric(m["name"], obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # The program's state goes before the reference runs.
    x0s = torch.cat([s[0] for s in win.samples]).to(device)
    program = {k: v.to(device) for k, v in compare.concat([s[1] for s in win.samples]).items()}
    del scenario, draws, win.samples[:]
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = solve_reference(cell, x0s, tf32)
    values = compare.numbers(program, reference)
    correct, checks = compare.judge(values, cell.checks)

    dev = {"platform": "gpu" if cuda else "cpu", "count": cell.chips,
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    out = {"correct": correct, "attempted": win.scenarios, "failed": win.nonfinite,
           "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced.busy_s, window_s=traced.window_s)
        out["breakdown"] = {"device_ops": traced.device_ops, "idle_gaps": traced.idle_gaps}
    out["checks"] = checks
    out["window"] = {"batches": win.batches, "seconds": win.seconds,
                     "iterations_run": win.iterations_run, "batch_s": win.batch_s,
                     "reference_s": time.perf_counter() - t_ref, "compared": values,
                     "nonfinite": compare.nonfinite_shares(program)}
    out["sides"] = {"starts": x0s, "program": program, "reference": reference}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_cache_dirs()

    from harness.spec import SpecError, load_cell

    try:
        cell = load_cell(args.workload)
    except SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    del out["sides"]
    out["device"]["kind"] = torch.cuda.get_device_name(0)
    out["device"]["power_limit"] = card_power_limit()
    held = forbidden_modules()
    if held:
        print(f"benchmark: the run holds {', '.join(held)}; no result", file=sys.stderr)
        return 3
    print(json.dumps(finite_json(out.pop("window"))), file=sys.stderr)
    checks = out.pop("checks")
    out["checks"] = checks  # the key that comes last
    print(json.dumps(finite_json(out), allow_nan=False), flush=True)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {out['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
