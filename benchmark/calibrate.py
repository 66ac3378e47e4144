#!/usr/bin/env python3
"""The readings that a cell's limits in ``checks/<cell>.json`` are set from,
in one process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        --seconds <run_seconds> [--control-seeds 3] [--out <file>]

For every seed, a run of the cell as ``run.py`` makes it (``run.run_cell``:
set-up, the measured window, the reference on the sampled scenarios) and the
comparison's numbers: the lower readings, from sound runs of the program.
For the first ``--control-seeds`` seeds also the control: the reference with
its matrix products in TF32 put in the program's place, compared with the
float32 reference on the same starts (the upper readings).  One JSON line a
reading; the limits are set by hand from them (PERF.md gives the readings).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR))
sys.path.append(str(BENCH_DIR.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    import torch

    import run
    from harness import compare
    from harness.spec import load_cell

    run.set_cache_dirs()
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(obj):
        line = json.dumps(run.finite_json(obj))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        res = run.run_cell(cell, seed, args.seconds, False)
        win, sides = res["window"], res.pop("sides")
        emit({"workload": cell.name, "seed": seed, "side": "program",
              "batches": win["batches"], "window_s": win["seconds"],
              "solves_per_s": res["attempted"] / win["seconds"],
              "reference_s": win["reference_s"], "numbers": win["compared"],
              "nonfinite": win["nonfinite"]})
        if k < args.control_seeds:
            ctl = run.solve_reference(cell, sides["starts"], True)
            emit({"workload": cell.name, "seed": seed, "side": "control_tf32",
                  "numbers": compare.numbers(ctl, sides["reference"]),
                  "nonfinite": compare.nonfinite_shares(ctl)})
        del res, sides
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
