#!/usr/bin/env python3
"""Solve-level A/B of the projection's QR route on one NVIDIA GPU.

    python3 ocs2_tpu_torch/tools/qr_route_ab.py      # from the root of the repo

``ops/projection.py`` factorizes every node's D' with ``householder_qr`` (12
reflections as batched tensor ops).  This script times the legged SQP tick of
``chip_smoke.py`` (N = 100, B = 1 and B = 256) with that route and with
``torch.linalg.qr(mode="complete")`` put in its place, in turns inside one
process (library, Householder, Householder, library), and prints one JSON
line per turn.  The stage-level times of both routes are part of
``chip_smoke.py --profile``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("qr_route_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ocs2_tpu_torch.ops import projection, riccati_cuda

    riccati_cuda.build([cs.LEGGED_SHAPE[:2]])
    cfg = cs.legged_setup(torch)
    i = torch.arange(cs.LEGGED_BATCH, dtype=torch.float32, device="cuda")[:, None]
    j = torch.arange(24, dtype=torch.float32, device="cuda")[None, :]
    x0s = cfg["x0"][None] + 1e-3 * torch.sin(i * j)
    routes = {
        "householder": projection.householder_qr,
        "torch.linalg.qr": lambda a: torch.linalg.qr(a, mode="complete"),
    }

    def run(x0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = cs.legged_solve(cfg, x0, cfg["us_init"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, sol

    try:
        for fn in routes.values():  # warm-up of both routes
            projection.householder_qr = fn
            run(cfg["x0"]), run(x0s)
        for name in ("torch.linalg.qr", "householder", "householder", "torch.linalg.qr"):
            projection.householder_qr = routes[name]
            b1 = [run(cfg["x0"]) for _ in range(3)]
            b256 = [run(x0s) for _ in range(2)]
            print(json.dumps({
                "qr": name, "device": torch.cuda.get_device_name(0),
                "b1_cold_tick_s": [t for t, _ in b1],
                "b1_iterations": int(b1[0][1].iterations[0]),
                "b256_solve_s": [t for t, _ in b256],
                "b256_iterations": b256[0][1].iterations.unique().tolist(),
            }), flush=True)
    finally:
        projection.householder_qr = routes["householder"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
