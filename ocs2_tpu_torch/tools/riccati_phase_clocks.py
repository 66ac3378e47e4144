#!/usr/bin/env python3
"""Cycles a node of the Riccati kernel spends in each of its phases.

    python3 ocs2_tpu_torch/tools/riccati_phase_clocks.py      # from the root of the repo

Builds ``csrc/riccati_backward.cu`` a second time with
``-DRICCATI_PHASE_CLOCKS`` (the first thread of the grid then reads
``clock64`` after every phase and prints the per-node means as one JSON line)
and launches it once at each timed shape of ``chip_smoke.py`` on random LQ
data.  The cycles are those of the first scenario's first thread, barriers
included; the clocked build is a few percent slower than the one the solvers
load.  Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("riccati_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ocs2_tpu_torch.ops import riccati, riccati_cuda

    riccati_cuda.EXTRA_DEFINES = ("-DRICCATI_PHASE_CLOCKS",)
    shapes = cs.KERNEL_SHAPES[:3] + [cs.STRICT_SHAPE]
    riccati_cuda.build(sorted({s[:2] for s in shapes}))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}))
    for nx, nu, batch, n in shapes:
        coeffs, reg = cs.random_lq(torch, riccati, nx, nu, batch, n, seed=5)
        print(json.dumps({"nx": nx, "nu": nu, "B": batch, "N": n}), flush=True)
        riccati_cuda.lqr_backward_cuda(coeffs, reg, strict=batch == 1)
        torch.cuda.synchronize()  # the kernel's own line follows the shape's
    return 0


if __name__ == "__main__":
    sys.exit(main())
