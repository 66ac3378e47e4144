#!/usr/bin/env python3
"""Cycles an evaluation of the continuous-time Riccati kernel (SLQ) spends in
each of its phases.

    python3 ocs2_tpu_torch/tools/riccati_ct_phase_clocks.py      # from the root of the repo

Builds ``csrc/riccati_ct_backward.cu`` a second time with
``-DRICCATI_CT_PHASE_CLOCKS`` (the first thread of the grid then reads
``clock64`` at four points of every evaluation and prints the mean cycles per
evaluation of each stretch as one JSON line: the jump branch's products and a
node's gains, the products with phase P's barrier, the right-hand side with
the next coefficients, the next step's factors with phase R's barrier; the
interval's first evaluation, which alone does the first and more of the
others, apart) and launches it once at (2, 1, 1, 100) with jumps and at
(10, 3, 4096, 32), the shapes of ``chip_smoke.CT_SHAPES``, on random LQ data.
The cycles are those of the first scenario's first thread, its group's
barriers included.  The clocked build keeps its counters in local memory and
runs slower than the one the solvers load, so its stretches compare with each
other, not with the kernel's time.  Needs one NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("riccati_ct_phase_clocks: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from ocs2_tpu_torch.ops import riccati_ct, riccati_ct_cuda

    riccati_ct_cuda.EXTRA_DEFINES = ("-DRICCATI_CT_PHASE_CLOCKS",)
    shapes = [cs.CT_SHAPES[1], cs.CT_SHAPES[0]]
    riccati_ct_cuda.build(sorted({s[:2] for s in shapes}))
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": cs.nvidia_smi_line()}))
    for nx, nu, batch, n, jumps in shapes:
        coeffs = cs.random_ct(torch, riccati_ct, nx, nu, batch, n, seed=5, jumps=jumps)
        geometry = riccati_ct_cuda.card_geometry(nx, nu, batch, cs.DEVICE)
        print(json.dumps({"nx": nx, "nu": nu, "B": batch, "N": n, "jump_intervals": list(jumps),
                          "geometry": geometry._asdict()}), flush=True)
        riccati_ct_cuda.slq_backward_cuda(coeffs, torch.full((batch,), 1e-3, device=cs.DEVICE),
                                          cs.CT_SUBSTEPS)
        torch.cuda.synchronize()  # the kernel's own line follows the shape's
    return 0


if __name__ == "__main__":
    sys.exit(main())
