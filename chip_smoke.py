#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ocs2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card and nvcc

Builds every CUDA kernel of the port from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the port's
main path — ``ddp.solve`` (iLQR) on the ballbot problem for a batch of 4096
scenarios, 32 intervals — and checks that it went through the kernels.  Each
phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when there
is no CUDA device or when any phase fails.  Imports neither JAX nor the JAX
package.

Peak rates used for the bounds: 3.35 TB/s of device memory and 67 TFLOP/s of
float32 outside the tensor cores (NVIDIA H100 SXM data sheet).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
RTOL, ATOL = 2e-4, 1e-5  # float32 reassociation: the k-accumulation order differs

# (nx, nu, B, N): the three production shapes of the Riccati sweep (ballbot
# iLQR batch, quadrotor SQP batch, legged SQP batch), one ragged batch, and
# one ragged batch with more inputs than states.
KERNEL_SHAPES = [(10, 3, 4096, 32), (12, 4, 4096, 40), (24, 12, 256, 100), (10, 3, 1000, 8),
                 (3, 5, 77, 6)]
MAIN_SHAPE = KERNEL_SHAPES[0]
REG_VALUES = (0.0, 1e-6, 0.1, 2.0)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def random_lq(torch, riccati, nx, nu, batch, n, seed):
    """Numpy-seeded LQ data on the card: A ~ I, PD Quu, small couplings."""
    rng = np.random.default_rng(seed)
    r = lambda scale, *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    eye_x, eye_u = np.eye(nx, dtype=np.float32), np.eye(nu, dtype=np.float32)
    wu = r(0.02, batch, n, nu, nu)
    wx = r(0.02, batch, n, nx, nx)
    leaves = dict(
        A=eye_x + r(0.05, batch, n, nx, nx),
        B=r(0.1, batch, n, nx, nu),
        b=r(0.1, batch, n, nx),
        Qxx=eye_x + wx + wx.transpose(0, 1, 3, 2),
        qx=r(0.1, batch, n, nx),
        Quu=eye_u + wu + wu.transpose(0, 1, 3, 2),
        qu=r(0.1, batch, n, nu),
        Qux=r(0.01, batch, n, nu, nx),
        Qf=np.broadcast_to(eye_x, (batch, nx, nx)).copy(),
        qf=r(0.1, batch, nx),
    )
    coeffs = riccati.LqrCoeffs(**{k: torch.as_tensor(v, device="cuda") for k, v in leaves.items()})
    reg = torch.as_tensor(
        np.resize(np.asarray(REG_VALUES, np.float32), batch), device="cuda")
    return coeffs, reg


def riccati_bound(nx, nu, batch, n):
    """Least time for the sweep: each input read once, each output written
    once, over the memory rate; its operations over the float32 rate."""
    floats_in = batch * n * (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu)
    floats_in += batch * (nx * nx + nx + 1)
    floats_out = batch * n * (nx * nu + nu) + batch * (n + 1) * (nx * nx + nx) + 2 * batch
    nbytes = 4 * (floats_in + floats_out)
    per_node = (
        4 * nx * nx + 2 * nx * nu              # S b, A' sv, B' sv
        + 2 * nx * nx * nu + 2 * nx ** 3       # S B, S A
        + 2 * nx * nu * nu + 2 * nx * nx * nu  # B' sB, B' sA
        + 2 * nx ** 3                          # A' sA
        + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)  # Cholesky, solves
        + 2 * nu * nu * (nx + 1)               # Quu_hat K, Quu_hat kff
        + 6 * nx * nx * nu + 6 * nx * nu       # S and s updates
        + 2 * nx * nx + 4 * nu                 # symmetrize, dv1, dv2
    )
    flops = batch * n * per_node
    t_bytes, t_flops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return {
        "bytes": nbytes, "flops": flops,
        "bound_ms": 1e3 * max(t_bytes, t_flops),
        "bound_by": "bytes" if t_bytes >= t_flops else "operations",
    }


def time_ms(torch, fn, reps, warmup):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def check_kernel(torch, riccati, riccati_cuda, shape, seed, timed):
    nx, nu, batch, n = shape
    coeffs, reg = random_lq(torch, riccati, nx, nu, batch, n, seed)
    out = riccati.lqr_backward(coeffs, reg)
    torch.cuda.synchronize()
    ref = riccati.lqr_backward(coeffs, reg, force_plain=True)
    torch.cuda.synchronize()
    max_err, bad = 0.0, []
    for f in ref._fields:
        a, b = getattr(out, f), getattr(ref, f)
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            bad.append(f)
            continue
        err = (a - b).abs()
        max_err = max(max_err, float(err.max()))
        if not bool((err <= ATOL + RTOL * b.abs()).all()):
            bad.append(f)
    rec = {
        "phase": "kernel_check", "kernel": "riccati_backward",
        "nx": nx, "nu": nu, "B": batch, "N": n,
        "max_abs_err": max_err, "rtol": RTOL, "atol": ATOL, "ok": not bad,
    }
    if timed:
        rec.update(riccati_bound(nx, nu, batch, n))
        rec["kernel_ms"] = time_ms(
            torch, lambda: riccati.lqr_backward(coeffs, reg), reps=20, warmup=3)
        # The launch alone, on operands already in the kernel's layout: the
        # rest of kernel_ms is the wrapper's ten layout copies.
        ops = riccati_cuda.to_batch_minor(coeffs, reg, batch)
        rec["sweep_only_ms"] = time_ms(
            torch, lambda: riccati_cuda.launch_batch_minor(ops, batch, n, nx, nu),
            reps=20, warmup=3)
        # The plain version is a Python loop of small launches; 3 runs do.
        rec["plain_ms"] = time_ms(
            torch, lambda: riccati.lqr_backward(coeffs, reg, force_plain=True),
            reps=3, warmup=1)
    emit(rec)
    if bad:
        raise SystemExit(f"riccati_backward disagrees with its plain version at {shape}: {bad}")
    return rec


def main_path(torch, riccati_cuda):
    from ocs2_tpu_torch.models import ballbot
    from ocs2_tpu_torch.oc.metrics import evaluate_trajectory
    from ocs2_tpu_torch.oc.rollout import open_loop_policy, rollout
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.solvers import ddp

    batch, n, max_it, solves = 4096, 32, 8, 3
    problem = ballbot.make_problem()
    params = ballbot.make_params()
    grid = uniform_grid(0.0, 1.0, n)
    settings = ddp.DdpSettings(algorithm="ilqr", max_iterations=max_it)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        (0.1 * rng.standard_normal((batch, ballbot.NX))).astype(np.float32), device="cuda")

    def solve(x0, **kw):
        sol = ddp.solve(problem, grid, x0, params, settings=settings, **kw)
        torch.cuda.synchronize()
        return sol

    solve(x0s)  # warm-up
    riccati_cuda.launch_count = 0
    seconds, sols = [], []
    for _ in range(solves):
        t0 = time.perf_counter()
        sols.append(solve(x0s))
        seconds.append(time.perf_counter() - t0)
    launches = riccati_cuda.launch_count
    sol = sols[-1]

    sweeps_run = sum(int(s.iterations.max()) for s in sols)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert sol.xs.shape == (batch, n + 1, ballbot.NX) and sol.us.shape == (batch, n, ballbot.NU)
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    # Merit never rises: the final merit against that of the initial rollout.
    xs0, us0 = rollout(
        problem, grid, x0s,
        open_loop_policy(torch.zeros((n, ballbot.NU), device="cuda")), params)
    merit0 = evaluate_trajectory(problem, grid, xs0, us0, params).cost
    assert bool((sol.performance.merit <= merit0 * (1 + 1e-6)).all())
    merit_drop = float((sol.performance.merit / merit0).mean())

    # The same solve with the kernel's plain version, first 256 scenarios.
    sub = x0s[:256]
    k_sol, p_sol = solve(sub), solve(sub, force_plain_riccati=True)
    assert bool((k_sol.iterations == p_sol.iterations).all()), "iteration counts differ"
    err = {}
    for f in ("xs", "us"):
        a, b = getattr(k_sol, f), getattr(p_sol, f)
        err[f] = float((a - b).abs().max())
        assert bool(((a - b).abs() <= 1e-3 + 1e-4 * b.abs()).all()), (f, err[f])

    sec = statistics.median(seconds)
    rec = {
        "phase": "main_path", "problem": "ballbot", "algorithm": "ilqr",
        "B": batch, "N": n, "nx": ballbot.NX, "nu": ballbot.NU,
        "max_iterations": max_it, "solves_timed": solves,
        "seconds_per_solve": sec, "solves_per_s": batch / sec,
        "mean_iterations": float(sol.iterations.float().mean()),
        "converged_share": float(sol.converged.float().mean()),
        "final_over_initial_merit": merit_drop,
        "riccati_launches": launches,
        "kernel_vs_plain_solve_max_abs_err": err,
        "peak_device_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    emit(rec)
    return rec


def profile_main_path(torch):
    """Where one iLQR iteration of the main path spends its time: host-clock
    medians of each stage (each ends in a synchronise), and the card's busy
    share over one whole solve from torch.profiler."""
    from ocs2_tpu_torch.models import ballbot
    from ocs2_tpu_torch.oc.approx import approximate_lq
    from ocs2_tpu_torch.oc.metrics import evaluate_trajectory
    from ocs2_tpu_torch.oc.rollout import ddp_search_policy, open_loop_policy, rollout
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.ops import riccati
    from ocs2_tpu_torch.solvers import ddp

    batch, n = 4096, 32
    problem, params, grid = ballbot.make_problem(), ballbot.make_params(), uniform_grid(0.0, 1.0, n)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        (0.1 * rng.standard_normal((batch, ballbot.NX))).astype(np.float32), device="cuda")
    us0 = torch.zeros((batch, n, ballbot.NU), device="cuda")
    alphas = 0.5 ** torch.arange(8, dtype=torch.float32, device="cuda")

    def timed(fn, reps=3):
        out, secs = None, []
        for i in range(reps + 1):  # first run warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            if i:
                secs.append(time.perf_counter() - t0)
        return out, 1e3 * statistics.median(secs)

    stages = {}
    (xs, us), stages["initial_rollout_ms"] = timed(
        lambda: rollout(problem, grid, x0s, open_loop_policy(us0), params))
    lq, stages["approximate_lq_ms"] = timed(lambda: approximate_lq(problem, grid, xs, us, params))
    coeffs = ddp._lq_to_coeffs(lq)
    reg = torch.full((batch,), 1e-6, device="cuda")
    sol, stages["riccati_backward_ms"] = timed(lambda: riccati.lqr_backward(coeffs, reg))
    policy = ddp_search_policy(us, sol.kff, sol.gains, xs, alphas)
    x0c = x0s[:, None, :].expand(batch, 8, ballbot.NX)
    (xs_c, us_c), stages["line_search_rollout_ms"] = timed(
        lambda: rollout(problem, grid, x0c, policy, params))
    _, stages["evaluate_candidates_ms"] = timed(
        lambda: evaluate_trajectory(problem, grid, xs_c, us_c, params))

    settings = ddp.DdpSettings(algorithm="ilqr", max_iterations=8)
    busy = None
    try:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ddp.solve(problem, grid, x0s, params, settings=settings)
            torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
        dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
        if dev_us > 0:
            busy = {"device_busy_us": dev_us, "wall_us_under_profiler": wall_us,
                    "device_busy_share": dev_us / wall_us}
    except Exception as exc:  # the profiler is optional equipment of the machine
        busy = {"error": repr(exc)}
    emit({"phase": "profile", "B": batch, "N": n, "stages": stages,
          "profiler": busy if busy is not None else "not measured"})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--verbose-build", action="store_true",
                    help="print ptxas' registers / spills per kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also time the stages of one iteration of the main path")
    ap.add_argument("--skip-main-path", action="store_true",
                    help="build and check the kernels only (no final ok line)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from ocs2_tpu_torch.ops import riccati, riccati_cuda

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    pairs = sorted({(nx, nu) for nx, nu, _, _ in KERNEL_SHAPES})
    riccati_cuda.build(pairs, verbose=args.verbose_build)
    emit({"phase": "build", "libraries": [f"nx{a}_nu{b}" for a, b in pairs],
          "seconds": time.perf_counter() - t0})

    emit({"phase": "kernels", "kernels": ["riccati_backward"],
          "shapes": [list(s) for s in KERNEL_SHAPES]})
    checks = [
        check_kernel(torch, riccati, riccati_cuda, shape, seed=11 + i, timed=i < 3)
        for i, shape in enumerate(KERNEL_SHAPES)
    ]
    if args.skip_main_path:
        return 0

    run = main_path(torch, riccati_cuda)
    if args.profile:
        profile_main_path(torch)

    at_main = checks[0]
    emit({"kernels": [{
        "name": "riccati_backward", "route": "cuda",
        "source": "ocs2_tpu_torch/csrc/riccati_backward.cu",
        "replaces": "ocs2_tpu/ops/riccati_pallas.py:189",
        "launches": run["riccati_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "shape": dict(zip(("nx", "nu", "B", "N"), MAIN_SHAPE)),
        "ms": at_main["kernel_ms"], "sweep_only_ms": at_main["sweep_only_ms"],
        "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
        "library_ms": None,
        "other_shapes": [
            {k: c[k] for k in ("nx", "nu", "B", "N", "kernel_ms", "sweep_only_ms",
                               "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for c in checks[1:3]
        ],
    }]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
