#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ocs2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one card and nvcc

Builds every CUDA kernel of the port from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives the port's
main paths and checks that they went through the kernels.  K10
(``csrc/lq_srbd.cu``, the legged SRBD problem's whole LQ approximation) is
held against the generic ``_approximate_lq_generic`` at (B, N) = (1, 100),
(256, 100) and (4096, 100) in both variants (the soft cone's problem, and
the hard cone's that ``ipm.solve`` approximates), every leaf of LQData, and
timed beside its bytes bound; the legged SQP lanes below (the B = 1 tick,
b256, the closed loop, the entry step) and the IPM lanes (hard cone) count
its launches, one an SQP or IPM iteration with no generic call.  The lanes:

* ``ddp.solve`` (iLQR) on the ballbot problem, a batch of 4096 scenarios,
  32 intervals;
* ``sqp.solve`` on the legged-robot problem (SRBD, nx = nu = 24, 100 intervals
  over 1 s, rk2, trot, soft friction cone, projected 12-row foot constraint,
  10 iterations at most): the control-rate tick at B = 1 as chains of
  receding-horizon ticks, and a batch of 256 scenarios; the backward sweep of
  both is the CUDA kernel at (nx, nu) = (24, 12), with strict pivots at B = 1;
* the MPC runtime in closed loop: ``Mpc`` (the same legged SQP at N = 100,
  ``SwitchedModelReferenceManager`` on a 0.7 s trot) in ``MpcMrtInterface``,
  driven by ``dummy_loop`` for 0.2 s at 400 Hz control and 50 Hz MPC (10
  ticks, 80 control steps); each tick's sweep is the kernel at
  (1, 100, 24, 12) with strict pivots, one launch per SQP iteration;
* ``sqp.solve`` on the quadrotor (nx = 12, nu = 4), a batch of 4096 hover
  scenarios, 40 intervals over 2 s, rk4, 8 iterations at most; the sweep is
  the kernel at (12, 4) with clamped pivots;
* the perceptive lane: ``terrain_check`` (the elevation-map problem's LQ
  approximation, its SDF and 1,000 height / plane queries, card against
  CPU); ``perceptive_mpc`` (the segmented-planes problem on a decomposed
  stepped map, N = 46 over 1.4 s, a host foothold re-plan and one solve per
  tick, 4 ticks); ``perceptive_closed_loop`` (``Mpc`` with the
  ``PerceptiveReferenceManager`` in ``dummy_loop``, N = 32, 2 s at 60 Hz
  control and 15 Hz MPC); the sweep of both is the kernel at (24, 12) with
  strict pivots;
* the ComKino lane (the full kinodynamic model): ``comkino_perceptive_closed_loop``
  (``Mpc`` with the ``PerceptiveReferenceManager`` on the segmented problem of
  the ComKino model, N = 32, 1 s at 50 Hz control and 12.5 Hz MPC) and
  ``comkino_trot`` (one cold trot solve at N = 40, 8 iterations); the sweep of
  both is the kernel at (24, 12) with strict pivots;
* the interior-point solver on the flagship problem with the hard friction
  cone (the barrier's inequality; the foot constraint projected, N = 100,
  15 iterations at most): ``legged_ipm_tick_b1`` (a cold solve from the
  weight-compensating guess, then a chain of 2 receding-horizon ticks; the
  kernel at (1, 100, 24, 12) with strict pivots and K10's hard variant, one
  launch each per IPM iteration) and ``legged_ipm_b256`` (the b256 lane's scenarios; the kernel
  at (256, 100, 24, 12), clamped), each held against the sweep's torch-op
  routes;
* SLP (``slp.solve``: SQP with the PIPG inner solver, ``ops/pipg.py``) on the
  ballbot problem for 256 of the main path's scenarios, held against the JAX
  package's SLP on them (a record in ``tests/torch_data/``), ``sqp.solve``
  beside it (the kernel at (256, 32, 10, 3)), and the torch launches of one
  PIPG iteration counted by the profiler;
* the DDP family: ``slq_ballbot_b4096`` (``ddp.solve`` with
  ``algorithm="slq"`` on the main path's batch; the sweep is the
  continuous-time Riccati kernel ``csrc/riccati_ct_backward.cu`` at
  (10, 3, 4096, 32), one launch a loop iteration, held against its plain
  version), ``hybrid_bouncing_mass`` (``solve_state_triggered`` on the
  bouncing mass at B = 1, the discrete kernel at (2, 1, 1, 46) with strict
  pivots, held against the JAX package's record in ``tests/torch_data/``) and
  ``switch_time_exp0`` (``optimize_switch_times`` with SQP on a switched
  linear system, the discrete kernel at (2, 1, 1, 40)); ``slq_ballbot_b4096``
  also holds its first 64 scenarios against the JAX package's record;
* the robot model zoo: ``cartpole_swingup_b4096`` (4,096 swing-ups from
  scattered starts, N = 60: SLQ through the continuous-time kernel at
  (4, 1, 4096, 60) and iLQR with the hard input bound through the discrete
  kernel there), ``manipulator_sqp_b1`` (the mobile manipulator's SQP with
  self-collision at N = 40, two targets at B = 1, the kernel at
  (1, 40, 9, 8) with strict pivots), ``manipulator_sqp_b256`` (256 EE
  targets in one batch, the kernel at (256, 40, 9, 8)) and
  ``urdf_variants_b1`` (the franka on four base types and the UR5 on two,
  the kernel at (7, 7) ... (13, 13) with strict pivots), each held against
  the JAX package's records in ``tests/torch_data/``;
* loopshaping (the frequency-shaped legged MPC: one low-pass filter state
  per input, nx = 48): ``loopshaping_trot_b1`` (SQP on the loopshaped trot
  at N = 40, rk2 with 2 substeps, 12 iterations, the kernel at
  (1, 40, 48, 12) with strict pivots; beside it the unshaped solve of the
  same task at (1, 40, 24, 12), whose shaping functional the shaped solve
  must undercut) and ``loopshaping_closed_loop`` (``Mpc`` in ``dummy_loop``,
  N = 28, 12.5 Hz MPC and 50 Hz control for 0.48 s, the kernel at
  (1, 28, 48, 12)), both held against the JAX package's record in
  ``tests/torch_data/``;
* MPC-Net (``ocs2_tpu_torch/learning/``), trained on the card:
  ``mpcnet_legged_train`` (``make_legged_mpcnet()``: a mixture of 3 linear
  experts, 4 scenarios x 4 control steps a round, 2 rounds of 150 Adam
  steps, each control step one batched SQP solve through the kernel at
  (4, 14, 24, 12) with clamped pivots, ``evaluate`` at (1, 14, 24, 12)
  strict), ``mpcnet_legged_datagen_b256`` (one data round of 256 scenarios,
  the kernel at (256, 14, 24, 12), then 20 Adam steps) and
  ``mpcnet_ballbot_train`` (``make_ballbot_mpcnet()``: 8 scenarios x 6
  steps, 3 rounds of 200 Adam steps, the kernel at (8, 16, 10, 3)), each
  round 0 held against the JAX package's record in ``tests/torch_data/``
  and the trained policies against the JAX tests' criteria;
* the associative-scan Riccati (K7, ``ops/riccati.lqr_backward_parallel``:
  torch ops, no kernel): ``parallel_riccati_check`` (K7 at (24, 12, 1, 100),
  (24, 12, 256, 100) and (10, 3, 4096, 32), held against K1 and the plain
  version, timed beside K1), ``legged_parallel_riccati_b1`` (the flagship
  SQP at N = 100 with ``parallel_riccati=True``: K1 launched no time, held
  against the JAX package's record and the K1 route) and
  ``ballbot_ilqr_parallel_b4096`` (main_path's batch with K7, held against
  the K1 route and, on its first 64 scenarios, the JAX record);
  ``sqp_phase_profile`` (``utils/profiling.profile_sqp_phases`` on the entry
  step's problem, K1 in its ``riccati_seq`` phase); ``entry_step``
  (``ocs2_tpu_torch/entry.entry()``'s step, the flagship SQP at N = 32, K1 at
  (1, 32, 24, 12) strict, held against the JAX record of
  ``__graft_entry__.entry()``); ``dryrun_multichip`` (``dryrun_multichip``
  over every card, then over four shards on cuda:0: the scenario batch
  split over the mesh through K1 at (2, 8, 24, 12), the horizon-sharded PIPG
  (K9, ``parallel/horizon.py``) held against ``pipg_solve``, the SQP with
  ``qp_solver="pipg_sharded"`` against ``"pipg"``).

Each phase prints one JSON line; the last line is
``{"ok": true, "device": {...}}``.  The continuous-time kernel's
``kernel_check`` lines also give its launch geometry (``blocks_per_sm`` and
``waves`` from the library's occupancy probe), its time per call through the
wrapper and over calls queued back to back, and at the SLQ lane's shape the
time at B = 3,696 beside B = 4,096 (``wave_check``).  Exits non-zero without a
result when there is no CUDA device or when any phase fails.  Imports neither JAX nor the JAX
package.

Peak rates used for the bounds: 3.35 TB/s of device memory and 67 TFLOP/s of
float32 outside the tensor cores (NVIDIA H100 SXM data sheet); the latencies
of the dependent chain are stated at ``riccati_bound`` and
``riccati_ct_bound``.  The build line gives ptxas' registers and spill of
every library it built.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# For the floor set by the chain of dependent nodes (see riccati_bound).
BOOST_CLOCK_HZ = 1.98e9
FMA_CYCLES, SPECIAL_CYCLES, EXCHANGE_CYCLES = 4, 18, 23
RTOL, ATOL = 2e-4, 1e-5  # float32 reassociation: the k-accumulation order differs

# (nx, nu, B, N): the three production shapes of the Riccati sweep (ballbot
# iLQR batch, quadrotor SQP batch, legged SQP batch), one ragged batch, and
# one ragged batch with more inputs than states.
KERNEL_SHAPES = [(10, 3, 4096, 32), (12, 4, 4096, 40), (24, 12, 256, 100), (10, 3, 1000, 8),
                 (3, 5, 77, 6)]
MAIN_SHAPE = KERNEL_SHAPES[0]
QUAD_SHAPE = KERNEL_SHAPES[1]
LEGGED_SHAPE = KERNEL_SHAPES[2]
# The control-rate tick: one scenario, strict pivots (NaN, not a clamp, on a
# Quu_hat that is not positive definite).
STRICT_SHAPE = (24, 12, 1, 100)
DEVICE = "cuda"  # every phase runs on the card; main() refuses to start without one
# Whole solves: the kernel's route against its plain version's.
SOLVE_ATOL, SOLVE_RTOL = 1e-3, 1e-4
REG_VALUES = (0.0, 1e-6, 0.1, 2.0)
# Timed solves after the warm-up in main_path, legged_tick_b256,
# quadrotor_sqp_b4096, comkino_trot and slq_ballbot_b4096: one (three until
# the loopshaping phases took the script past its time target, PERF.md §4).
TIMED_SOLVES = 1


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def random_lq(torch, riccati, nx, nu, batch, n, seed):
    """Numpy-seeded LQ data on the card (random_lq_numpy) and REG_VALUES
    repeated over the batch."""
    leaves, reg = random_lq_numpy(nx, nu, batch, n, seed)
    coeffs = riccati.LqrCoeffs(**{k: torch.as_tensor(v, device="cuda") for k, v in leaves.items()})
    return coeffs, torch.as_tensor(reg, device="cuda")


def random_lq_numpy(nx, nu, batch, n, seed):
    """Numpy-seeded LQ data: A ~ I, PD Quu, small couplings; leaves [B, N, ...]
    and the per-scenario reg, as numpy float32."""
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
    return leaves, np.resize(np.asarray(REG_VALUES, np.float32), batch)


def riccati_bound(nx, nu, batch, n):
    """Least time for the sweep, the largest of three floors.

    * bytes: each input read once, each output written once, over the memory
      rate;
    * flops: its operations over the card's float32 rate, each symmetric
      product (A' S A, B' S B, the S update) counted at its upper triangle;
    * chain: node k needs S of node k + 1, so the N nodes follow one another
      whatever the batch, and inside a node so do: the two dot products of
      length nx that feed Quu_hat (S B, then B' (S B)), nu pivot steps (a
      reciprocal or square root, a multiply-add, and the pivot row handed to
      the other threads), two triangular solves of depth nu, and the two dot
      products of length nu of the S update (Quu_hat K, then K' (Quu_hat K)).
      Assumed: a dot product of length m is a multiply and a tree of
      ceil(log2 m) adds; a dependent multiply-add takes 4 cycles, a
      special-function operation 18, a hand-over between threads (shared
      memory or shuffle round trip) 23, at the 1.98 GHz boost clock.  These
      are the least the card's pipelines allow, not what a kernel reaches.

    Beside the bound, ``design_floor_ms``: the same floors with the flops over
    the rate of the SMs this kernel's launch occupies (one block a scenario,
    so min(blocks, 132) / 132 of the card's peak; one SM's at B = 1).  It is
    a floor of this design, not of the card: another design could spread a
    scenario over several SMs."""
    floats_in = batch * n * (2 * nx * nx + 2 * nx * nu + nu * nu + 2 * nx + nu)
    floats_in += batch * (nx * nx + nx + 1)
    floats_out = batch * n * (nx * nu + nu) + batch * (n + 1) * (nx * nx + nx) + 2 * batch
    nbytes = 4 * (floats_in + floats_out)
    per_node = (
        4 * nx * nx + 2 * nx * nu              # S b, A' sv, B' sv
        + 2 * nx * nx * nu + 2 * nx ** 3       # S B, S A
        + nx * nu * (nu + 1) + 2 * nx * nx * nu  # B' sB (symmetric), B' sA
        + nx * nx * (nx + 1)                   # A' sA (symmetric)
        + nu ** 3 // 3 + 2 * nu * nu * (nx + 1)  # Cholesky, solves
        + 2 * nu * nu * (nx + 1)               # Quu_hat K, Quu_hat kff
        # S update: K' (Quu_hat K) and K' Qux + Qux' K, both symmetric; s update
        + 3 * nx * (nx + 1) * nu + 6 * nx * nu
        + 2 * nx * nx + 4 * nu                 # symmetrize, dv1, dv2
    )
    flops = batch * n * per_node
    from ocs2_tpu_torch.ops import riccati_cuda

    blocks = riccati_cuda.launch_geometry(nx, nu, batch).blocks
    sm_share = min(blocks, riccati_cuda.NUM_SMS) / riccati_cuda.NUM_SMS
    dot = lambda m: FMA_CYCLES * (1 + (m - 1).bit_length())  # noqa: E731
    chain_cycles = n * (
        2 * dot(nx) + EXCHANGE_CYCLES
        + nu * (SPECIAL_CYCLES + FMA_CYCLES + EXCHANGE_CYCLES)
        + 2 * nu * FMA_CYCLES
        + 2 * dot(nu) + EXCHANGE_CYCLES
    )
    terms = {
        "bytes": nbytes / PEAK_BYTES_PER_S, "flops": flops / PEAK_F32_FLOPS,
        "chain": chain_cycles / BOOST_CLOCK_HZ,
    }
    term = max(terms, key=terms.get)
    return {
        "bytes": nbytes, "flops": flops, "chain_cycles": chain_cycles,
        "bytes_ms": 1e3 * terms["bytes"], "flops_ms": 1e3 * terms["flops"],
        "chain_ms": 1e3 * terms["chain"],
        "bound_ms": 1e3 * terms[term],
        "design_floor_ms": 1e3 * max(terms["bytes"], terms["flops"] / sm_share,
                                     terms["chain"]),
        # The chain is a floor of operations (their latency, not their rate).
        "bound_by": "bytes" if term == "bytes" else "operations", "bound_term": term,
    }


def time_ms_queued(torch, fn, reps, warmup):
    """Mean time of one call over `reps` calls queued back to back between
    one pair of CUDA events: the kernel's own time where the host enqueues
    faster than the card runs (time_ms also counts the host's work before
    each launch, which the card waits for)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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


def compare_fields(torch, out, ref, nan_equal=False):
    """(largest absolute difference, names of the fields that disagree): equal
    shapes, contiguous results, every entry within ATOL + RTOL |ref|.  With
    nan_equal the NaN entries must be the same ones, element for element, and
    the others are compared; without it every entry must be finite."""
    max_err, bad = 0.0, []
    for f in ref._fields:
        a, b = getattr(out, f), getattr(ref, f)
        if a.shape != b.shape or not a.is_contiguous():
            bad.append(f)
            continue
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        if not (bool(torch.equal(nan_a, nan_b)) if nan_equal else not bool(nan_a.any())):
            bad.append(f)
            continue
        keep = ~nan_b
        err = (a - b).abs()[keep]
        if err.numel():
            max_err = max(max_err, float(err.max()))
        if not bool(torch.isfinite(a[keep]).all()) or not bool(
                (err <= ATOL + RTOL * b.abs()[keep]).all()):
            bad.append(f)
    return max_err, bad


def check_kernel(torch, riccati, riccati_cuda, shape, seed, timed):
    """The kernel, through the entry point the solvers call, against its plain
    version on the same data: clamped pivots for a batch, strict ones (also
    against the single-scenario sweep) for a batch of one."""
    nx, nu, batch, n = shape
    strict = batch == 1
    coeffs, reg = random_lq(torch, riccati, nx, nu, batch, n, seed)
    before = riccati_cuda.launch_count
    out = riccati.lqr_backward(coeffs, reg)
    torch.cuda.synchronize()
    assert riccati_cuda.launch_count == before + 1
    geometry = riccati_cuda.launch_geometry(nx, nu, batch)
    plain = lambda: riccati._lqr_backward_batched(coeffs, reg, strict=strict)  # noqa: E731
    max_err, bad = compare_fields(torch, out, plain())
    rec = {
        "phase": "kernel_check", "kernel": "riccati_backward", "pivots":
        "strict" if strict else "clamp", "nx": nx, "nu": nu, "B": batch, "N": n,
        "blocks": geometry.blocks, "threads": geometry.threads,
        "shared_bytes": geometry.shared_bytes,
    }
    if strict:
        single = lambda: riccati.lqr_backward(coeffs, reg, force_single=True)  # noqa: E731
        err_single, bad_single = compare_fields(torch, out, single())
        max_err, bad = max(max_err, err_single), bad + [f"single:{f}" for f in bad_single]
    rec.update({"max_abs_err": max_err, "rtol": RTOL, "atol": ATOL, "ok": not bad})
    if timed:
        rec.update(riccati_bound(nx, nu, batch, n))
        rec["kernel_ms"] = time_ms(
            torch, lambda: riccati.lqr_backward(coeffs, reg), reps=20, warmup=3)
        rec["kernel_ms_queued"] = time_ms_queued(
            torch, lambda: riccati.lqr_backward(coeffs, reg), reps=20, warmup=3)
        # The plain version and the single sweep are Python loops of small
        # launches: 3 timed runs each, after the comparison's run (their
        # warm-up).
        rec["plain_ms"] = time_ms(torch, plain, reps=3, warmup=0)
        if strict:
            rec["single_sweep_ms"] = time_ms(torch, single, reps=3, warmup=0)
    emit(rec)
    if bad:
        raise SystemExit(f"riccati_backward disagrees with its plain version at {shape}: {bad}")
    return rec


def check_strict_nan(torch, riccati, shape, seed, node):
    """Strict pivots on a Quu that is not positive definite at one node: the
    kernel's NaN entries must be those of its plain version and of the
    single-scenario sweep, element for element (that node and every earlier
    one, dv1, dv2), and the finite entries agree."""
    nx, nu, batch, n = shape
    coeffs, reg = random_lq(torch, riccati, nx, nu, batch, n, seed)
    coeffs.Quu[:, node] = -100.0 * torch.eye(nu, device=DEVICE)
    out = riccati.lqr_backward(coeffs, reg)
    torch.cuda.synchronize()
    refs = {
        "plain": riccati._lqr_backward_batched(coeffs, reg, strict=True),
        "single": riccati.lqr_backward(coeffs, reg, force_single=True),
    }
    max_err, bad = 0.0, []
    for name, ref in refs.items():
        err, bad_fields = compare_fields(torch, out, ref, nan_equal=True)
        max_err, bad = max(max_err, err), bad + [f"{name}:{f}" for f in bad_fields]
    nan_nodes = int(torch.isnan(out.gains).all(dim=(2, 3)).sum())
    if nan_nodes != node + 1 or not bool(torch.isnan(out.dv1).all()) or not bool(
            torch.isfinite(out.gains[:, node + 1:]).all()):
        bad.append("placement")
    emit({"phase": "kernel_check", "kernel": "riccati_backward", "pivots": "strict",
          "fixture": f"Quu = -100 I at node {node}", "nx": nx, "nu": nu, "B": batch, "N": n,
          "nan_nodes": nan_nodes, "max_abs_err_of_finite": max_err, "ok": not bad})
    if bad:
        raise SystemExit(f"strict pivots: NaN placement differs at {shape}: {bad}")


def main_path(torch, riccati_cuda):
    from ocs2_tpu_torch.models import ballbot
    from ocs2_tpu_torch.oc.metrics import evaluate_trajectory
    from ocs2_tpu_torch.oc.rollout import open_loop_policy, rollout
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.solvers import ddp

    batch, n, max_it, solves = 4096, 32, 8, TIMED_SOLVES
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
    err, tied, tie_details = compare_with_ties(
        torch, solve(sub), solve(sub, force_plain_riccati=True), "ballbot kernel vs plain")

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
        "kernel_vs_plain_tied_scenarios": tied, "kernel_vs_plain_ties": tie_details,
        "peak_device_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    emit(rec)
    return rec


# -- the legged-robot SQP tick --------------------------------------------------

_, _, LEGGED_BATCH, LEGGED_N = LEGGED_SHAPE
LEGGED_HORIZON = 1.0
# K10's (B, N): the B = 1 tick and the closed loop, the b256 lane, and the
# benchmark's legged-sqp-b4096 cell; the hard variant's the same, for the IPM
# lanes and legged-ipm-b4096.
K10_SHAPES = [(1, LEGGED_N), (LEGGED_BATCH, LEGGED_N), (4096, LEGGED_N)]


def k10_inputs(torch, batch, n, seed):
    """(grid, xs, us, params) of the legged trot problem at (B, N) on the
    card, on the lanes' trot grid (jump intervals, both modes): scenario 0
    at the stand with the weight-compensating forces, the others with
    0.05 N(0, 1) on every state, 5 N(0, 1) on the forces and 0.5 N(0, 1) on
    the joint velocities, and stance forces of 1-8 N on 30 % of the feet and
    20-150 N on the rest, so that the cone rows fall on both sides of the
    barrier's delta."""
    from ocs2_tpu_torch.models.legged_robot import interface, model
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid

    rng = np.random.default_rng(seed)
    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, LEGGED_HORIZON)
    grid = make_time_grid(0.0, LEGGED_HORIZON, n, event_times=ms.event_times,
                          mode_sequence=ms.mode_sequence)
    x_stand = np.asarray(model.default_state("cpu"))
    u_stand = np.asarray(model.weight_compensating_input(np.ones(4, np.float32), "cpu"))
    x = x_stand + 0.05 * rng.standard_normal((batch, n + 1, 24))
    u = u_stand + np.concatenate([5.0 * rng.standard_normal((batch, n, 12)),
                                  0.5 * rng.standard_normal((batch, n, 12))], axis=-1)
    fz = u[..., 2:12:3]
    u[..., 2:12:3] = np.where(rng.random(fz.shape) < 0.3, rng.uniform(1.0, 8.0, fz.shape),
                              rng.uniform(20.0, 150.0, fz.shape))
    x[0], u[0] = x_stand, u_stand
    tensor = lambda v: torch.as_tensor(v.astype(np.float32), device=DEVICE)  # noqa: E731
    return grid, tensor(x), tensor(u), interface.make_params(grid, device=DEVICE)


def lq_leaves(lq):
    return {f"{name}.{f}": v for name, rec in lq._asdict().items() if rec is not None
            for f, v in rec._asdict().items() if v is not None}


def check_k10(torch, shape, seed, cone="soft"):
    """K10 through the entry point the solvers call (``approximate_lq``),
    in the variant of ``cone`` ("soft", or "hard": the problem ``ipm.solve``
    approximates, with its AL state) against its plain version
    (``_approximate_lq_generic``) on the same
    inputs: every leaf of LQData finite and within ATOL + RTOL |plain|.
    Then its time through the wrapper (median of 20 calls) and queued (20
    back to back), the plain version's (3 calls), and its bound: the bytes
    this call reads (xs, us, the per-node inputs, the weights) and writes
    (LQData) over the memory rate."""
    import math

    from ocs2_tpu_torch.models.legged_robot import interface
    from ocs2_tpu_torch.oc import approx
    from ocs2_tpu_torch.ops import lq_srbd_cuda
    from ocs2_tpu_torch.solvers import al, ipm

    batch, n = shape
    grid, xs, us, params = k10_inputs(torch, batch, n, seed)
    problem = interface.make_problem(device=DEVICE)
    if cone == "hard":
        problem = ipm.augment(interface.make_problem(friction_cone="hard", device=DEVICE), True)
        dims = problem.constraint_dims(approx.example_params(params, DEVICE), device=DEVICE)
        params = dict(params, al=al.AlState.init(dims, n, batch=(batch,), device=DEVICE))
    k10 = lambda: approx.approximate_lq(problem, grid, xs, us, params, "rk2")  # noqa: E731
    plain = lambda: approx._approximate_lq_generic(  # noqa: E731
        problem, grid, xs, us, params, "rk2")
    before, variant_calls = lq_srbd_cuda.launch_count, approx.variant_counts[cone]
    out = lq_leaves(k10())
    torch.cuda.synchronize()
    assert lq_srbd_cuda.launch_count == before + 1, "approximate_lq did not launch K10"
    assert approx.variant_counts[cone] == variant_calls + 1
    assert lq_srbd_cuda.last_launch_dims == (batch, n), lq_srbd_cuda.last_launch_dims
    ref = lq_leaves(plain())
    max_err, worst, bad = 0.0, {}, []
    if sorted(out) != sorted(ref):
        bad.append(f"leaves {sorted(out)} != {sorted(ref)}")
    for leaf in sorted(set(out) & set(ref)):
        a, b = out[leaf], ref[leaf]
        if a.shape != b.shape or not bool(torch.isfinite(a).all()):
            bad.append(leaf)
            continue
        err = (a - b).abs()
        max_err = max(max_err, float(err.max()))
        worst[leaf] = float((err / (ATOL + RTOL * b.abs())).max())
        if worst[leaf] > 1.0:
            bad.append(leaf)
    del out, ref
    nodes = problem.lq_kernel.node_inputs(grid.device(DEVICE), params)
    read = sum(t.numel() * t.element_size()
               for t in (xs, us, *nodes, *problem.lq_kernel.weights))
    written = 4 * sum(math.prod(s) for s in lq_srbd_cuda.result_shapes(batch, n, cone == "hard")
                      if s is not None)
    rec = {
        "phase": "kernel_check", "kernel": "lq_srbd", "cone": cone, "B": batch, "N": n,
        "nx": 24, "nu": 24, "method": lq_srbd_cuda.METHOD,
        "blocks": -(-batch * (n + 1) // lq_srbd_cuda.NODES_PER_BLOCK),
        "threads": lq_srbd_cuda.NODES_PER_BLOCK * lq_srbd_cuda.THREADS_PER_NODE,
        "max_abs_err": max_err, "worst_in_tolerance_units": worst, "rtol": RTOL, "atol": ATOL,
        "ok": not bad,
        "bytes": read + written, "bound_ms": 1e3 * (read + written) / PEAK_BYTES_PER_S,
        "bound_by": "bytes",
    }
    if not bad:
        rec["kernel_ms"] = time_ms(torch, k10, reps=20, warmup=3)
        rec["kernel_ms_queued"] = time_ms_queued(torch, k10, reps=20, warmup=3)
        rec["plain_ms"] = time_ms(torch, plain, reps=3, warmup=0)
    emit(rec)
    if bad:
        raise SystemExit(f"lq_srbd ({cone}) disagrees with its plain version at {shape}: {bad}")
    return rec


def k10_reset():
    """Zero K10's launch counter just before a lane; returns the path counts
    of ``approximate_lq`` then, for k10_took_every_approximation."""
    from ocs2_tpu_torch.oc import approx
    from ocs2_tpu_torch.ops import lq_srbd_cuda

    lq_srbd_cuda.launch_count, lq_srbd_cuda.last_launch_dims = 0, None
    return dict(approx.path_counts)


def k10_took_every_approximation(before, sweeps, dims, what):
    """The lane's LQ approximations, one an SQP or IPM iteration (one a
    sweep), all went through K10 at ``dims`` since k10_reset returned
    ``before``; returns its launches."""
    from ocs2_tpu_torch.oc import approx
    from ocs2_tpu_torch.ops import lq_srbd_cuda

    launches, last_dims = lq_srbd_cuda.launch_count, lq_srbd_cuda.last_launch_dims
    generic = approx.path_counts["generic"] - before["generic"]
    assert launches == sweeps and generic == 0, (what, launches, sweeps, generic)
    assert last_dims == dims, (what, last_dims)
    return launches


def legged_setup(torch):
    """Problem, grid, params, cold-start inputs and settings of the flagship
    tick: trot with a 0.7 s cycle over a 1 s horizon of 100 intervals."""
    from ocs2_tpu_torch.models.legged_robot import interface, model
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid
    from ocs2_tpu_torch.solvers import sqp

    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, LEGGED_HORIZON)
    grid = make_time_grid(0.0, LEGGED_HORIZON, LEGGED_N, event_times=ms.event_times,
                          mode_sequence=ms.mode_sequence)
    u0 = model.weight_compensating_input(np.ones(4, np.float32), DEVICE)
    return {
        "problem": interface.make_problem(device=DEVICE), "grid": grid,
        "params": interface.make_params(grid, device=DEVICE),
        "x0": model.default_state(DEVICE),
        "us_init": u0[None].expand(LEGGED_N, model.NU).contiguous(),
        "settings": sqp.SqpSettings(max_iterations=10, integrator="rk2"),
    }


def legged_solve(cfg, x0, us_init, **kw):
    from ocs2_tpu_torch.solvers import sqp

    return sqp.solve(cfg["problem"], cfg["grid"], x0, cfg["params"], us_init=us_init,
                     xs_init=cfg.get("xs_init"), settings=cfg["settings"], device=DEVICE, **kw)


def check_legged_solution(torch, cfg, sol, what):
    """Finite trajectories, at least one iteration, every accepted step passed
    the filter (merit or total violation fell from one history row to the
    next; the projected problem has no multiplier update between rows), and
    the projected foot constraint holds at every node of the result."""
    from ocs2_tpu_torch.models.legged_robot import constraints
    from ocs2_tpu_torch.oc.approx import node_params

    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all()), what
    assert int(sol.iterations.min()) >= 1, what
    h = sol.history
    ran = torch.arange(h.merit.shape[1], device=h.merit.device)[None, 1:] < sol.iterations[:, None]
    fell = (h.merit[:, 1:] < h.merit[:, :-1]) | (h.total_viol[:, 1:] < h.total_viol[:, :-1])
    assert bool((fell | (h.step_size[:, 1:] == 0) | ~ran).all()), f"{what}: filter"
    grid = cfg["grid"].device(DEVICE)
    nodes = torch.arange(LEGGED_N, device=DEVICE)
    g = constraints.foot_constraint(
        grid.times[:-1], sol.xs[:, :-1], sol.us, node_params(cfg["params"], grid, nodes))
    worst = float(g.abs().max())
    assert worst <= 1e-3, f"{what}: |foot_constraint| = {worst}"
    return worst


# Chains of the legged tick at B = 1: one of 4 ticks (two chains until the
# loopshaping phases and 8 ticks until the MPC-Net phases took the script past
# its time target, PERF.md §4).
B1_CHAINS, B1_TICKS_PER_CHAIN = 1, 4


def legged_tick_b1(torch, riccati_cuda, cfg, chains=B1_CHAINS, ticks_per_chain=B1_TICKS_PER_CHAIN):
    """The control-rate tick: chains of dependent receding-horizon ticks (the
    next tick starts at the solved xs[1], warm-started with the solved
    inputs), one synchronise per chain.  Its backward sweep is the CUDA kernel
    with strict pivots, one launch per SQP iteration."""
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    k10_before = k10_reset()
    t0 = time.perf_counter()
    cold = legged_solve(cfg, cfg["x0"], cfg["us_init"])  # also the warm-up
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    check_legged_solution(torch, cfg, cold, "b1 cold tick")

    x, us = cfg["x0"], cfg["us_init"]
    chain_s, ticks, worst_g = [], [], 0.0
    for _ in range(chains):
        sols = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks_per_chain):
            sol = legged_solve(cfg, x, us)
            x, us = sol.xs[0, 1], sol.us[0]
            sols.append(sol)
        torch.cuda.synchronize()
        chain_s.append(time.perf_counter() - t0)
        for sol in sols:
            worst_g = max(worst_g, check_legged_solution(torch, cfg, sol, "b1 tick"))
            ticks.append(sol)
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    sweeps_run = int(cold.iterations[0]) + sum(int(s.iterations[0]) for s in ticks)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert dims == (1, LEGGED_N, 24, 12), dims
    k10_launches = k10_took_every_approximation(k10_before, sweeps_run, (1, LEGGED_N), "b1")
    # The cold tick once more through the single-scenario sweep of torch ops.
    single = legged_solve(cfg, cfg["x0"], cfg["us_init"], force_single_riccati=True)
    torch.cuda.synchronize()
    assert riccati_cuda.launch_count == launches, "the single-sweep route launches no kernel"
    err_single = compare_solves(torch, cold, single, "b1 kernel vs single sweep")
    per_tick_ms = [1e3 * s / ticks_per_chain for s in chain_s]
    last = ticks[-1].performance
    rec = {
        "phase": "legged_tick_b1", "B": 1, "N": LEGGED_N, "nx": 24, "nu": 24,
        "max_iterations": cfg["settings"].max_iterations, "chains": chains,
        "ticks_per_chain": ticks_per_chain,
        "tick_ms_median": statistics.median(per_tick_ms), "tick_ms_worst": max(per_tick_ms),
        "ticks_per_s": 1e3 / statistics.median(per_tick_ms),
        "cold_tick_ms_first_call": 1e3 * cold_s, "cold_tick_iterations": int(cold.iterations[0]),
        "iterations_per_tick": [int(s.iterations[0]) for s in ticks],
        "converged_per_tick": [bool(s.converged[0]) for s in ticks],
        "dynamics_violation_sse": float(last.dynamics_violation_sse[0]),
        "equality_constraints_sse": float(last.equality_constraints_sse[0]),
        "worst_abs_foot_constraint": worst_g, "riccati_launches": launches,
        "kernel_dims": list(dims), "kernel_vs_single_sweep_solve_max_abs_err": err_single,
        "k10_launches": k10_launches,
    }
    emit(rec)
    return rec, cold


def compare_with_ties(torch, k_sol, p_sol, what, max_tied_share=0.02, force_atol=None,
                      joint_atol=None):
    """The kernel route's batch solve against the plain version's.

    A scenario whose two routes stop at the same merit to float32 rounding
    but after different numbers of iterations is a tie: at that floor no
    candidate can fall by the Armijo margin, so whether the last accepted step
    already sat on it is decided by the last bit (one route then runs to the
    budget without moving).  Ties are counted and held to max_tied_share of
    the scenarios, to equal merits and to the tolerance in xs; every other
    scenario must agree in iterations, xs and us.  With ``force_atol`` the
    legged robot's contact forces (the first 12 inputs) are held to it in
    place of SOLVE_ATOL, with ``joint_atol`` its joint velocities (the last
    12).  Returns (largest differences, number of ties, the differing
    scenarios)."""
    differ = k_sol.iterations != p_sol.iterations
    k_merit, p_merit = k_sol.performance.merit, p_sol.performance.merit
    rel = (k_merit - p_merit).abs() / p_merit.abs().clamp(min=1e-30)
    tied = differ & (rel <= 1e-6)
    rows = torch.nonzero(differ).flatten().tolist()
    details = [{"scenario": i, "kernel_iterations": int(k_sol.iterations[i]),
                "plain_iterations": int(p_sol.iterations[i]), "merit_rel_diff": float(rel[i])}
               for i in rows]
    assert bool((differ == tied).all()), (f"{what}: iteration counts differ", details)
    assert int(tied.sum()) <= max_tied_share * differ.shape[0], (
        f"{what}: {int(tied.sum())} tied scenarios", details)
    err = {}
    for f, keep in (("xs", slice(None)), ("us", ~tied)):
        a, b = getattr(k_sol, f)[keep], getattr(p_sol, f)[keep]
        atol = torch.full(b.shape[-1:], SOLVE_ATOL, device=b.device)
        if f == "us" and force_atol is not None:
            atol[:12] = force_atol
            err["contact_forces"] = float((a - b)[..., :12].abs().max()) if b.numel() else 0.0
        if f == "us" and joint_atol is not None:
            atol[12:] = joint_atol
            err["joint_velocities"] = float((a - b)[..., 12:].abs().max()) if b.numel() else 0.0
        err[f] = float((a - b).abs().max()) if b.numel() else 0.0
        assert bool(((a - b).abs() <= atol + SOLVE_RTOL * b.abs()).all()), (what, f, err[f])
    return err, int(tied.sum()), details


def compare_solves(torch, a, b, what):
    """Equal iteration counts, xs/us within SOLVE_ATOL + SOLVE_RTOL |value|."""
    assert bool((a.iterations == b.iterations).all()), (
        f"{what}: iteration counts differ", a.iterations.tolist(), b.iterations.tolist())
    err = {}
    for f in ("xs", "us"):
        x, y = getattr(a, f), getattr(b, f)
        err[f] = float((x - y).abs().max())
        assert bool(((x - y).abs() <= SOLVE_ATOL + SOLVE_RTOL * y.abs()).all()), (what, f, err[f])
    return err


def legged_tick_b256(torch, riccati_cuda, cfg, cold_b1, solves=TIMED_SOLVES):
    """The scenario batch: 256 perturbed initial states, shared warm start and
    params; its backward sweep is the CUDA kernel at (nx, nu) = (24, 12) with
    clamped pivots."""
    batch, nx = LEGGED_BATCH, 24
    i = torch.arange(batch, dtype=torch.float32, device=DEVICE)[:, None]
    j = torch.arange(nx, dtype=torch.float32, device=DEVICE)[None, :]
    x0s = cfg["x0"][None] + 1e-3 * torch.sin(i * j)

    def solve(x0, **kw):
        sol = legged_solve(cfg, x0, cfg["us_init"], **kw)
        torch.cuda.synchronize()
        return sol

    solve(x0s)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    k10_before = k10_reset()
    seconds, sols = [], []
    for _ in range(solves):
        t0 = time.perf_counter()
        sols.append(solve(x0s))
        seconds.append(time.perf_counter() - t0)
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    sol = sols[-1]
    sweeps_run = sum(int(s.iterations.max()) for s in sols)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert dims == (batch, LEGGED_N, 24, 12), dims
    k10_launches = k10_took_every_approximation(
        k10_before, sweeps_run, (batch, LEGGED_N), "b256")
    assert sol.xs.shape == (batch, LEGGED_N + 1, 24) and sol.us.shape == (batch, LEGGED_N, 24)
    worst_g = check_legged_solution(torch, cfg, sol, "b256")

    # The same solve through the kernel's plain version, first 32 scenarios.
    sub = x0s[:32]
    err_plain = compare_solves(
        torch, solve(sub), solve(sub, force_plain_riccati=True), "b256 kernel vs plain")
    # Scenario 0 starts at the B = 1 lane's cold tick: clamped against strict
    # pivots, which differ only where Quu_hat is not positive definite.
    one = type(sol)(*(
        type(leaf)(*(v[:1] for v in leaf)) if isinstance(leaf, tuple) else leaf[:1]
        for leaf in sol))
    err_b1 = compare_solves(torch, one, cold_b1, "b256 scenario 0 vs B = 1")

    sec = statistics.median(seconds)
    its = sol.iterations.tolist()
    rec = {
        "phase": "legged_tick_b256", "B": batch, "N": LEGGED_N, "nx": 24, "nu": 24,
        "reduced_nu": 12, "max_iterations": cfg["settings"].max_iterations,
        "solves_timed": solves, "seconds_per_solve": sec, "solves_per_s": batch / sec,
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "converged_share": float(sol.converged.float().mean()),
        "riccati_launches": launches, "kernel_dims": list(dims), "k10_launches": k10_launches,
        "worst_abs_foot_constraint": worst_g,
        "dynamics_violation_sse_max": float(sol.performance.dynamics_violation_sse.max()),
        "equality_constraints_sse_max": float(sol.performance.equality_constraints_sse.max()),
        "kernel_vs_plain_solve_max_abs_err": err_plain,
        "scenario0_vs_b1_max_abs_err": err_b1,
        "peak_device_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    emit(rec)
    return rec


# -- the MPC runtime in closed loop ----------------------------------------------

# 0.2 s (10 ticks; 0.5 s until the IPM and SLP phases and 0.3 s until the
# MPC-Net phases took the script past its time target, PERF.md §4).
MPC_DURATION, MRT_HZ, MPC_HZ = 0.2, 400.0, 50.0
# The base may leave its stand height by this much over the loop: the JAX
# package's own loop on these inputs rises 0.061 m in 0.5 s
# (tools/legged_closed_loop_reference.py); 0.08 m is the bound its legged
# trot tests hold (tests/test_centroidal.py).
HEIGHT_TOL = 0.08


def legged_mpc(torch):
    """The flagship MPC: the legged SQP tick of ``legged_setup`` (N = 100 over
    1 s, rk2, 10 iterations at most) behind the gait-synchronized reference
    manager, in an ``MpcMrtInterface``."""
    from ocs2_tpu_torch.models.legged_robot import interface
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid
    from ocs2_tpu_torch.solvers import sqp

    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, LEGGED_HORIZON)
    grid = make_time_grid(0.0, LEGGED_HORIZON, LEGGED_N, event_times=ms.event_times,
                          mode_sequence=ms.mode_sequence)
    mpc = Mpc(
        interface.make_problem(device=DEVICE), interface.make_params(grid, device=DEVICE),
        MpcSettings(time_horizon=LEGGED_HORIZON, num_intervals=LEGGED_N, solver="sqp"),
        solver_settings=sqp.SqpSettings(max_iterations=10, integrator="rk2"),
        reference_manager=interface.SwitchedModelReferenceManager(
            GaitSchedule(trot_gait(0.7)), device=DEVICE),
        device=DEVICE,
    )
    return MpcMrtInterface(mpc)


def policy_foot_constraint(torch, mpc, inputs, sol):
    """Largest |foot constraint| of a tick's solution on its own grid."""
    from ocs2_tpu_torch.models.legged_robot import constraints
    from ocs2_tpu_torch.oc.approx import node_params

    grid = inputs["grid"].device(DEVICE)
    nodes = torch.arange(LEGGED_N, device=DEVICE)
    g = constraints.foot_constraint(
        grid.times[:-1], sol.xs[:, :-1], sol.us, node_params(inputs["params"], grid, nodes))
    return float(g.abs().max())


def legged_mpc_closed_loop(torch, riccati_cuda, closed_loop_out=None):
    """``dummy_loop`` over the legged MPC: MPC_DURATION at MPC_HZ (10 ticks at
    N = 100) and MRT_HZ (80 control steps).  Per tick: the solve (``solve_timer``), the host work of
    ``Mpc.run`` outside it (``tick_timer`` - ``solve_timer``), the SQP
    iterations, whether the warm start was spread.  Per control step: the
    host clock between two observer calls, each after a synchronise (policy
    evaluation, the rk4 rollout of two substeps, the loop's bookkeeping)."""
    from ocs2_tpu_torch.models.legged_robot import model
    from ocs2_tpu_torch.mpc.mrt import dummy_loop
    from ocs2_tpu_torch.solvers import sqp

    iface = legged_mpc(torch)
    mpc = iface.mpc
    ticks, step_s, last = [], [], {"count": 0, "t": None}

    def observe(t, x, u):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if mpc.solve_timer.count != last["count"]:  # an MPC tick ran before this step
            last["count"] = mpc.solve_timer.count
            ticks.append({
                "t": mpc.last_solve_inputs["grid"].times[0],
                "solve_s": mpc.solve_timer.last, "tick_s": mpc.tick_timer.last,
                "iterations": int(mpc.last_solution.iterations[0]),
                "converged": bool(mpc.last_solution.converged[0]),
                "spread": mpc.spread_count, "inputs": mpc.last_solve_inputs,
                "sol": mpc.last_solution,
            })
        elif last["t"] is not None:
            step_s.append(now - last["t"])
        last["t"] = now

    torch.cuda.synchronize()
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    k10_before = k10_reset()
    t0 = time.perf_counter()
    times, states, inputs = dummy_loop(
        iface, model.default_state(DEVICE), duration=MPC_DURATION, mrt_frequency=MRT_HZ,
        mpc_frequency=MPC_HZ, observers=[observe])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims

    n_ticks = int(round(MPC_DURATION * MPC_HZ))
    n_steps = int(round(MPC_DURATION * MRT_HZ))
    assert len(ticks) == n_ticks and states.shape == (n_steps + 1, 24), (len(ticks), states.shape)
    assert bool(torch.isfinite(states).all()) and bool(torch.isfinite(inputs).all())
    height_dev = float((states[:, 8] - model.STAND_HEIGHT).abs().max())
    assert height_dev <= HEIGHT_TOL, f"base height left STAND_HEIGHT by {height_dev} m"
    worst_g = max(policy_foot_constraint(torch, mpc, k["inputs"], k["sol"]) for k in ticks)
    assert worst_g <= 1e-3, f"|foot_constraint| = {worst_g}"
    spread = ticks[-1]["spread"]
    assert spread >= 1, "no warm start went through spread_trajectories"
    sweeps_run = sum(k["iterations"] for k in ticks)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert dims == (1, LEGGED_N, 24, 12), dims
    k10_launches = k10_took_every_approximation(
        k10_before, sweeps_run, (1, LEGGED_N), "closed loop")

    # The first three ticks once more from the exact inputs Mpc passed,
    # through the single-scenario sweep of torch ops.
    err_single = {}
    for i, k in enumerate(ticks[:3]):
        inp = k["inputs"]
        single = sqp.solve(mpc.problem, inp["grid"], inp["x0"], inp["params"],
                           xs_init=inp["xs_init"], us_init=inp["us_init"], al_init=inp["al_init"],
                           settings=mpc.solver_settings, device=DEVICE, force_single_riccati=True)
        torch.cuda.synchronize()
        err_single[f"tick{i}"] = compare_solves(
            torch, k["sol"], single, f"closed-loop tick {i} kernel vs single sweep")
    assert riccati_cuda.launch_count == launches, "the single-sweep route launches no kernel"

    solve_ms = [1e3 * k["solve_s"] for k in ticks]
    host_ms = [1e3 * (k["tick_s"] - k["solve_s"]) for k in ticks]
    if closed_loop_out:
        with open(closed_loop_out, "w") as f:
            json.dump({"duration_s": MPC_DURATION, "mrt_frequency": MRT_HZ,
                       "mpc_frequency": MPC_HZ, "N": LEGGED_N,
                       "iterations_per_tick": [k["iterations"] for k in ticks],
                       "states": states.tolist()}, f)
    rec = {
        "phase": "legged_mpc_closed_loop", "B": 1, "N": LEGGED_N, "nx": 24, "nu": 24,
        "max_iterations": mpc.solver_settings.max_iterations, "duration_s": MPC_DURATION,
        "mrt_frequency": MRT_HZ, "mpc_frequency": MPC_HZ, "ticks": len(ticks),
        "control_steps": n_steps, "loop_seconds": loop_s,
        "mpc_tick_ms_median": statistics.median(solve_ms), "mpc_tick_ms_worst": max(solve_ms),
        "mpc_tick_ms_first": solve_ms[0],
        "mpc_tick_ms_median_after_first": statistics.median(solve_ms[1:]),
        "mpc_tick_host_ms_median": statistics.median(host_ms),
        "mpc_tick_host_ms_worst": max(host_ms),
        "mrt_step_ms_median": 1e3 * statistics.median(step_s),
        "mrt_step_ms_worst": 1e3 * max(step_s),
        "iterations_per_tick": [k["iterations"] for k in ticks],
        "converged_per_tick": [k["converged"] for k in ticks],
        "spread_warm_starts": spread,
        "spread_per_tick": [b["spread"] - a["spread"] for a, b in zip([{"spread": 0}] + ticks,
                                                                       ticks)],
        "base_height_max_abs_dev": height_dev, "worst_abs_foot_constraint": worst_g,
        "final_state_base_xyz": states[-1, 6:9].tolist(),
        "riccati_launches": launches, "kernel_dims": list(dims), "k10_launches": k10_launches,
        "kernel_vs_single_sweep_solve_max_abs_err": err_single,
    }
    emit(rec)
    return rec, iface


def profile_mpc(torch, iface):
    """Stage times of one MPC tick after the closed loop (host-clock medians,
    each stage synchronised): the reference manager, the grid, the swing
    plan, the warm start by interpolation and by spreading, the solve; and of
    one control step: policy evaluation and rollout."""
    from ocs2_tpu_torch.core.interpolation import interpolate_batch
    from ocs2_tpu_torch.oc.spreading import spread_trajectories
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid

    timed = lambda fn, reps=3: timed_stage(torch, fn, reps)  # noqa: E731
    mpc, mrt = iface.mpc, iface.mrt
    rm, prev = mpc.reference_manager, mpc.last_policy
    t = MPC_DURATION
    x = prev.xs[1]
    stages = {}
    _, stages["pre_solver_run_ms"] = timed(lambda: rm.pre_solver_run(t, t + LEGGED_HORIZON, x))
    ms = rm.mode_schedule
    grid, stages["make_time_grid_ms"] = timed(lambda: make_time_grid(
        t, t + LEGGED_HORIZON, LEGGED_N, event_times=ms.event_times,
        mode_sequence=ms.mode_sequence))
    _, stages["augment_params_ms"] = timed(lambda: rm.augment_params(
        grid, dict(mpc.base_params, target=rm.target)))
    times = torch.as_tensor(grid.times, device=DEVICE)
    _, stages["warm_start_interpolate_ms"] = timed(lambda: (
        interpolate_batch(prev.times, prev.xs, times),
        interpolate_batch(prev.times[:-1], prev.us, times[:-1])))
    _, stages["warm_start_spread_ms"] = timed(lambda: spread_trajectories(
        prev.times, prev.xs, prev.us, prev.mode_schedule, ms, grid.times))
    _, stages["mpc_run_ms"] = timed(lambda: mpc.run(t, x), reps=1)
    stages["mpc_run_solve_ms"] = 1e3 * mpc.solve_timer.last
    params0 = mpc.base_params
    _, stages["evaluate_policy_ms"] = timed(lambda: mrt.evaluate_policy(t, x), reps=20)
    _, stages["rollout_policy_ms"] = timed(
        lambda: mrt.rollout_policy(t, x, 1.0 / MRT_HZ, params0), reps=20)
    emit({"phase": "profile_stages", "path": "legged_mpc_closed_loop", "N": LEGGED_N,
          "stages": stages})
    busy = device_busy(torch, lambda: mpc.run(t, x))
    emit({"phase": "profile", "path": "legged_mpc_tick", "N": LEGGED_N, "profiler": busy})


# -- the quadrotor SQP batch ------------------------------------------------------

_, _, QUAD_BATCH, QUAD_N = QUAD_SHAPE
QUAD_HORIZON, QUAD_SEED = 2.0, 1


def quadrotor_x0s(batch=QUAD_BATCH, seed=QUAD_SEED):
    """Hover at z = 1 plus 0.05 N(0, 1) per state from a numpy seed."""
    x0s = np.zeros((batch, 12), np.float32)
    x0s[:, 2] = 1.0
    return x0s + (0.05 * np.random.default_rng(seed).standard_normal(x0s.shape)).astype(
        np.float32)


def quadrotor_sqp_b4096(torch, riccati_cuda, at_quad, iterations_out=None,
                        solves=TIMED_SOLVES):
    """``sqp.solve`` on 4096 quadrotor scenarios; the sweep is the kernel at
    (12, 4, 4096, 40), one launch per loop iteration."""
    from ocs2_tpu_torch.models import quadrotor
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.solvers import sqp

    problem = quadrotor.make_problem(device=DEVICE)
    params = quadrotor.make_params(device=DEVICE)
    grid = uniform_grid(0.0, QUAD_HORIZON, QUAD_N)
    settings = sqp.SqpSettings(max_iterations=8, integrator="rk4")
    x0s = torch.as_tensor(quadrotor_x0s(QUAD_BATCH), device=DEVICE)

    def solve(x0, **kw):
        sol = sqp.solve(problem, grid, x0, params, settings=settings, device=DEVICE, **kw)
        torch.cuda.synchronize()
        return sol

    solve(x0s)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    seconds, sols = [], []
    for _ in range(solves):
        t0 = time.perf_counter()
        sols.append(solve(x0s))
        seconds.append(time.perf_counter() - t0)
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    sol = sols[-1]
    sweeps_run = sum(int(s.iterations.max()) for s in sols)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert dims == (QUAD_BATCH, QUAD_N, 12, 4), dims
    assert sol.xs.shape == (QUAD_BATCH, QUAD_N + 1, 12) and sol.us.shape == (QUAD_BATCH, QUAD_N, 4)
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    assert all(torch.equal(s.iterations, sol.iterations) for s in sols)
    # Toward the hover target: final position error below the start's.
    start_err = (x0s[:, 0:3] - torch.tensor([0.0, 0.0, 1.0], device=DEVICE)).norm(dim=1)
    end_err = (sol.xs[:, -1, 0:3] - torch.tensor([0.0, 0.0, 1.0], device=DEVICE)).norm(dim=1)
    improved = float((end_err < start_err).float().mean())

    # About a tenth of this batch ends at an iterate where the step no longer
    # lowers the merit and the 8 candidate merits lie within a few float32
    # ulps of the current one, so whether one is accepted, and the solve
    # stops, is decided by the last bit.  The
    # JAX package flips 5.2 % of the scenarios against itself when only the
    # batch size changes (4096 vs 512, on the CPU), the port on the CPU
    # differs from it in 6.1 %, always at equal merits
    # (tools/quadrotor_port_iterations.py, tools/quadrotor_reference_iterations.py).
    # Ties are held to 5 % here, against the ballbot batch's 2 %; the merit
    # test stays at 1e-6.
    sub = x0s[:256]
    err, tied, tie_details = compare_with_ties(
        torch, solve(sub), solve(sub, force_plain_riccati=True), "quadrotor kernel vs plain",
        max_tied_share=0.05)
    full = {}
    if iterations_out:
        # The whole batch through the plain version, recorded beside the
        # kernel's for tools/quadrotor_reference_iterations.py --compare.
        p_full = solve(x0s, force_plain_riccati=True)
        with open(iterations_out, "w") as f:
            json.dump({"seed": QUAD_SEED, "B": QUAD_BATCH, "N": QUAD_N, "device": "cuda",
                       "iterations": sol.iterations.tolist(),
                       "merit": sol.performance.merit.tolist(),
                       "converged": sol.converged.tolist(),
                       "plain_iterations": p_full.iterations.tolist(),
                       "plain_merit": p_full.performance.merit.tolist()}, f)
        differ = sol.iterations != p_full.iterations
        rel = (sol.performance.merit - p_full.performance.merit).abs() / (
            p_full.performance.merit.abs().clamp(min=1e-30))
        full = {"full_batch_kernel_vs_plain_differing": int(differ.sum()),
                "full_batch_differing_with_merit_rel_diff_le_1e-6": int(
                    (differ & (rel <= 1e-6)).sum()),
                "full_batch_merit_rel_diff_max_where_differing": float(rel[differ].max())
                if bool(differ.any()) else None}

    sec = statistics.median(seconds)
    its = sol.iterations.tolist()
    per_solve = launches / solves
    rec = {
        "phase": "quadrotor_sqp_b4096", "B": QUAD_BATCH, "N": QUAD_N, "nx": 12, "nu": 4,
        "horizon_s": QUAD_HORIZON, "integrator": "rk4", "max_iterations": 8,
        "solves_timed": solves, "seconds_per_solve": sec, "solves_per_s": QUAD_BATCH / sec,
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "converged_share": float(sol.converged.float().mean()),
        "closer_to_target_share": improved,
        "riccati_launches": launches, "launches_per_solve": per_solve, "kernel_dims": list(dims),
        "kernel_share_of_solve": per_solve * 1e-3 * at_quad["kernel_ms"] / sec,
        "kernel_vs_plain_solve_max_abs_err": err,
        "kernel_vs_plain_tied_scenarios": tied, "kernel_vs_plain_ties": tie_details,
        **full,
        "peak_device_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    emit(rec)
    return rec


# -- the perceptive lane -----------------------------------------------------------

# bench.py:287 (bench_perceptive_mpc): the stepped map, 1.4 s over 46 intervals,
# 8 SQP iterations at most; 4 ticks after a warm-up (20 until the ComKino phases,
# 12 until the loopshaping phases and 8 until the MPC-Net phases took the
# script past its time target, PERF.md §4).
PERC_STEP_X, PERC_STEP_H, PERC_HORIZON, PERC_N, PERC_TICKS = 0.45, 0.12, 1.4, 46, 4
# tests/test_segmented_planes.py:332 (TestClosedLoopPerceptive): the 0.08 m step,
# N = 32 over 1 s, 6 iterations at most, 2 s at 60 Hz control and 15 Hz MPC.
LOOP_STEP_H, LOOP_HORIZON, LOOP_N = 0.08, 1.0, 32
LOOP_DURATION, LOOP_MRT_HZ, LOOP_MPC_HZ = 2.0, 60.0, 15.0
# The test's bounds: past x = 0.35 m after 2 s; no foot deeper than 0.04 m
# below the terrain outside the band of +-0.1 m at the step edge.
LOOP_MIN_X, LOOP_MAX_DEPTH, LOOP_EDGE_BAND = 0.35, 0.04, 0.1
PERC_SHAPE, LOOP_SHAPE = (24, 12, 1, PERC_N), (24, 12, 1, LOOP_N)
RESOLVED_TICKS = 3

# -- the ComKino lane (tests/test_comkino.py) --------------------------------------
# :333 (test_comkino_perceptive_closed_loop): the kinodynamic model on the 0.08 m
# step, N = 32 over 1 s, 5 iterations at most, 1 s at 50 Hz control and 12.5 Hz
# MPC; the base past x = 0.15 m, |attitude| below 0.4 rad.
CK_HORIZON, CK_N, CK_MAX_ITERATIONS = 1.0, 32, 5
CK_DURATION, CK_MRT_HZ, CK_MPC_HZ = 1.0, 50.0, 12.5
CK_MIN_X, CK_MAX_ATTITUDE = 0.15, 0.4
# :85 (test_comkino_sqp_trot_converges): one cold solve, N = 40 over 1 s, 8
# iterations; dynamics violation below 1e-3, the base within 0.12 m of stand height.
CK_TROT_HORIZON, CK_TROT_N, CK_TROT_ITERATIONS = 1.0, 40, 8
CK_TROT_MAX_DEFECT, CK_TROT_HEIGHT_TOL = 1e-3, 0.12
CK_TROT_SHAPE = (24, 12, 1, CK_TROT_N)
TERRAIN_RTOL = 1e-4  # terrain_check: the card against the CPU


def stepped_map(step_x, high, device=None, extent=4.0, res=0.05):
    """The lane's elevation map: flat, then ``high`` for x > step_x (on the
    card unless ``device`` says otherwise)."""
    from ocs2_tpu_torch.models.legged_robot.terrain import ElevationMap

    m = int(extent / res)
    heights = np.zeros((m, m), np.float32)
    heights[-extent / 2 + (np.arange(m) + 0.5) * res > step_x, :] = high
    return ElevationMap.create(heights, origin_xy=(-extent / 2, -extent / 2), resolution=res,
                               device=device or DEVICE)


def trot_grid(horizon, n):
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid

    ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, horizon)
    return make_time_grid(0.0, horizon, n, event_times=ms.event_times,
                          mode_sequence=ms.mode_sequence)


def target_between(times, first, last):
    """TargetTrajectories from the default state to ``last`` (dicts of state
    entries to set), weight-compensating inputs."""
    from ocs2_tpu_torch.core.reference import TargetTrajectories
    from ocs2_tpu_torch.models.legged_robot import model

    x = model.default_state("cpu").numpy()
    states = np.stack([x.copy(), x.copy()])
    for row, entries in enumerate((first, last)):
        for i, v in entries.items():
            states[row, i] = v
    u0 = model.weight_compensating_input(np.ones(4, np.float32), "cpu").numpy()
    return TargetTrajectories.create(times, states, np.stack([u0, u0]), device=DEVICE)


def perceptive_setup(torch):
    """The perceptive lane of bench.py:287 on the card: the segmented-planes
    problem on the decomposed stepped map, its first foothold plan, and the
    host mirrors the per-tick planner reads."""
    from ocs2_tpu_torch.models.legged_robot import model
    from ocs2_tpu_torch.models.legged_robot.foothold_planner import (
        make_perceptive_params,
        make_segmented_perceptive_problem,
    )
    from ocs2_tpu_torch.models.legged_robot.segmented_planes import decompose_planes
    from ocs2_tpu_torch.models.legged_robot.terrain import ElevationMap
    from ocs2_tpu_torch.solvers import sqp

    em = stepped_map(PERC_STEP_X, PERC_STEP_H)
    terr = decompose_planes(em, device=DEVICE)
    grid = trot_grid(PERC_HORIZON, PERC_N)
    x0 = model.default_state(DEVICE)
    target = target_between([0.0, PERC_HORIZON], {0: 0.6},
                            {0: 0.6, 6: 0.85, 8: model.STAND_HEIGHT + PERC_STEP_H})
    u0 = model.weight_compensating_input(np.ones(4, np.float32), DEVICE)
    return {
        "em": em, "terrain": terr, "grid": grid, "x0": x0, "target": target,
        "problem": make_segmented_perceptive_problem(device=DEVICE),
        "params": make_perceptive_params(grid, terr, em, x0, target, device=DEVICE),
        "us_init": u0[None].expand(PERC_N, model.NU).contiguous(),
        "settings": sqp.SqpSettings(max_iterations=8, integrator="rk2"),
        "terrain_host": terr.to_numpy(),
        "em_host": ElevationMap(*(v.cpu().numpy() for v in em)),
        "target_host": target._replace(times=target.times.cpu().numpy(),
                                       states=target.states.cpu().numpy()),
    }


def perceptive_plan(cfg, x):
    """One tick's re-plan on the current state (one read of x from the card)
    and the plan's one copy to the card."""
    from ocs2_tpu_torch.models.legged_robot.foothold_planner import plan_footholds, plan_to_params

    plan = plan_footholds(cfg["terrain_host"], cfg["em_host"], cfg["grid"].times,
                          cfg["grid"].modes, x, cfg["target_host"])
    return plan_to_params(plan, cfg["params"])


# Contact forces of a re-solved tick.  Near the end of the horizon the split of
# a stance foot's force between x and y is held by the 1e-3 input weight alone,
# so it moves with float32 rounding where xs and the merit do not.  On the
# perceptive closed loop's third tick (tools/perceptive_reference.py
# --force-spread on the card's record of an NVIDIA H100): the JAX package's own
# single and batched sweeps differ by 2.6e-3, its float32 and float64 solves by
# 5.2e-3; the card's kernel lies 1.3e-2 from that float64 solve and 9.2e-3 from
# the card's single sweep, the port's CPU single sweep 1.7e-2 from the kernel
# (tools/perceptive_port_resolve.py).  Two float32 routes thus differ by up to
# 1.8e-2: FORCE_ATOL.  On ComKino the split leaks into the joint velocities
# through the mass matrix, and its loop's third tick is more sensitive still:
# on the card's inputs of that tick the JAX package's one solve and its solve
# inside jax.vmap differ by 0.069 N in the forces and 7.2e-3 rad/s in the joint
# velocities, and float32 routes of the two packages by up to 0.16 N and
# 1.3e-2 rad/s (tools/comkino_reference.py --compare on the card's record; on
# the JAX loop's own third tick 0.094 N and 0.011 rad/s): CK_FORCE_ATOL and
# CK_JOINT_ATOL for the ComKino lane.  Everything else is held at SOLVE_ATOL.
FORCE_ATOL = 2e-2
CK_FORCE_ATOL, CK_JOINT_ATOL = 0.1, 2e-2


def host_tree(obj):
    """Tensors, arrays, named tuples and dicts as nested lists and dicts (JSON)."""
    if hasattr(obj, "_asdict"):
        obj = obj._asdict()
    if isinstance(obj, dict):
        return {k: host_tree(v) for k, v in obj.items()}
    if hasattr(obj, "tolist"):
        return obj.tolist()
    return obj


def resolve_single(torch, riccati_cuda, recorded, solve, what, force_atol=FORCE_ATOL,
                   joint_atol=None):
    """Re-solve recorded ticks from their exact inputs through the
    single-scenario sweep of torch ops; equal iterations and xs / us within
    SOLVE_ATOL + SOLVE_RTOL |value| (contact forces force_atol, joint
    velocities joint_atol when given), a tie at equal merit counted.  The
    kernel's launch counter must not move."""
    before = riccati_cuda.launch_count
    err, ties, singles = {}, [], []
    for i, (sol, kwargs) in enumerate(recorded):
        single = solve(force_single_riccati=True, **kwargs)
        torch.cuda.synchronize()
        singles.append(single)
        err[f"tick{i}"], tied, details = compare_with_ties(
            torch, sol, single, f"{what} tick {i} kernel vs single sweep", max_tied_share=1.0,
            force_atol=force_atol, joint_atol=joint_atol)
        ties += [dict(d, tick=i) for d in details] if tied else []
    assert riccati_cuda.launch_count == before, "the single-sweep route launches no kernel"
    return err, ties, singles


def solve_summary(sol):
    """One scenario's iterations, merit, xs and us as host lists."""
    return {"iterations": int(sol.iterations[0]), "merit": float(sol.performance.merit[0]),
            "xs": sol.xs[0].tolist(), "us": sol.us[0].tolist()}


def perceptive_mpc(torch, riccati_cuda, cfg, at_perc):
    """bench.py:287 rebuilt on the port: per tick a host re-plan on the
    current state, the plan's copy, and a solve warm in ``us``; then
    x <- xs[1].  The sweep is the kernel at (1, 46, 24, 12), strict pivots."""
    from ocs2_tpu_torch.solvers import sqp

    def solve(x, us, params, **kw):
        return sqp.solve(cfg["problem"], cfg["grid"], x, params, us_init=us,
                         settings=cfg["settings"], device=DEVICE, **kw)

    warm = solve(cfg["x0"], cfg["us_init"], cfg["params"])  # the warm-up tick
    torch.cuda.synchronize()
    x, us = cfg["x0"], cfg["us_init"]
    ticks, states = [], [cfg["x0"]]
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    for _ in range(PERC_TICKS):
        t0 = time.perf_counter()
        params = perceptive_plan(cfg, x)
        t1 = time.perf_counter()
        sol = solve(x, us, params)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ticks.append({"plan_s": t1 - t0, "solve_s": t2 - t1, "sol": sol,
                      "inputs": dict(x=x, us=us, params=params)})
        x, us = sol.xs[0, 1], sol.us[0]
        states.append(x)
    total_s = time.perf_counter() - t_all
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    its = [int(k["sol"].iterations[0]) for k in ticks]
    assert launches == sum(its) and launches > 0, (launches, its)
    assert dims == (1, PERC_N, 24, 12), dims
    states = torch.stack(states)
    for k in ticks:
        assert bool(torch.isfinite(k["sol"].xs).all()) and bool(torch.isfinite(k["sol"].us).all())
    err, ties, _ = resolve_single(
        torch, riccati_cuda, [(k["sol"], k["inputs"]) for k in ticks[:RESOLVED_TICKS]], solve,
        "perceptive_mpc")
    plan_ms = [1e3 * k["plan_s"] for k in ticks]
    solve_ms = [1e3 * k["solve_s"] for k in ticks]
    rec = {
        "phase": "perceptive_mpc", "B": 1, "N": PERC_N, "nx": 24, "nu": 24, "reduced_nu": 12,
        "horizon_s": PERC_HORIZON, "max_iterations": cfg["settings"].max_iterations,
        "segments": int(cfg["terrain"].valid.sum()), "ticks": PERC_TICKS,
        "perceptive_mpc_ticks_per_s": PERC_TICKS / total_s,
        "perceptive_host_plan_ms": statistics.mean(plan_ms),
        "host_plan_ms_median": statistics.median(plan_ms), "host_plan_ms_worst": max(plan_ms),
        "solve_ms_median": statistics.median(solve_ms), "solve_ms_worst": max(solve_ms),
        "tick_ms_median": statistics.median(p + q for p, q in zip(plan_ms, solve_ms)),
        "warm_up_iterations": int(warm.iterations[0]), "iterations_per_tick": its,
        "converged_per_tick": [bool(k["sol"].converged[0]) for k in ticks],
        "riccati_launches": launches, "kernel_dims": list(dims),
        "kernel_share_of_tick": launches / PERC_TICKS * at_perc["kernel_ms"]
        / statistics.median(p + q for p, q in zip(plan_ms, solve_ms)),
        "final_state_base_xyz": states[-1, 6:9].tolist(),
        "kernel_vs_single_sweep_solve_max_abs_err": err, "kernel_vs_single_sweep_ties": ties,
    }
    emit(rec)
    # Each tick's state and warm start (its plan is the host planner's on that
    # state), for re-solving a tick elsewhere.
    return rec, {"iterations_per_tick": its, "warm_up_iterations": int(warm.iterations[0]),
                 "merit_per_tick": [float(k["sol"].performance.merit[0]) for k in ticks],
                 "states": states.tolist(),
                 "us_init_per_tick": [k["inputs"]["us"].tolist() for k in ticks]}


def perceptive_closed_loop(torch, riccati_cuda, at_loop):
    """The JAX package's TestClosedLoopPerceptive on the card: ``Mpc`` with
    the segmented-planes problem and ``PerceptiveReferenceManager`` in
    ``MpcMrtInterface``, ``dummy_loop`` for 2 s (30 ticks, 120 control
    steps).  Each tick's sweep is the kernel at (1, 32, 24, 12)."""
    from ocs2_tpu_torch.models.legged_robot import model
    from ocs2_tpu_torch.models.legged_robot.foothold_planner import (
        PerceptiveReferenceManager,
        make_perceptive_params,
        make_segmented_perceptive_problem,
    )
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.models.legged_robot.segmented_planes import decompose_planes
    from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop
    from ocs2_tpu_torch.solvers import sqp

    em = stepped_map(PERC_STEP_X, LOOP_STEP_H)
    terr = decompose_planes(em, device=DEVICE)
    x0 = model.default_state(DEVICE)
    target = target_between([0.0, 4.0], {0: 0.4},
                            {0: 0.4, 6: 1.6, 8: model.STAND_HEIGHT + LOOP_STEP_H})
    rm = PerceptiveReferenceManager(terr, em, GaitSchedule(trot_gait(0.7)), target=target,
                                    device=DEVICE)
    mpc = Mpc(make_segmented_perceptive_problem(device=DEVICE),
              make_perceptive_params(trot_grid(LOOP_HORIZON, LOOP_N), terr, em, x0, target,
                                     device=DEVICE),
              MpcSettings(time_horizon=LOOP_HORIZON, num_intervals=LOOP_N, solver="sqp"),
              solver_settings=sqp.SqpSettings(max_iterations=6, integrator="rk2"),
              reference_manager=rm, device=DEVICE)
    iface = MpcMrtInterface(mpc)
    ticks, step_s, last = [], [], {"count": 0, "t": None}

    def observe(t, x, u):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if mpc.solve_timer.count != last["count"]:  # an MPC tick ran before this step
            last["count"] = mpc.solve_timer.count
            ticks.append({"solve_s": mpc.solve_timer.last, "tick_s": mpc.tick_timer.last,
                          "plan_s": rm.plan_timer.last,
                          "iterations": int(mpc.last_solution.iterations[0]),
                          "converged": bool(mpc.last_solution.converged[0]),
                          "inputs": mpc.last_solve_inputs, "sol": mpc.last_solution})
        elif last["t"] is not None:
            step_s.append(now - last["t"])
        last["t"] = now

    torch.cuda.synchronize()
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    t0 = time.perf_counter()
    _, states, inputs = dummy_loop(iface, x0, duration=LOOP_DURATION, mrt_frequency=LOOP_MRT_HZ,
                                   mpc_frequency=LOOP_MPC_HZ, observers=[observe])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims

    n_ticks = int(round(LOOP_DURATION * LOOP_MPC_HZ))
    n_steps = int(round(LOOP_DURATION * LOOP_MRT_HZ))
    assert len(ticks) == n_ticks and states.shape == (n_steps + 1, 24), (len(ticks), states.shape)
    assert bool(torch.isfinite(states).all()) and bool(torch.isfinite(inputs).all())
    its = [k["iterations"] for k in ticks]
    assert launches == sum(its) and launches > 0, (launches, its)
    assert dims == (1, LOOP_N, 24, 12), dims
    final_x = float(states[-1, 6])
    assert final_x > LOOP_MIN_X, f"the base reached x = {final_x} m, not past {LOOP_MIN_X}"
    feet = model.foot_positions_world(states)
    depth = em.height_at(feet[..., :2]) - feet[..., 2]
    band = (feet[..., 0] - PERC_STEP_X).abs() < LOOP_EDGE_BAND
    worst_depth = float(torch.where(band, torch.zeros_like(depth), depth).max())
    assert worst_depth < LOOP_MAX_DEPTH, f"a foot {worst_depth} m below the terrain"

    def solve(**kw):
        inp = dict(kw)
        return sqp.solve(mpc.problem, inp.pop("grid"), inp.pop("x0"), inp.pop("params"),
                         settings=mpc.solver_settings, device=DEVICE, **inp)

    err, ties, singles = resolve_single(
        torch, riccati_cuda, [(k["sol"], k["inputs"]) for k in ticks[:RESOLVED_TICKS]], solve,
        "perceptive_closed_loop")
    solve_ms = [1e3 * k["solve_s"] for k in ticks]
    host_ms = [1e3 * (k["tick_s"] - k["solve_s"]) for k in ticks]
    plan_ms = [1e3 * k["plan_s"] for k in ticks]
    rec = {
        "phase": "perceptive_closed_loop", "B": 1, "N": LOOP_N, "nx": 24, "nu": 24,
        "reduced_nu": 12, "max_iterations": mpc.solver_settings.max_iterations,
        "duration_s": LOOP_DURATION, "mrt_frequency": LOOP_MRT_HZ, "mpc_frequency": LOOP_MPC_HZ,
        "ticks": len(ticks), "control_steps": n_steps, "loop_seconds": loop_s,
        "segments": int(terr.valid.sum()),
        "mpc_tick_ms_median": statistics.median(solve_ms), "mpc_tick_ms_worst": max(solve_ms),
        "mpc_tick_host_ms_median": statistics.median(host_ms),
        "mpc_tick_host_ms_worst": max(host_ms),
        "planner_ms_median": statistics.median(plan_ms), "planner_ms_worst": max(plan_ms),
        "mrt_step_ms_median": 1e3 * statistics.median(step_s),
        "mrt_step_ms_worst": 1e3 * max(step_s),
        "iterations_per_tick": its, "converged_per_tick": [k["converged"] for k in ticks],
        "spread_warm_starts": mpc.spread_count, "final_base_x": final_x,
        "worst_foot_depth_outside_edge_band": worst_depth,
        "riccati_launches": launches, "kernel_dims": list(dims),
        "kernel_share_of_tick": launches / len(ticks) * at_loop["kernel_ms"]
        / statistics.median(solve_ms),
        "kernel_vs_single_sweep_solve_max_abs_err": err, "kernel_vs_single_sweep_ties": ties,
    }
    emit(rec)
    # The re-solved ticks' exact solver arguments and both routes' results.
    record = {"iterations_per_tick": its,
              "merit_per_tick": [float(k["sol"].performance.merit[0]) for k in ticks],
              "states": states.tolist(),
              "resolved_ticks": [
                  {"inputs": host_tree(k["inputs"]), "kernel": solve_summary(k["sol"]),
                   "single_sweep": solve_summary(single)} for k, single in zip(ticks, singles)]}
    return rec, record


def comkino_perceptive_closed_loop(torch, riccati_cuda, at_loop, comkino_out=None):
    """tests/test_comkino.py:333 on the card: the ComKino model in the
    segmented-planes problem, ``Mpc`` with the ``PerceptiveReferenceManager`` in
    ``MpcMrtInterface``, ``dummy_loop`` for 1 s at 50 Hz control and 12.5 Hz MPC
    (13 ticks, 50 control steps).  Each tick's sweep is the kernel at
    (1, 32, 24, 12) with strict pivots, one launch per SQP iteration."""
    from ocs2_tpu_torch.models.legged_robot import model
    from ocs2_tpu_torch.models.legged_robot.foothold_planner import (
        PerceptiveReferenceManager,
        make_perceptive_params,
        make_segmented_perceptive_problem,
    )
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.models.legged_robot.segmented_planes import decompose_planes
    from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop
    from ocs2_tpu_torch.solvers import sqp

    em = stepped_map(PERC_STEP_X, LOOP_STEP_H)
    terr = decompose_planes(em, device=DEVICE)
    x0 = model.default_state(DEVICE)
    target = target_between([0.0, 4.0], {0: 0.4},
                            {0: 0.4, 6: 1.6, 8: model.STAND_HEIGHT + LOOP_STEP_H})
    rm = PerceptiveReferenceManager(terr, em, GaitSchedule(trot_gait(0.7)), target=target,
                                    device=DEVICE)
    mpc = Mpc(make_segmented_perceptive_problem(model_type="comkino", device=DEVICE),
              make_perceptive_params(trot_grid(CK_HORIZON, CK_N), terr, em, x0, target,
                                     device=DEVICE),
              MpcSettings(time_horizon=CK_HORIZON, num_intervals=CK_N, solver="sqp"),
              solver_settings=sqp.SqpSettings(max_iterations=CK_MAX_ITERATIONS,
                                              integrator="rk2"),
              reference_manager=rm, device=DEVICE)
    iface = MpcMrtInterface(mpc)
    ticks, step_s, last = [], [], {"count": 0, "t": None}

    def observe(t, x, u):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if mpc.solve_timer.count != last["count"]:  # an MPC tick ran before this step
            last["count"] = mpc.solve_timer.count
            ticks.append({"solve_s": mpc.solve_timer.last, "tick_s": mpc.tick_timer.last,
                          "plan_s": rm.plan_timer.last,
                          "iterations": int(mpc.last_solution.iterations[0]),
                          "converged": bool(mpc.last_solution.converged[0]),
                          "inputs": mpc.last_solve_inputs, "sol": mpc.last_solution})
        elif last["t"] is not None:
            step_s.append(now - last["t"])
        last["t"] = now

    torch.cuda.synchronize()
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    t0 = time.perf_counter()
    _, states, inputs = dummy_loop(iface, x0, duration=CK_DURATION, mrt_frequency=CK_MRT_HZ,
                                   mpc_frequency=CK_MPC_HZ, observers=[observe])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims

    ratio = int(round(CK_MRT_HZ / CK_MPC_HZ))
    n_steps = int(round(CK_DURATION * CK_MRT_HZ))
    n_ticks = -(-n_steps // ratio)
    assert len(ticks) == n_ticks and states.shape == (n_steps + 1, 24), (len(ticks), states.shape)
    assert bool(torch.isfinite(states).all()) and bool(torch.isfinite(inputs).all())
    its = [k["iterations"] for k in ticks]
    assert launches == sum(its) and launches > 0, (launches, its)
    assert dims == (1, CK_N, 24, 12), dims
    final_x = float(states[-1, 6])
    worst_attitude = float(states[:, 9:12].abs().max())
    assert final_x > CK_MIN_X, f"the base reached x = {final_x} m, not past {CK_MIN_X}"
    assert worst_attitude < CK_MAX_ATTITUDE, f"|attitude| reached {worst_attitude} rad"
    record = {"iterations_per_tick": its,
              "merit_per_tick": [float(k["sol"].performance.merit[0]) for k in ticks],
              "states": states.tolist()}
    if comkino_out:  # written before the re-solve, which may fail
        with open(comkino_out, "w") as f:
            json.dump(record, f)

    def solve(**kw):
        inp = dict(kw)
        return sqp.solve(mpc.problem, inp.pop("grid"), inp.pop("x0"), inp.pop("params"),
                         settings=mpc.solver_settings, device=DEVICE, **inp)

    err, ties, singles = resolve_single(
        torch, riccati_cuda, [(k["sol"], k["inputs"]) for k in ticks[:RESOLVED_TICKS]], solve,
        "comkino_perceptive_closed_loop", force_atol=CK_FORCE_ATOL, joint_atol=CK_JOINT_ATOL)
    if comkino_out:  # the re-solved ticks' solver arguments and both routes' results
        record["resolved_ticks"] = [
            {"inputs": host_tree(k["inputs"]), "kernel": solve_summary(k["sol"]),
             "single_sweep": solve_summary(single)} for k, single in zip(ticks, singles)]
        with open(comkino_out, "w") as f:
            json.dump(record, f)
    solve_ms = [1e3 * k["solve_s"] for k in ticks]
    host_ms = [1e3 * (k["tick_s"] - k["solve_s"]) for k in ticks]
    plan_ms = [1e3 * k["plan_s"] for k in ticks]
    rec = {
        "phase": "comkino_perceptive_closed_loop", "model": "comkino", "B": 1, "N": CK_N,
        "nx": 24, "nu": 24, "reduced_nu": 12, "max_iterations": CK_MAX_ITERATIONS,
        "duration_s": CK_DURATION, "mrt_frequency": CK_MRT_HZ, "mpc_frequency": CK_MPC_HZ,
        "ticks": len(ticks), "control_steps": n_steps, "loop_seconds": loop_s,
        "segments": int(terr.valid.sum()),
        "mpc_tick_ms_median": statistics.median(solve_ms), "mpc_tick_ms_worst": max(solve_ms),
        "mpc_tick_host_ms_median": statistics.median(host_ms),
        "mpc_tick_host_ms_worst": max(host_ms),
        "planner_ms_median": statistics.median(plan_ms), "planner_ms_worst": max(plan_ms),
        "mrt_step_ms_median": 1e3 * statistics.median(step_s),
        "mrt_step_ms_worst": 1e3 * max(step_s),
        "iterations_per_tick": its, "converged_per_tick": [k["converged"] for k in ticks],
        "spread_warm_starts": mpc.spread_count, "final_base_x": final_x,
        "max_abs_attitude": worst_attitude,
        "riccati_launches": launches, "kernel_dims": list(dims),
        "kernel_share_of_tick": launches / len(ticks) * at_loop["kernel_ms"]
        / statistics.median(solve_ms),
        "kernel_vs_single_sweep_solve_max_abs_err": err, "kernel_vs_single_sweep_ties": ties,
    }
    emit(rec)
    return rec


def comkino_trot_setup(torch):
    """tests/test_comkino.py:85's solve: the flagship problem on the ComKino
    model, trot over 1 s at N = 40, 8 iterations, from the default state and
    the weight-compensating input."""
    from ocs2_tpu_torch.models.legged_robot import interface, model
    from ocs2_tpu_torch.solvers import sqp

    grid = trot_grid(CK_TROT_HORIZON, CK_TROT_N)
    u0 = model.weight_compensating_input(np.ones(4, np.float32), DEVICE)
    return {
        "problem": interface.make_problem(model_type="comkino", device=DEVICE), "grid": grid,
        "params": interface.make_params(grid, device=DEVICE), "x0": model.default_state(DEVICE),
        "us_init": u0[None].expand(CK_TROT_N, model.NU).contiguous(),
        "settings": sqp.SqpSettings(max_iterations=CK_TROT_ITERATIONS),
    }


def comkino_trot(torch, riccati_cuda, cfg, at_trot, solves=TIMED_SOLVES):
    """One cold ComKino SQP solve (a warm-up, then ``solves`` timed), its sweep
    the kernel at (1, 40, 24, 12) with strict pivots; the cold solve once more
    through the single-scenario sweep."""
    from ocs2_tpu_torch.models.legged_robot import model

    legged_solve(cfg, cfg["x0"], cfg["us_init"])  # warm-up
    torch.cuda.synchronize()
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    seconds, sols = [], []
    for _ in range(solves):
        t0 = time.perf_counter()
        sols.append(legged_solve(cfg, cfg["x0"], cfg["us_init"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    its = [int(s.iterations[0]) for s in sols]
    assert launches == sum(its) and launches > 0, (launches, its)
    assert dims == (1, CK_TROT_N, 24, 12), dims
    sol = sols[-1]
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    defect = float(sol.performance.dynamics_violation_sse[0])
    height = float((sol.xs[0, :, 8] - model.STAND_HEIGHT).abs().max())
    assert defect < CK_TROT_MAX_DEFECT, f"dynamics_violation_sse {defect}"
    assert height < CK_TROT_HEIGHT_TOL, f"base height {height} m from stand height"
    single = legged_solve(cfg, cfg["x0"], cfg["us_init"], force_single_riccati=True)
    torch.cuda.synchronize()
    assert riccati_cuda.launch_count == launches, "the single-sweep route launches no kernel"
    err_single = compare_solves(torch, sol, single, "comkino trot kernel vs single sweep")
    sec = statistics.median(seconds)
    rec = {
        "phase": "comkino_trot", "model": "comkino", "B": 1, "N": CK_TROT_N, "nx": 24, "nu": 24,
        "reduced_nu": 12, "max_iterations": CK_TROT_ITERATIONS, "solves_timed": solves,
        "iterations": its[-1], "converged": bool(sol.converged[0]),
        "seconds_per_solve": sec, "seconds_per_iteration": sec / its[-1],
        "dynamics_violation_sse": defect, "base_height_max_abs_dev": height,
        "equality_constraints_sse": float(sol.performance.equality_constraints_sse[0]),
        "merit": float(sol.performance.merit[0]),
        "riccati_launches": launches, "kernel_dims": list(dims),
        "kernel_share_of_solve": its[-1] * 1e-3 * at_trot["kernel_ms"] / sec,
        "kernel_vs_single_sweep_solve_max_abs_err": err_single,
    }
    emit(rec)
    return rec


# -- the interior-point solver on the legged robot, and SLP -------------------------

# The flagship tick under IPM (the reference's LeggedRobotIpmMpcNode): the hard
# friction cone is the barrier's inequality, the foot constraint is projected;
# 15 iterations at most (IpmSettings' default).  The chains start from the
# weight-compensating guess: from zero inputs the reference's IPM fails
# (ROADMAP.md §3).
IPM_MAX_ITERATIONS = 15
# One chain of 2 ticks (two chains of 6 until the loopshaping phases and 3
# ticks until the MPC-Net phases took the script past its time target,
# PERF.md §4); tools/legged_ipm_reference.py runs as many.
IPM_CHAINS, IPM_TICKS_PER_CHAIN = 1, 2
# IPM stops when the total violation, which includes the slack gap |h - s|,
# falls below constraint_tol = 1e-4.  On flat ground the stance slacks sit
# near 92, where float32 rounds h and s to 5.5e-6 each: over the ~300 stance
# rows the gap's rounding floor is about 1e-4 itself, and the last two
# iterations' violations land at 0.75-1.07 of the tolerance (CPU, B = 32).
# So two routes of the sweep may stop one iteration apart at equal merit
# (the extra iteration moves it by 5e-7): ties, held to equal merit within
# 1e-6 and xs within SOLVE_ATOL by compare_with_ties, at most this share
# (107 of 256 scenarios on the first card run, PERF.md §6).
IPM_MAX_TIED_SHARE = 0.75
# The SLP phase: main_path's ballbot problem (rk4) for its first 256 seeded
# initial states; its SQP run sweeps with the kernel at this shape.  SLP is
# held against the JAX package's SLP on the same scenarios
# (tools/slp_reference.py --record): the reference's own SLP stops 0.026-2.2
# from its SQP in the inputs on this problem (dynamics SSE to 3.4e-3), far
# outside tests/test_pipg.py's bound for the linear double integrator.
SLP_BATCH = 256
SLP_SHAPE = (10, 3, SLP_BATCH, 32)
SLP_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_data",
                          "slp_ballbot_reference.npz")
SLP_MERIT_RTOL = 1e-5


def legged_ipm_setup(cfg):
    from ocs2_tpu_torch.models.legged_robot import interface
    from ocs2_tpu_torch.solvers import ipm

    return dict(cfg, problem=interface.make_problem(friction_cone="hard", device=DEVICE),
                settings=ipm.IpmSettings(max_iterations=IPM_MAX_ITERATIONS, integrator="rk2"))


def ipm_solve(cfg, x0, us_init, **kw):
    from ocs2_tpu_torch.solvers import ipm

    return ipm.solve(cfg["problem"], cfg["grid"], x0, cfg["params"], us_init=us_init,
                     settings=cfg["settings"], device=DEVICE, **kw)


def stance_slacks(torch, cfg, sol):
    """The cone's slacks of the legs in stance [B, stance entries] (a swing
    row holds the constant 1.0)."""
    from ocs2_tpu_torch.models.legged_robot.gait import contact_flags

    stance = contact_flags(cfg["grid"].device(DEVICE).modes[:-1]) > 0.5  # [N, 4]
    return sol.ipm.slack_ineq[:, stance]


def check_ipm_solution(torch, cfg, sol, what):
    """Finite trajectories, at least one iteration, interior slacks and duals,
    and the projected foot constraint at every node.  Returns (worst foot
    constraint, smallest stance slack per scenario)."""
    from ocs2_tpu_torch.models.legged_robot import constraints
    from ocs2_tpu_torch.oc.approx import node_params

    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all()), what
    assert int(sol.iterations.min()) >= 1, what
    assert bool((sol.ipm.slack_ineq > 0).all()) and bool((sol.ipm.dual_ineq > 0).all()), what
    grid = cfg["grid"].device(DEVICE)
    nodes = torch.arange(LEGGED_N, device=DEVICE)
    g = constraints.foot_constraint(
        grid.times[:-1], sol.xs[:, :-1], sol.us, node_params(cfg["params"], grid, nodes))
    worst = float(g.abs().max())
    assert worst <= 1e-3, f"{what}: |foot_constraint| = {worst}"
    return worst, stance_slacks(torch, cfg, sol).amin(dim=1)


def legged_ipm_tick_b1(torch, riccati_cuda, cfg, chains=IPM_CHAINS, ticks_per_chain=IPM_TICKS_PER_CHAIN,
                       ipm_out=None):
    """The slice's main path: ``ipm.solve`` at B = 1, N = 100, as chains of
    dependent receding-horizon ticks (each starts at the solved xs[1],
    warm-started with the solved inputs), after a cold solve from the
    weight-compensating guess that is also the warm-up.  The sweep is the
    kernel with strict pivots, one launch per IPM iteration, and so is the
    LQ approximation's, K10's hard variant."""
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    k10_before = k10_reset()
    t0 = time.perf_counter()
    cold = ipm_solve(cfg, cfg["x0"], cfg["us_init"])
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    worst_g, cold_slack = check_ipm_solution(torch, cfg, cold, "ipm b1 cold solve")

    x, us = cfg["x0"], cfg["us_init"]
    chain_s, ticks, starts = [], [], []
    for _ in range(chains):
        sols = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ticks_per_chain):
            starts.append(x)
            sol = ipm_solve(cfg, x, us)
            x, us = sol.xs[0, 1], sol.us[0]
            sols.append(sol)
        torch.cuda.synchronize()
        chain_s.append(time.perf_counter() - t0)
        ticks += sols
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    slack_min = []
    for i, sol in enumerate(ticks):
        g, s = check_ipm_solution(torch, cfg, sol, f"ipm b1 tick {i}")
        worst_g = max(worst_g, g)
        slack_min.append(float(s[0]))
    sweeps_run = int(cold.iterations[0]) + sum(int(s.iterations[0]) for s in ticks)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert dims == (1, LEGGED_N, 24, 12), dims
    k10_launches = k10_took_every_approximation(k10_before, sweeps_run, (1, LEGGED_N), "ipm b1")
    # The cold solve once more through the single-scenario sweep of torch ops.
    single = ipm_solve(cfg, cfg["x0"], cfg["us_init"], force_single_riccati=True)
    torch.cuda.synchronize()
    assert riccati_cuda.launch_count == launches, "the single-sweep route launches no kernel"
    err_single, tied_single, _ = compare_with_ties(
        torch, cold, single, "ipm b1 kernel vs single sweep", max_tied_share=1.0)
    per_tick_ms = [1e3 * s / ticks_per_chain for s in chain_s]
    if ipm_out:
        with open(ipm_out, "w") as f:
            json.dump({"N": LEGGED_N, "max_iterations": IPM_MAX_ITERATIONS,
                       "chains": chains, "ticks_per_chain": ticks_per_chain,
                       "cold": {"iterations": int(cold.iterations[0]),
                                "merit": float(cold.performance.merit[0]),
                                "xs": cold.xs[0].tolist(), "us": cold.us[0].tolist()},
                       "tick_states": [s.tolist() for s in starts],
                       "iterations_per_tick": [int(s.iterations[0]) for s in ticks],
                       "merit_per_tick": [float(s.performance.merit[0]) for s in ticks],
                       "final_state": x.tolist()}, f)
    last = ticks[-1].performance
    rec = {
        "phase": "legged_ipm_tick_b1", "solver": "ipm", "friction_cone": "hard", "B": 1,
        "N": LEGGED_N, "nx": 24, "nu": 24, "max_iterations": IPM_MAX_ITERATIONS,
        "chains": chains, "ticks_per_chain": ticks_per_chain,
        "tick_ms_median": statistics.median(per_tick_ms), "tick_ms_worst": max(per_tick_ms),
        "ticks_per_s": 1e3 / statistics.median(per_tick_ms),
        "cold_solve_ms_first_call": 1e3 * cold_s,
        "cold_solve_iterations": int(cold.iterations[0]),
        "cold_solve_converged": bool(cold.converged[0]),
        "cold_solve_min_stance_slack": float(cold_slack[0]),
        "iterations_per_tick": [int(s.iterations[0]) for s in ticks],
        "converged_per_tick": [bool(s.converged[0]) for s in ticks],
        "min_stance_slack_per_tick": slack_min,
        "final_mu_per_tick": [float(s.ipm.mu[0]) for s in ticks],
        "max_dual": max(float(s.ipm.dual_ineq.max()) for s in ticks),
        "dynamics_violation_sse": float(last.dynamics_violation_sse[0]),
        "worst_abs_foot_constraint": worst_g, "riccati_launches": launches,
        "kernel_dims": list(dims), "kernel_vs_single_sweep_solve_max_abs_err": err_single,
        "kernel_vs_single_sweep_iterations": [int(cold.iterations[0]),
                                              int(single.iterations[0])],
        "kernel_vs_single_sweep_tied": bool(tied_single),
        "k10_launches": k10_launches,
    }
    emit(rec)
    return rec


def legged_ipm_b256(torch, riccati_cuda, cfg, solves=1):
    """``ipm.solve`` on legged_tick_b256's 256 perturbed initial states and
    shared warm start; the sweep is the kernel at (24, 12, 256, 100) with
    clamped pivots.  The same solve through the plain version is held
    against it.  The spread of iterations and of the final mu is per
    scenario: a reduction over the batch where one over a scenario's nodes
    belongs would show as a spread of one.  The LQ approximation is K10's
    hard variant, one launch an IPM iteration."""
    batch, nx = LEGGED_BATCH, 24
    i = torch.arange(batch, dtype=torch.float32, device=DEVICE)[:, None]
    j = torch.arange(nx, dtype=torch.float32, device=DEVICE)[None, :]
    x0s = cfg["x0"][None] + 1e-3 * torch.sin(i * j)

    def solve(**kw):
        sol = ipm_solve(cfg, x0s, cfg["us_init"], **kw)
        torch.cuda.synchronize()
        return sol

    solve()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    k10_before = k10_reset()
    seconds, sols = [], []
    for _ in range(solves):
        t0 = time.perf_counter()
        sols.append(solve())
        seconds.append(time.perf_counter() - t0)
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    sol = sols[-1]
    sweeps_run = sum(int(s.iterations.max()) for s in sols)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert dims == (batch, LEGGED_N, 24, 12), dims
    k10_launches = k10_took_every_approximation(
        k10_before, sweeps_run, (batch, LEGGED_N), "ipm b256")
    worst_g, slack = check_ipm_solution(torch, cfg, sol, "ipm b256")
    plain = solve(force_plain_riccati=True)
    assert riccati_cuda.launch_count == launches, "the plain route launches no kernel"
    err, tied, tie_details = compare_with_ties(
        torch, sol, plain, "ipm b256 kernel vs plain", max_tied_share=IPM_MAX_TIED_SHARE)

    sec = statistics.median(seconds)
    its = sol.iterations.tolist()
    rec = {
        "phase": "legged_ipm_b256", "solver": "ipm", "friction_cone": "hard", "B": batch,
        "N": LEGGED_N, "nx": 24, "nu": 24, "reduced_nu": 12,
        "max_iterations": IPM_MAX_ITERATIONS, "solves_timed": solves,
        "seconds_per_solve": sec, "solves_per_s": batch / sec,
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "converged": int(sol.converged.sum()),
        "final_mu_min": float(sol.ipm.mu.min()), "final_mu_max": float(sol.ipm.mu.max()),
        "min_stance_slack": float(slack.min()), "max_dual": float(sol.ipm.dual_ineq.max()),
        "riccati_launches": launches, "launches_per_solve": launches / solves,
        "kernel_dims": list(dims), "k10_launches": k10_launches,
        "worst_abs_foot_constraint": worst_g,
        "dynamics_violation_sse_max": float(sol.performance.dynamics_violation_sse.max()),
        "kernel_vs_plain_solve_max_abs_err": err,
        "kernel_vs_plain_tied_scenarios": tied, "kernel_vs_plain_ties": tie_details,
        "peak_device_memory_mb": torch.cuda.max_memory_allocated() / 2**20,
    }
    emit(rec)
    return rec


def count_launches(torch, fn):
    """Kernels the card ran in one call of fn: torch.profiler's device events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if device == 0:
        raise SystemExit("torch.profiler recorded no device event")
    return device


def slp_ballbot_b256(torch, riccati_cuda):
    """``slp.solve`` (PIPG, SlpSettings' defaults with main_path's rk4) on
    the ballbot problem for the first 256 of main_path's seeded initial
    states, held against the JAX package's SLP on the same scenarios
    (SLP_RECORD): every scenario's inputs within SOLVE_ATOL + SOLVE_RTOL
    |value| and merit within SLP_MERIT_RTOL.  Iterations are not held: at
    the stall where SLP ends here, whether a step of 1e-6 is accepted (and
    the scenario counted converged) is decided by float32 rounding, which
    leaves the inputs where they were.  ``sqp.solve`` on the same scenarios
    (the sweep: the kernel at (10, 3, 256, 32), clamped) is timed beside it
    and its distance printed.  The torch launches of one PIPG iteration are
    counted by the profiler (the difference of 20 and 10 iterations, over
    10)."""
    from ocs2_tpu_torch.models import ballbot
    from ocs2_tpu_torch.oc.approx import approximate_lq
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.ops import pipg, riccati
    from ocs2_tpu_torch.solvers import slp, sqp

    _, _, batch, n = SLP_SHAPE
    problem, params = ballbot.make_problem(device=DEVICE), ballbot.make_params(device=DEVICE)
    grid = uniform_grid(0.0, 1.0, n)
    rng = np.random.default_rng(0)  # main_path's seed: its first 256 scenarios
    x0s = torch.as_tensor(
        (0.1 * rng.standard_normal((4096, ballbot.NX))).astype(np.float32)[:batch], device=DEVICE)
    slp_st = slp.SlpSettings(integrator="rk4")
    sqp_st = sqp.SqpSettings(integrator="rk4", max_iterations=slp_st.max_iterations)

    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    t0 = time.perf_counter()
    ref = sqp.solve(problem, grid, x0s, params, settings=sqp_st, device=DEVICE)
    torch.cuda.synchronize()
    sqp_s = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    assert launches == int(ref.iterations.max()) and launches > 0, launches
    assert dims == (batch, n, ballbot.NX, ballbot.NU), dims

    t0 = time.perf_counter()
    sol = slp.solve(problem, grid, x0s, params, settings=slp_st, device=DEVICE)
    torch.cuda.synchronize()
    slp_s = time.perf_counter() - t0
    assert riccati_cuda.launch_count == launches, "SLP launches no Riccati kernel"
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    assert bool(torch.isnan(sol.value_S).all()) and not bool(sol.gains.any())
    with np.load(SLP_RECORD) as f:
        rec_np = {k: f[k] for k in f.files}
    assert np.array_equal(rec_np["x0s"], x0s.cpu().numpy()), "the record's scenarios differ"
    rec_us = torch.as_tensor(rec_np["us"], device=DEVICE)
    rec_merit = torch.as_tensor(rec_np["merit"], device=DEVICE)
    us_err = float((sol.us - rec_us).abs().max())
    merit_rel = float(((sol.performance.merit - rec_merit).abs() / rec_merit.abs()).max())
    assert bool(((sol.us - rec_us).abs() <= SOLVE_ATOL + SOLVE_RTOL * rec_us.abs()).all()), (
        f"SLP vs the JAX package's: |us| differs by {us_err}")
    assert merit_rel <= SLP_MERIT_RTOL, f"SLP merit vs the JAX package's: {merit_rel}"
    defect = float(sol.performance.dynamics_violation_sse.max())
    vs_sqp = (sol.us - ref.us).abs().amax(dim=(1, 2))

    # One QP of the first SLP iteration, for the PIPG counts and times.
    xs = x0s[:, None, :].expand(batch, n + 1, ballbot.NX).contiguous()
    us = torch.zeros((batch, n, ballbot.NU), device=DEVICE)
    lq = approximate_lq(problem, grid, xs, us, params, method="rk4")
    qp = riccati.LqrCoeffs(
        A=lq.dynamics.dfdx, B=lq.dynamics.dfdu, b=lq.dynamics.f - xs[:, 1:],
        Qxx=lq.cost.dfdxx[:, :-1], qx=lq.cost.dfdx[:, :-1],
        Quu=lq.cost.dfduu[:, :-1] + slp_st.hessian_reg * torch.eye(ballbot.NU, device=DEVICE),
        qu=lq.cost.dfdu[:, :-1], Qux=lq.cost.dfdux[:, :-1],
        Qf=lq.cost.dfdxx[:, -1], qf=lq.cost.dfdx[:, -1])
    scaled, _ = pipg.ruiz_equilibrate(qp, slp_st.ruiz_iterations)
    run = lambda k: pipg.pipg_solve(scaled, pipg.PipgSettings(num_iterations=k))  # noqa: E731
    run(10)
    d10, d20 = count_launches(torch, lambda: run(10)), count_launches(torch, lambda: run(20))
    _, qp_ms = timed_stage(torch, lambda: run(slp_st.pipg_iterations), reps=1)
    _, setup_ms = timed_stage(torch, lambda: run(0), reps=3)

    its = sol.iterations.tolist()
    rec = {
        "phase": "slp_ballbot_b256", "problem": "ballbot", "algorithm": "slp", "B": batch,
        "N": n, "nx": ballbot.NX, "nu": ballbot.NU, "integrator": "rk4",
        "max_iterations": slp_st.max_iterations, "pipg_iterations_per_qp": slp_st.pipg_iterations,
        "ruiz_iterations": slp_st.ruiz_iterations,
        "seconds_per_solve": slp_s, "solves_per_s": batch / slp_s,
        "sqp_seconds_per_solve": sqp_s,
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "sqp_iterations_max": int(ref.iterations.max()),
        "converged_share": float(sol.converged.float().mean()),
        "iterations_equal_to_reference": int((sol.iterations.cpu().numpy()
                                              == rec_np["iterations"]).sum()),
        "us_max_abs_diff_vs_reference": us_err, "merit_max_rel_diff_vs_reference": merit_rel,
        "us_max_abs_diff_vs_sqp": float(vs_sqp.max()),
        "us_min_abs_diff_vs_sqp": float(vs_sqp.min()),
        "reference_us_max_abs_diff_vs_its_sqp": float(rec_np["us_max_abs_diff_vs_sqp"].max()),
        "dynamics_violation_sse_max": defect,
        "reference_dynamics_violation_sse_max": float(rec_np["dynamics_violation_sse"].max()),
        "pipg_launches_per_iteration": (d20 - d10) / 10,
        "pipg_qp_ms": qp_ms, "pipg_iteration_ms": (qp_ms - setup_ms) / slp_st.pipg_iterations,
        "pipg_setup_ms": setup_ms,
        "sqp_check_riccati_launches": launches, "kernel_dims": list(dims),
    }
    emit(rec)
    return rec


# -- the DDP family: SLQ's continuous-time sweep, the hybrid DDP, switch times ----

# (nx, nu, B, N, jump intervals) of the CT sweep's checks: the SLQ lane's shape
# (no jumps), one scenario with jump intervals at dt = 0, and a ragged batch
# with more inputs than states and a jump.
CT_SHAPES = [(10, 3, 4096, 32, ()), (2, 1, 1, 100, (30, 61)), (3, 5, 77, 6, (2,))]
CT_SUBSTEPS = 4  # DdpSettings.riccati_substeps
# The SLQ lane's batch, and the scenarios 132 SMs hold in one wave at 28 an
# SM (4 a block, 7 blocks an SM: the kernel's first geometry), timed side by
# side in one call.
CT_WAVE_BATCH, CT_FIRST_WAVE = 4096, 3696
# The hybrid phase's K1 shape: 40 base intervals and 3 event slots (N = 46),
# and the switch-time phase's (N = 40 with the event's jump interval).
HYB_SHAPE = (2, 1, 1, 46)
SWITCH_SHAPE = (2, 1, 1, 40)
HYBRID_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_data",
                             "hybrid_bouncing_mass_reference.npz")
# The hybrid solve against the JAX package's record: event times (s) and
# the cost (relative); states and inputs at SOLVE_ATOL / SOLVE_RTOL, as the
# kernel route against the plain one (see hybrid_open_step).
HYB_EVENT_ATOL, HYB_COST_RTOL = 1e-5, 1e-5
SWITCH_FD_EPS, SWITCH_FD_SHARE = 0.02, 0.25  # tests/test_hybrid.py's finite difference
SWITCH_RECORD = os.path.join(os.path.dirname(HYBRID_RECORD), "switch_time_exp0_reference.npz")
# The switch-time run against the JAX package's record (tests/
# test_torch_hybrid.py's tolerances): the gradient (relative, plus an
# absolute floor), event times (s), costs (relative).
SWITCH_GRAD_RTOL, SWITCH_GRAD_ATOL, SWITCH_THETA_ATOL, SWITCH_COST_RTOL = 1e-4, 1e-6, 1e-5, 1e-5


def random_ct(torch, riccati_ct, nx, nu, batch, n, seed, jumps=()):
    """Numpy-seeded continuous-time LQ data on the card (the recipe of
    tests/test_torch_riccati_ct.py): a uniform grid on [0, 1] with a
    duplicated node (dt = 0) after each jump interval; PD R and Q."""
    rng = np.random.default_rng(seed)
    r = lambda sc, *s: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    ex, eu = np.eye(nx, dtype=np.float32), np.eye(nu, dtype=np.float32)
    wq, wr, wj = r(0.1, batch, n + 1, nx, nx), r(0.05, batch, n + 1, nu, nu), r(0.1, batch, n, nx, nx)
    t = list(np.linspace(0.0, 1.0, n + 1 - len(jumps)).astype(np.float32))
    for j in sorted(jumps):
        t.insert(j + 1, t[j])
    is_jump = np.zeros(n, np.float32)
    is_jump[list(jumps)] = 1.0
    leaves = dict(
        A=r(0.5, batch, n + 1, nx, nx), B=r(0.5, batch, n + 1, nx, nu),
        Q=ex + wq + wq.transpose(0, 1, 3, 2), q=r(0.3, batch, n + 1, nx),
        R=eu + wr + wr.transpose(0, 1, 3, 2), r=r(0.3, batch, n + 1, nu),
        P=r(0.1, batch, n + 1, nu, nx), A_jump=ex + r(0.2, batch, n, nx, nx),
        Q_jump=ex + 0.5 * (wj + wj.transpose(0, 1, 3, 2)), q_jump=r(0.2, batch, n, nx),
        Qf=np.broadcast_to(ex, (batch, nx, nx)).copy(), qf=r(0.3, batch, nx),
        times=np.asarray(t, np.float32), is_jump=is_jump,
    )
    return riccati_ct.CtLqCoeffs(**{k: torch.as_tensor(np.ascontiguousarray(v), device=DEVICE)
                                    for k, v in leaves.items()})


def riccati_ct_bound(nx, nu, batch, n, substeps=CT_SUBSTEPS):
    """Least time for the CT sweep, the largest of three floors.

    * bytes: each input read once (node data at N+1 nodes, jump data at N
      intervals, the terminal value, the shared grid, reg), each output
      written once, over the memory rate;
    * flops: the function's arithmetic over the float32 rate: per right-hand
      side evaluation the interpolation of the node data, A'S (S A is its
      transpose, S being symmetric), B'S and B's, A's, the nu x nu Cholesky,
      the solve of nx + 1 columns, the symmetric G'K, G'k and the stage
      updates, 4 * substeps of them an interval, plus the step ends, the jump
      branch (the reference blends both branches at every interval), the
      blend and node k's gains;
    * chain: the intervals follow one another and so do, inside an interval,
      the 4 * substeps evaluations; an evaluation's S-dependent chain is a dot
      product of length nx (A'S), the two triangular solves (2 nu dependent
      multiply-adds, the pivots' reciprocals off the chain since R(theta)
      does not depend on S), a dot product of length nu (G'K) and the stage
      update, with a hand-over between threads after each; latencies as at
      ``riccati_bound``."""
    node = 2 * nx * nx + nx * nu + nx + nu * nu + nu + nu * nx
    floats_in = batch * ((n + 1) * node + n * (2 * nx * nx + nx) + nx * nx + nx + 1) + 2 * n + 1
    floats_out = batch * (n * (nu * nx + nu) + (n + 1) * (nx * nx + nx) + 2)
    nbytes = 4 * (floats_in + floats_out)
    solve = nu ** 3 // 3 + 2 * nu * nu * (nx + 1)
    per_eval = (
        2 * node                                   # interpolation
        + 2 * nx ** 3 + 2 * nu * nx * (nx + 1)     # A'S (S A = (A'S)'), [B'S | B's]
        + 2 * nx * nx + solve                      # A's, Cholesky + solves
        + 2 * nu * nx * nx + 2 * nu * nx           # G'K (symmetric), G'k
        + 6 * (nx * nx + nx)                       # sums, stage input
    )
    per_interval = (
        4 * substeps * per_eval + substeps * 4 * (nx * nx + nx)  # step ends, sym
        + 4 * nx ** 3 + 4 * nx * nx                # jump branch
        + 3 * (nx * nx + nx)                       # blend
        + 2 * nu * nx * (nx + 1) + solve + 4 * nu * nu  # gains, dv
    )
    flops = batch * n * per_interval
    dot = lambda m: FMA_CYCLES * (1 + (m - 1).bit_length())  # noqa: E731
    chain_cycles = n * 4 * substeps * (
        dot(nx) + 2 * nu * FMA_CYCLES + dot(nu) + FMA_CYCLES + 3 * EXCHANGE_CYCLES)
    terms = {
        "bytes": nbytes / PEAK_BYTES_PER_S, "flops": flops / PEAK_F32_FLOPS,
        "chain": chain_cycles / BOOST_CLOCK_HZ,
    }
    term = max(terms, key=terms.get)
    return {
        "bytes": nbytes, "flops": flops, "chain_cycles": chain_cycles,
        "bytes_ms": 1e3 * terms["bytes"], "flops_ms": 1e3 * terms["flops"],
        "chain_ms": 1e3 * terms["chain"], "bound_ms": 1e3 * terms[term],
        "bound_by": "bytes" if term == "bytes" else "operations", "bound_term": term,
    }


def check_ct_kernel(torch, riccati_ct, riccati_ct_cuda, shape, seed, timed):
    """The CT kernel, through the entry point the solvers call, against its
    plain version on the same data at K1's RTOL / ATOL: one launch per reg
    value of REG_VALUES at B = 1, the values spread over the scenarios of a
    batch."""
    nx, nu, batch, n, jumps = shape
    coeffs = random_ct(torch, riccati_ct, nx, nu, batch, n, seed, jumps)
    regs = ([torch.full((1,), v, device=DEVICE) for v in REG_VALUES] if batch == 1 else
            [torch.as_tensor(np.resize(np.asarray(REG_VALUES, np.float32), batch), device=DEVICE)])
    max_err, bad = 0.0, []
    for reg in regs:
        before = riccati_ct_cuda.launch_count
        out = riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS)
        torch.cuda.synchronize()
        assert riccati_ct_cuda.launch_count == before + 1
        err, bad_fields = compare_fields(
            torch, out, riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS, force_plain=True))
        max_err, bad = max(max_err, err), bad + bad_fields
    geometry = riccati_ct_cuda.card_geometry(nx, nu, batch, DEVICE)
    rec = {
        "phase": "kernel_check", "kernel": "riccati_ct_backward", "pivots": "strict",
        "nx": nx, "nu": nu, "B": batch, "N": n, "jump_intervals": list(jumps),
        "substeps": CT_SUBSTEPS, "reg_values": list(REG_VALUES),
        "blocks": geometry.blocks, "threads": geometry.threads,
        "shared_bytes": geometry.shared_bytes, "blocks_per_sm": geometry.blocks_per_sm,
        "waves": geometry.waves, "max_abs_err": max_err, "rtol": RTOL, "atol": ATOL,
        "ok": not bad,
    }
    if timed:
        reg = regs[-1]
        rec.update(riccati_ct_bound(nx, nu, batch, n))
        rec["kernel_ms"] = time_ms(
            torch, lambda: riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS), reps=20, warmup=3)
        rec["kernel_ms_queued"] = time_ms_queued(
            torch, lambda: riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS), reps=20, warmup=3)
        # 3 timed runs after the comparison's run (see check_kernel).
        rec["plain_ms"] = time_ms(
            torch, lambda: riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS, force_plain=True),
            reps=3, warmup=0)
    if timed and batch == CT_WAVE_BATCH:
        # The first CT_FIRST_WAVE scenarios alone, timed beside the whole batch
        # in turns: the two times part when the whole batch needs a second wave.
        part = coeffs._replace(**{
            f: getattr(coeffs, f)[:CT_FIRST_WAVE].contiguous()
            for f in coeffs._fields if f not in ("times", "is_jump")})
        part_reg = reg[:CT_FIRST_WAVE].contiguous()
        part_geometry = riccati_ct_cuda.card_geometry(nx, nu, CT_FIRST_WAVE, DEVICE)
        part_ms, whole_ms = [], []
        for _ in range(2):
            part_ms.append(time_ms(
                torch, lambda: riccati_ct.slq_backward(part, part_reg, CT_SUBSTEPS), reps=20,
                warmup=3))
            whole_ms.append(time_ms(
                torch, lambda: riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS), reps=20,
                warmup=3))
        rec["wave_check"] = {
            "B": [CT_FIRST_WAVE, batch], "kernel_ms": [min(part_ms), min(whole_ms)],
            "kernel_ms_runs": [part_ms, whole_ms],
            "waves": [part_geometry.waves, geometry.waves],
            "ratio": min(whole_ms) / min(part_ms),
        }
    emit(rec)
    if bad:
        raise SystemExit(f"riccati_ct_backward disagrees with its plain version at {shape}: {bad}")
    return rec


def check_ct_nan(torch, riccati_ct, shape, seed, scenario, node):
    """R = -I at one node of one scenario: the kernel's NaN entries are its
    plain version's, element for element (that node's gains and every
    earlier node of the scenario, dv1, dv2), the finite entries agree and
    the other scenarios stay finite."""
    nx, nu, batch, n, jumps = shape
    coeffs = random_ct(torch, riccati_ct, nx, nu, batch, n, seed, jumps)
    coeffs.R[scenario, node] = -torch.eye(nu, device=DEVICE)
    reg = torch.zeros((batch,), device=DEVICE)
    out = riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS)
    torch.cuda.synchronize()
    ref = riccati_ct.slq_backward(coeffs, reg, CT_SUBSTEPS, force_plain=True)
    err, bad = compare_fields(torch, out, ref, nan_equal=True)
    nan_nodes = torch.isnan(out.gains[scenario]).all(dim=(1, 2))
    others = [b for b in range(batch) if b != scenario]
    if (not bool(nan_nodes[:node + 1].all()) or bool(nan_nodes[node + 1:].any())
            or not bool(torch.isnan(out.dv1[scenario])) or not bool(torch.isfinite(out.gains[others]).all())):
        bad.append("placement")
    emit({"phase": "kernel_check", "kernel": "riccati_ct_backward", "pivots": "strict",
          "fixture": f"R = -I at node {node} of scenario {scenario}", "nx": nx, "nu": nu,
          "B": batch, "N": n, "nan_nodes": int(nan_nodes.sum()), "max_abs_err_of_finite": err,
          "ok": not bad})
    if bad:
        raise SystemExit(f"riccati_ct_backward: NaN placement differs at {shape}: {bad}")


def ballbot_batch(torch, batch=4096):
    """main_path's problem, grid and numpy-seeded initial states."""
    from ocs2_tpu_torch.models import ballbot
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid

    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        (0.1 * rng.standard_normal((batch, ballbot.NX))).astype(np.float32), device=DEVICE)
    return (ballbot.make_problem(device=DEVICE), ballbot.make_params(device=DEVICE),
            uniform_grid(0.0, 1.0, 32), x0s)


def slq_ballbot_b4096(torch, riccati_cuda, riccati_ct_cuda, main_run, solves=TIMED_SOLVES):
    """``ddp.solve`` with ``algorithm="slq"`` (8 iterations at most) on
    main_path's batch: a warm-up, ``solves`` timed solves, then the first 256
    scenarios again through ``force_plain_riccati``, held against the kernel
    route with main_path's tie rule.  The sweep is the CT kernel at
    (10, 3, 4096, 32), one launch a loop iteration (the batch's largest
    iteration count a solve); the discrete kernel is not launched."""
    from ocs2_tpu_torch.models import ballbot
    from ocs2_tpu_torch.solvers import ddp

    problem, params, grid, x0s = ballbot_batch(torch)
    batch, n = x0s.shape[0], grid.num_intervals
    settings = ddp.DdpSettings(algorithm="slq", max_iterations=8)

    def solve(x0, **kw):
        sol = ddp.solve(problem, grid, x0, params, settings=settings, device=DEVICE, **kw)
        torch.cuda.synchronize()
        return sol

    solve(x0s)  # warm-up
    riccati_cuda.launch_count = riccati_ct_cuda.launch_count = 0
    seconds, sols = [], []
    for _ in range(solves):
        t0 = time.perf_counter()
        sols.append(solve(x0s))
        seconds.append(time.perf_counter() - t0)
    launches, k1_launches = riccati_ct_cuda.launch_count, riccati_cuda.launch_count
    dims = riccati_ct_cuda.last_launch_dims
    sol = sols[-1]
    sweeps_run = sum(int(s.iterations.max()) for s in sols)
    assert launches == sweeps_run and launches > 0, (launches, sweeps_run)
    assert k1_launches == 0, f"SLQ launched the discrete kernel {k1_launches} times"
    assert dims == (batch, n, ballbot.NX, ballbot.NU, settings.riccati_substeps), dims
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    first = sol.history.merit[:, 0]
    assert bool((sol.performance.merit <= first * (1 + 1e-6)).all())

    sub = x0s[:256]
    err, tied, tie_details = compare_with_ties(
        torch, solve(sub), solve(sub, force_plain_riccati=True), "ballbot SLQ kernel vs plain")
    # The first SLQ_RECORD_BATCH scenarios against the JAX package's batched SLQ.
    jax_rec = load_record(SLQ_RECORD)
    first = slice(0, SLQ_RECORD_BATCH)
    assert np.array_equal(jax_rec["x0s"], x0s[first].cpu().numpy()), "the record's scenarios differ"
    vs_record = compare_with_record(torch, take_rows(sol, first), jax_rec, "",
                                    "ballbot SLQ vs the JAX record")
    sec = statistics.median(seconds)
    its = sol.iterations.tolist()
    rec = {
        "phase": "slq_ballbot_b4096", "problem": "ballbot", "algorithm": "slq", "B": batch,
        "N": n, "nx": ballbot.NX, "nu": ballbot.NU, "max_iterations": settings.max_iterations,
        "riccati_substeps": settings.riccati_substeps, "rollout_substeps": settings._substeps,
        "solves_timed": solves, "seconds_per_solve": sec, "solves_per_s": batch / sec,
        "ilqr_solves_per_s_same_scenarios": main_run["solves_per_s"],
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "mean_iterations": float(sol.iterations.float().mean()),
        "converged_share": float(sol.converged.float().mean()),
        "median_cost": float(sol.performance.cost.median()),
        "riccati_ct_launches": launches, "riccati_launches": k1_launches,
        "kernel_vs_plain_solve_max_abs_err": err,
        "kernel_vs_plain_tied_scenarios": tied, "kernel_vs_plain_ties": tie_details,
        "vs_jax_record": vs_record,
        "iterations_equal_to_jax_record": int((sol.iterations[first].cpu().numpy()
                                               == jax_rec["iterations"]).sum()),
        "converged_share_record_set": float(sol.converged[first].float().mean()),
        "jax_converged_share_record_set": float(jax_rec["converged"].mean()),
        "median_cost_record_set": float(sol.performance.cost[first].median()),
        "jax_median_cost_record_set": float(np.median(jax_rec["cost"])),
        "jax_converged_share": float(jax_rec["all_converged"].mean()),
        "jax_at_budget": int((jax_rec["all_iterations"] == settings.max_iterations).sum()),
    }
    emit(rec)
    return rec


# The bouncing mass of tests/test_hybrid_ddp.py:126-176, written again here
# (no import from tests/): x = (height, velocity), thrust input, a bounce at
# h = 0 reverses the velocity with restitution 0.8 and counts the mode up.
BALL_G, BALL_RESTITUTION = 9.81, 0.8
HYB_T_FINAL, HYB_TARGET = 1.2, (0.8, 0.0)
HYB_KW = dict(num_base_intervals=40, max_events=3, outer_rounds=3)


def bouncing_mass(torch):
    from ocs2_tpu_torch.core.reference import TargetTrajectories
    from ocs2_tpu_torch.oc.hybrid_rollout import HybridSystem
    from ocs2_tpu_torch.oc.problem import OptimalControlProblem, quadratic_cost

    def flow(t, x, u, p, mode=None):
        return torch.stack([x[..., 1], u[..., 0] - BALL_G], -1)

    def bounce(t, x, p):
        return torch.stack([1e-4 + 0.0 * x[..., 0], -BALL_RESTITUTION * x[..., 1]], -1)

    system = HybridSystem(dynamics=flow, guard=lambda t, x, p, mode: x[..., 0],
                          jump=lambda t, x, p, mode: (bounce(t, x, p), mode + 1))
    problem = OptimalControlProblem(
        dynamics=lambda t, x, u, p: flow(t, x, u, p), jump_map=bounce,
        cost_terms=(quadratic_cost(np.diag([4.0, 0.1]).astype(np.float32),
                                   0.05 * np.eye(1, dtype=np.float32), device=DEVICE),),
        nx=2, nu=1)
    params = {"target": TargetTrajectories.constant(
        np.asarray(HYB_TARGET, np.float32), np.zeros(1, np.float32), device=DEVICE)}
    return system, problem, params


def hybrid_open_step(torch, riccati, problem, params, settings, hsol):
    """The LQ data at a returned hybrid solve (its grid holds the intervals
    the events cut short), on the card, and the float64 sweep of them on the
    CPU.  The float64 ``kff`` is the Newton step the solve leaves open on
    each interval; -(dv1 + dv2) is the merit decrease that step predicts."""
    from ocs2_tpu_torch.oc.approx import approximate_lq
    from ocs2_tpu_torch.solvers import ddp

    lq = approximate_lq(problem, hsol.grid, hsol.ddp.xs, hsol.ddp.us, params,
                        method=settings.integrator, substeps=settings._substeps)
    coeffs = ddp._lq_to_coeffs(lq)
    f64 = riccati.LqrCoeffs(*(leaf[0].double().cpu() for leaf in coeffs))
    return coeffs, riccati._lqr_backward_single(
        f64, torch.tensor(settings.reg_init, dtype=torch.float64))


def hybrid_bouncing_mass(torch, riccati_cuda, riccati_ct_cuda, at_hyb, hybrid_out=None):
    """``solve_state_triggered`` on the bouncing mass (t in [0, 1.2], 40 base
    intervals, 3 event slots, 3 outer rounds, iLQR with 25 iterations and
    min_rel_cost 1e-4) at B = 1: the sweep is the discrete kernel at
    (2, 1, 1, 46) with strict pivots.  Checks the JAX test's assertions
    (finite states, the grid's events within 4 rollout steps of the final
    policy's, a bounce, a cost below free fall), a re-run through
    ``force_plain_riccati`` (equal events to HYB_EVENT_ATOL, iterations equal
    or tied, states and inputs on every interval within SOLVE_ATOL +
    SOLVE_RTOL |value|, plus, on an interval where the solve leaves a Newton
    step larger than SOLVE_ATOL open, that step), the kernel against its
    plain version on the solve's own LQ data at K1's tolerance, and the JAX
    package's record (HYBRID_RECORD: events, modes, cost, states, inputs)."""
    from ocs2_tpu_torch.oc.hybrid_rollout import rollout_state_triggered
    from ocs2_tpu_torch.oc.metrics import evaluate_trajectory
    from ocs2_tpu_torch.oc.rollout import open_loop_policy, rollout
    from ocs2_tpu_torch.ops import riccati
    from ocs2_tpu_torch.solvers import ddp
    from ocs2_tpu_torch.solvers.hybrid_ddp import solve_state_triggered

    system, problem, params = bouncing_mass(torch)
    settings = ddp.DdpSettings(max_iterations=25, min_rel_cost=1e-4)
    x0 = torch.tensor([1.0, 0.0], device=DEVICE)

    def solve(**kw):
        sol = solve_state_triggered(system, problem, 0.0, HYB_T_FINAL, x0, params,
                                    settings=settings, device=DEVICE, **HYB_KW, **kw)
        torch.cuda.synchronize()
        return sol

    solve()  # warm-up
    riccati_cuda.launch_count = riccati_ct_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    t0 = time.perf_counter()
    sol = solve()
    seconds = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    assert launches >= int(sol.ddp.iterations[0]) and launches > 0, launches
    assert riccati_ct_cuda.launch_count == 0
    assert dims == HYB_SHAPE[2:] + HYB_SHAPE[:2], dims

    steps = 2 * HYB_KW["num_base_intervals"]
    dt_roll = HYB_T_FINAL / steps
    assert bool(torch.isfinite(sol.ddp.xs).all())
    grid_ev = sol.event_times[torch.isfinite(sol.event_times)]
    final_ev = sol.rollout.event_times[sol.rollout.event_mask > 0]
    assert final_ev.numel() >= 1, "no bounce"
    for ge in grid_ev.tolist():
        assert float((final_ev - ge).abs().min()) < 4 * dt_roll, (grid_ev, final_ev)
    xs0, us0 = rollout(problem, sol.grid, x0[None],
                       open_loop_policy(torch.zeros_like(sol.ddp.us[0])), params)
    free_fall = float(evaluate_trajectory(problem, sol.grid, xs0, us0, params).cost[0])
    cost = float(sol.ddp.performance.cost[0])
    assert cost < free_fall, (cost, free_fall)

    plain = solve(force_plain_riccati=True)
    assert bool((torch.isfinite(plain.event_times) == torch.isfinite(sol.event_times)).all())
    fin = torch.isfinite(sol.event_times)
    plain_event_err = float((plain.event_times[fin] - sol.event_times[fin]).abs().max())
    assert plain_event_err <= HYB_EVENT_ATOL, plain_event_err
    # Equal iterations, or a tie at the final round's stationary iterate
    # (main_path's rule: merits within 1e-6).
    k_it, p_it = int(sol.ddp.iterations[0]), int(plain.ddp.iterations[0])
    k_merit, p_merit = float(sol.ddp.performance.merit[0]), float(plain.ddp.performance.merit[0])
    merit_rel = abs(k_merit - p_merit) / abs(p_merit)
    assert k_it == p_it or merit_rel <= 1e-6, ("hybrid kernel vs plain", k_it, p_it, merit_rel)
    xs_err = (sol.ddp.xs - plain.ddp.xs).abs()
    assert bool((xs_err <= SOLVE_ATOL + SOLVE_RTOL * plain.ddp.xs.abs()).all()), float(xs_err.max())

    # The kernel on the solve's own data: the LQ approximation at the kernel
    # route's solution, through K1 (strict, B = 1) and its plain version at
    # K1's RTOL / ATOL; both beside the float64 sweep of the same data.
    coeffs, k64 = hybrid_open_step(torch, riccati, problem, params, settings, sol)
    reg = torch.full((1,), settings.reg_init, device=DEVICE)
    k_out = riccati.lqr_backward(coeffs, reg)
    p_out = riccati._lqr_backward_batched(coeffs, reg, strict=True)
    torch.cuda.synchronize()
    data_err, bad = compare_fields(torch, k_out, p_out)
    assert not bad, ("K1 vs its plain version on the hybrid solve's data", bad)
    from_f64 = {name: max(float((getattr(o, f)[0].double().cpu() - getattr(k64, f)).abs().max())
                          for f in ("gains", "kff", "value_S", "value_s"))
                for name, o in (("kernel", k_out), ("plain", p_out))}

    # The inputs, on every interval.  Each route stops when its merit falls
    # by less than min_rel_cost; the Newton step still open at its solution
    # (float64) then bounds how far the input of an interval is determined.
    # Where that step exceeds SOLVE_ATOL (an interval a bounce cuts to a few
    # ms, whose input weighs R dt), the routes may differ by it: the whole
    # open step must predict a decrease under min_rel_cost (the solver was
    # entitled to stop), and on every other interval the bound is SOLVE_ATOL
    # + SOLVE_RTOL |u| alone.
    _, p64 = hybrid_open_step(torch, riccati, problem, params, settings, plain)
    open_step = torch.maximum(k64.kff.abs(), p64.kff.abs()).float().to(DEVICE)[None]
    predicted = [float(-(s64.dv1 + s64.dv2)) / abs(m)
                 for s64, m in ((k64, k_merit), (p64, p_merit))]
    assert max(predicted) <= settings.min_rel_cost, ("open step's predicted decrease", predicted)
    undetermined = open_step > SOLVE_ATOL
    slack = torch.where(undetermined, open_step, torch.zeros_like(open_step))

    def us_within(us, ref_us):
        err = (us - ref_us).abs()
        ok = err <= SOLVE_ATOL + SOLVE_RTOL * ref_us.abs() + slack
        return bool(ok.all()), float(err[~undetermined].max()), (
            float(err[undetermined].max()) if bool(undetermined.any()) else 0.0)

    us_ok, us_det, us_undet = us_within(sol.ddp.us, plain.ddp.us)
    assert us_ok, ("hybrid kernel vs plain: us", us_det, us_undet)
    open_rows = torch.nonzero(undetermined[0].any(-1)).flatten().tolist()
    plain_err = {"xs": float(xs_err.max()), "us_determined_intervals": us_det,
                 "us_undetermined_intervals": us_undet, "merit_rel": merit_rel}
    open_info = {
        "intervals": open_rows, "dt": [float(sol.grid.dts[k]) for k in open_rows],
        "open_step": [float(open_step[0, k].max()) for k in open_rows],
        "largest_open_step_elsewhere": float(open_step[~undetermined].max()),
        "predicted_rel_decrease_kernel_plain": predicted,
        "k1_vs_plain_on_solve_data_max_abs_err": data_err,
        "max_abs_diff_from_float64": from_f64,
    }

    with np.load(HYBRID_RECORD) as f:
        ref = {k: f[k] for k in f.files}
    ev = sol.event_times.cpu().numpy()
    assert np.array_equal(np.isfinite(ev), np.isfinite(ref["event_times"]))
    fin_ev = np.isfinite(ev)
    ref_event_err = float(np.abs(ev[fin_ev] - ref["event_times"][fin_ev]).max())
    assert ref_event_err <= HYB_EVENT_ATOL, ref_event_err
    assert np.array_equal(sol.mode_sequence.cpu().numpy(), ref["mode_sequence"])
    ref_cost_rel = abs(cost - float(ref["cost"])) / abs(float(ref["cost"]))
    assert ref_cost_rel <= HYB_COST_RTOL, ref_cost_rel
    ref_xs = torch.as_tensor(ref["xs"], device=DEVICE)[None]
    ref_xs_err = float((sol.ddp.xs - ref_xs).abs().max())
    assert bool(((sol.ddp.xs - ref_xs).abs() <= SOLVE_ATOL + SOLVE_RTOL * ref_xs.abs()).all()), (
        "hybrid vs the JAX record: xs", ref_xs_err)
    ref_us_ok, ref_us_det, ref_us_undet = us_within(
        sol.ddp.us, torch.as_tensor(ref["us"], device=DEVICE)[None])
    assert ref_us_ok, ("hybrid vs the JAX record: us", ref_us_det, ref_us_undet)

    policy = lambda t, x, k: torch.zeros(1, device=DEVICE)  # noqa: E731
    rollout_st = lambda: rollout_state_triggered(  # noqa: E731
        system, 0.0, x0, policy, dt_roll, steps, params)
    _, rollout_ms = timed_stage(torch, rollout_st, reps=3)
    rec = {
        "phase": "hybrid_bouncing_mass", "B": 1, "N": HYB_SHAPE[3], "nx": 2, "nu": 1,
        **HYB_KW, "rollout_steps": steps, "seconds_per_solve": seconds,
        "rounds_run": sol.rounds_run, "final_round_iterations": int(sol.ddp.iterations[0]),
        "event_times": [float(v) for v in ev], "mode_sequence": sol.mode_sequence.tolist(),
        "event_drift": [float(v) for v in sol.event_drift.cpu()],
        "cost": cost, "free_fall_cost": free_fall, "riccati_launches": launches,
        "kernel_vs_plain_event_max_abs_diff": plain_event_err,
        "kernel_vs_plain_solve_max_abs_err": plain_err,
        "kernel_vs_plain_iterations": [k_it, p_it],
        "reference_event_max_abs_diff": ref_event_err, "reference_cost_rel_diff": ref_cost_rel,
        "reference_xs_max_abs_diff": ref_xs_err,
        "reference_us_max_abs_diff": {"determined_intervals": ref_us_det,
                                      "undetermined_intervals": ref_us_undet},
        "open_newton_step": open_info,
        "state_triggered_rollout_ms": rollout_ms,
        "kernel_ms": at_hyb["kernel_ms"],
    }
    if hybrid_out:
        with open(hybrid_out, "w") as f:
            json.dump({"event_times": rec["event_times"], "mode_sequence": rec["mode_sequence"],
                       "cost": cost, "xs": sol.ddp.xs[0].tolist(),
                       "us": sol.ddp.us[0].tolist()}, f)
    emit(rec)
    return rec


# tests/test_hybrid.py:95-148's switched linear system, written again here.
SWITCH_A = (((-0.1, 1.0), (0.0, -0.2)), ((-0.5, 0.0), (1.0, -0.1)))
SWITCH_B = ((0.0,), (1.0,))
SWITCH_THETA0, SWITCH_ITERATIONS = 0.9, 5


def switched_problem(torch):
    from ocs2_tpu_torch.oc.problem import OptimalControlProblem

    a_modes = torch.tensor(SWITCH_A, device=DEVICE)
    b = torch.tensor(SWITCH_B, device=DEVICE)

    def dynamics(t, x, u, p):
        mode = p["mode"]  # one index, or one per node of a batch of nodes
        a = a_modes.index_select(0, mode.reshape(-1)).reshape(mode.shape + (2, 2))
        return (a @ x.unsqueeze(-1)).squeeze(-1) + u @ b.T

    def cost(t, x, u, p):
        return 0.5 * torch.sum(x * x, -1) + 0.5 * torch.sum(u * u, -1)

    return OptimalControlProblem(dynamics=dynamics, cost_terms=(cost,), nx=2, nu=1)


def switch_time_exp0(torch, riccati_cuda, at_switch):
    """``optimize_switch_times`` (SQP, 15 iterations, N = 40 over [0, 2]) for
    5 upper-level iterations from theta = 0.9; the sweep is the discrete
    kernel at (2, 1, 1, 40) with strict pivots.  ``switch_time_gradients`` at
    theta0 is held against a central difference of the solved cost (eps 0.02,
    within 25 %, tests/test_hybrid.py's bound), and the gradient, the
    difference's two costs and every upper iterate's event time and cost
    against the JAX package's record (SWITCH_RECORD; ROADMAP §3: there the
    gradient's sign is the difference's opposite, and the loop climbs)."""
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid
    from ocs2_tpu_torch.solvers import sqp, switch_time

    problem = switched_problem(torch)
    x0 = torch.tensor([1.0, 0.0], device=DEVICE)
    settings = sqp.SqpSettings(max_iterations=15)
    n = SWITCH_SHAPE[3]

    def solve_fn(grid, x, p):
        return sqp.solve(problem, grid, x, p, settings=settings, device=DEVICE)

    def solve_at(theta):
        grid = make_time_grid(0.0, 2.0, n, event_times=[theta], mode_sequence=[0, 1])
        return solve_fn(grid, x0, {}), grid

    sol, grid = solve_at(SWITCH_THETA0)
    g = float(switch_time.switch_time_gradients(problem, grid, sol.xs, sol.us, sol.value_s,
                                                {}).sum())
    cost_at = lambda th: float(solve_at(th)[0].performance.cost[0])  # noqa: E731
    cost_plus, cost_minus = cost_at(SWITCH_THETA0 + SWITCH_FD_EPS), cost_at(SWITCH_THETA0 - SWITCH_FD_EPS)
    fd = (cost_plus - cost_minus) / (2 * SWITCH_FD_EPS)
    assert abs(g - fd) < SWITCH_FD_SHARE * max(abs(fd), 0.1), (g, fd)
    with np.load(SWITCH_RECORD) as f:
        ref = {k: f[k] for k in f.files}
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    ref_g = float(ref["gradient_at_theta0"])
    assert abs(g - ref_g) <= SWITCH_GRAD_ATOL + SWITCH_GRAD_RTOL * abs(ref_g), (g, ref_g)
    fd_cost_rel = max(rel(cost_plus, float(ref["cost_plus"])), rel(cost_minus, float(ref["cost_minus"])))
    assert fd_cost_rel <= SWITCH_COST_RTOL, fd_cost_rel

    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    t0 = time.perf_counter()
    res = switch_time.optimize_switch_times(
        problem, solve_fn, x0, {}, 0.0, 2.0, n, [SWITCH_THETA0], [0, 1],
        iterations=SWITCH_ITERATIONS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    assert launches > 0 and dims == SWITCH_SHAPE[2:] + SWITCH_SHAPE[:2], (launches, dims)
    costs = [c for _, c in res.history]
    thetas = [float(t[0]) for t, _ in res.history]
    assert len(costs) == len(ref["cost_history"]) == SWITCH_ITERATIONS
    theta_err = float(np.abs(np.asarray(thetas) - ref["theta_history"]).max())
    cost_rel = float((np.abs(np.asarray(costs) - ref["cost_history"]) / np.abs(ref["cost_history"])).max())
    assert theta_err <= SWITCH_THETA_ATOL, ("switch times vs the JAX record", thetas, theta_err)
    assert cost_rel <= SWITCH_COST_RTOL, ("costs vs the JAX record", costs, cost_rel)
    assert abs(float(res.event_times[0]) - float(ref["event_time_found"])) <= SWITCH_THETA_ATOL
    assert rel(res.cost, float(ref["cost"])) <= SWITCH_COST_RTOL, (res.cost, float(ref["cost"]))
    rec = {
        "phase": "switch_time_exp0", "B": 1, "N": n, "nx": 2, "nu": 1,
        "upper_iterations": SWITCH_ITERATIONS, "theta0": SWITCH_THETA0,
        "gradient_at_theta0": g, "finite_difference_at_theta0": fd,
        "event_time_found": float(res.event_times[0]), "cost": res.cost,
        "cost_history": costs, "theta_history": thetas, "reference_gradient": ref_g,
        "reference_finite_difference": float(ref["finite_difference_at_theta0"]),
        "reference_theta_max_abs_diff": theta_err, "reference_cost_max_rel_diff": cost_rel,
        "reference_fd_cost_max_rel_diff": fd_cost_rel, "seconds": seconds, "riccati_launches": launches, "kernel_ms": at_switch["kernel_ms"],
    }
    emit(rec)
    return rec


# -- the robot model zoo: cartpole swing-ups, the mobile manipulator, URDF arms -----

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_data")
# SLQ_RECORD: the JAX package's batched SLQ on the first SLQ_RECORD_BATCH of
# slq_ballbot_b4096's scenarios (tools/slq_reference.py).
SLQ_RECORD, SLQ_RECORD_BATCH = os.path.join(_DATA, "slq_ballbot_reference.npz"), 64
# Swing-ups from scattered starts (tests/test_ddp.py:82-115's horizon): SLQ
# without the input bound, iLQR with the bound as a hard (augmented
# Lagrangian) inequality, 6 iterations each (the tests run 60 and 100; a
# depth cut to keep the zoo's phases near 50 s on the card, PERF.md §4).
CARTPOLE_SHAPE = (4, 1, 4096, 60)
CARTPOLE_HORIZON, CARTPOLE_SEED = 3.0, 5
CARTPOLE_SOLVES = {  # lane: (constraint mode, DdpSettings' arguments)
    "slq": ("none", dict(algorithm="slq", max_iterations=6, min_rel_cost=1e-5)),
    "ilqr": ("hard", dict(algorithm="ilqr", max_iterations=6, min_rel_cost=1e-6)),
}
CARTPOLE_RECORD_BATCH, CARTPOLE_PLAIN_BATCH, CARTPOLE_UPRIGHT_RAD = 64, 64, 0.2
CARTPOLE_RECORD = os.path.join(_DATA, "cartpole_swingup_reference.npz")
# The built-in mobile manipulator (tests/test_robot_zoo.py:98-130): SQP, rk2,
# N = 40 over 3 s, 40 iterations at most, the soft problem with self-collision.
# The b256 batch stops at 30 (a depth cut for the card's time, PERF.md §4:
# its first 32 targets converge within 28, and 4 of the 256 need more).
MANIP_N, MANIP_HORIZON, MANIP_MAX_ITERATIONS, MANIP_B256_MAX_ITERATIONS = 40, 3.0, 40, 30
MANIP_TARGETS = {"reach": (1.2, 0.4, 0.9), "self_collision": (0.1, 0.0, 0.4)}
MANIP_BATCH, MANIP_PLAIN_BATCH, MANIP_SEED = 256, 32, 9
MANIP_EE_TOL, MANIP_JOINT_TOL, MANIP_SPHERE_TOL = 0.05, 1e-3, -0.01  # the JAX tests' bounds
# URDF arms on the reference's base types (tests/test_manipulator_variants.py:
# 40-72): SQP, rk4, N = 40 over 2 s, 25 iterations at most, the target 0.15,
# 0.1, -0.1 m from the home EE position.
URDF_ARMS = {
    "franka": dict(urdf="franka_panda.urdf", base="root", ee="panda_hand_tcp",
                   remove=("panda_finger_joint1", "panda_finger_joint2"), q_home=None),
    # The all-zero midpoint of the UR5 is a stretched singular configuration:
    # its canonical elbow-up home instead.
    "ur5": dict(urdf="ur5.urdf", base="base_link", ee="ee_link", remove=(),
                q_home=(0.0, -1.2, 1.6, -0.4, 1.5708, 0.0)),
}
URDF_VARIANTS = [("franka", "default"), ("franka", "wheel_based"), ("franka", "floating_arm"),
                 ("franka", "fully_actuated_floating_arm"), ("ur5", "default"),
                 ("ur5", "fully_actuated_floating_arm")]
URDF_N, URDF_HORIZON, URDF_MAX_ITERATIONS, URDF_EE_TOL = 40, 2.0, 25, 0.03
URDF_TARGET_OFFSET = (0.15, 0.1, -0.1)
MANIP_RECORD = os.path.join(_DATA, "manipulator_reference.npz")
# K1's shapes on the zoo's paths (nx, nu, B, N): the cartpole iLQR batch
# (clamp), the manipulator at B = 1 (strict) and 256 (clamp), and the URDF
# variants (strict): franka (7, 7), (10, 9), (13, 7), (13, 13), UR5 (6, 6),
# (12, 12).  K6's: the cartpole SLQ batch.
ZOO_SHAPES = [(4, 1, 4096, 60), (9, 8, 1, 40), (9, 8, 256, 40), (7, 7, 1, 40), (10, 9, 1, 40),
              (13, 7, 1, 40), (13, 13, 1, 40), (6, 6, 1, 40), (12, 12, 1, 40)]
ZOO_CT_SHAPE = (4, 1, 4096, 60, ())


# MPC-Net (ocs2_tpu/learning/robots.py's defaults).  The record
# (tools/mpcnet_reference.py) holds the JAX package's training runs from
# these PRNGKeys; mpcnet_legged_datagen_b256 draws its starts from a numpy
# seed as legged_x0_sampler draws them, and the record holds its first 32.
MPCNET_RECORD = os.path.join(_DATA, "mpcnet_reference.npz")
MPCNET_KEYS = {"legged": 5, "ballbot": 2}
MPCNET_B256, MPCNET_B256_RECORD, MPCNET_B256_SEED, MPCNET_B256_STEPS = 256, 32, 17, 20
MPCNET_SHAPES = {"legged": (24, 12, 4, 14), "b256": (24, 12, MPCNET_B256, 14),
                 "ballbot": (10, 3, 8, 16)}
# evaluate() rolls one scenario out, so its solves are strict at B = 1.
MPCNET_EVAL_SHAPES = {"legged": (24, 12, 1, 14), "ballbot": (10, 3, 1, 16)}
MPCNET_BALLBOT_LEAN = 0.12  # tests/test_learning.py:278-309: x[3] = 0.12
# legged_x0_sampler's scales (momenta, base position, orientation, joints).
MPCNET_LEGGED_X0_SCALE = np.concatenate([np.full(6, 0.05), np.full(3, 0.02), np.full(3, 0.03),
                                         np.full(12, 0.05)]).astype(np.float32)


def mpcnet_b256_x0s(default_state, batch=MPCNET_B256):
    """Perturbed stands as legged_x0_sampler makes them, the noise from
    MPCNET_B256_SEED, computed in numpy float32 from the given default state
    (each package passes its own)."""
    noise = np.random.default_rng(MPCNET_B256_SEED).standard_normal((batch, 24)).astype(np.float32)
    base = np.asarray(default_state, np.float32)
    return (base[None] + MPCNET_LEGGED_X0_SCALE[None] * noise).astype(np.float32)


def cartpole_x0s(batch):
    """[pi + 0.3 a, 0.5 b, 0, 0], a and b uniform in [-1, 1] from CARTPOLE_SEED."""
    ab = np.random.default_rng(CARTPOLE_SEED).uniform(-1.0, 1.0, (batch, 2))
    x0s = np.zeros((batch, 4))
    x0s[:, 0] = np.pi + 0.3 * ab[:, 0]
    x0s[:, 1] = 0.5 * ab[:, 1]
    return x0s.astype(np.float32)


def manipulator_targets(batch):
    """EE targets uniform in the box the two targets of MANIP_TARGETS span."""
    lo, hi = np.minimum(*MANIP_TARGETS.values()), np.maximum(*MANIP_TARGETS.values())
    rng = np.random.default_rng(MANIP_SEED)
    return (lo + (hi - lo) * rng.uniform(0.0, 1.0, (batch, 3))).astype(np.float32)


def record_solution(torch, rec, prefix="", rows=slice(None), device=None):
    """A solution-like view (iterations, performance.merit, xs, us) of a JAX
    record's arrays on ``device`` (DEVICE by default); ``rows=None`` makes a
    record of one solve a batch of one."""
    def leaf(key):
        return torch.as_tensor(np.array(rec[prefix + key])[rows], device=device or DEVICE)

    return take_rows({k: leaf(k) for k in ("iterations", "merit", "xs", "us")})


def take_rows(sol, rows=slice(None)):
    """Rows of a solution (or of a dict of its four leaves) as a solution-like
    view: iterations, performance.merit, xs, us."""
    from types import SimpleNamespace

    if isinstance(sol, dict):
        its, merit, xs, us = sol["iterations"], sol["merit"], sol["xs"], sol["us"]
    else:
        its, merit, xs, us = sol.iterations, sol.performance.merit, sol.xs, sol.us
    return SimpleNamespace(iterations=its[rows], xs=xs[rows], us=us[rows],
                           performance=SimpleNamespace(merit=merit[rows]))


def hold_within_spread(torch, sol, ref, spread, iterations_lo, iterations_hi, what):
    """``sol`` against ``ref`` scenario by scenario.

    A scenario is held as compare_with_ties holds two routes: iterations
    equal or tied (merit equal to 1e-6 relative, the inputs then not held),
    xs and us within SOLVE_ATOL + SOLVE_RTOL |value|.  ``spread`` ([B] per
    field, xs and us) is the JAX package's own difference between its routes
    to the scenario (record_spread): where it is wider than SOLVE_ATOL
    the JAX package itself decides the scenario by float32 rounding, and a
    scenario outside the tolerance is then held to the spread (xs and us
    within it, iterations within [iterations_lo, iterations_hi]), never past
    it.  Returns the largest differences and the scenarios held to the
    spread."""
    rel = (sol.performance.merit - ref.performance.merit).abs() / (
        ref.performance.merit.abs().clamp(min=1e-30))
    tied = (sol.iterations != ref.iterations) & (rel <= 1e-6)
    strict = (sol.iterations == ref.iterations) | tied
    wide = torch.zeros_like(strict)
    in_spread = (sol.iterations >= iterations_lo) & (sol.iterations <= iterations_hi)
    err = {}
    for f in ("xs", "us"):
        a, b = getattr(sol, f), getattr(ref, f)
        d = (a - b).abs()
        tol = SOLVE_ATOL + SOLVE_RTOL * b.abs()
        width = spread[f].reshape(-1, 1, 1)
        err[f] = float(d.max())
        ok = (d <= tol).flatten(1).all(1)
        strict &= (ok | tied) if f == "us" else ok
        wide |= width.flatten() > SOLVE_ATOL
        in_spread &= (d <= torch.maximum(tol, width)).flatten(1).all(1)
    held = ~strict & wide & in_spread
    bad = torch.nonzero(~(strict | held)).flatten().tolist()
    assert not bad, (f"{what}: scenarios outside the tolerance and the JAX package's spread",
                     bad, err, sol.iterations.tolist(), ref.iterations.tolist())
    err["held_to_jax_spread"] = torch.nonzero(held).flatten().tolist()
    err["tied"] = torch.nonzero(tied).flatten().tolist()
    return err


def record_spread(torch, rec, prefix, rows=slice(None), device=None):
    """The JAX package's own spread of a record (``tools/_spread.py``): per
    scenario the largest distance in xs and us from the record to its other
    routes (the scenario solved alone, and vmapped alone), and the range of
    the iteration counts over all of them.  Returns ({"xs", "us"}, lo, hi)."""
    def leaf(key):
        return torch.as_tensor(np.array(rec[prefix + key])[rows], device=device or DEVICE)

    return ({"xs": leaf("spread_xs"), "us": leaf("spread_us")}, leaf("iterations_lo"),
            leaf("iterations_hi"))


def compare_with_record(torch, sol, rec, prefix, what, rows=slice(None)):
    """A port solve against a JAX record (``tools/*_reference.py``) by
    hold_within_spread, iterations held to the range of the JAX package's
    counts where the record's spread is wider than the tolerance."""
    ref = record_solution(torch, rec, prefix, rows, device=sol.xs.device)
    spread, lo, hi = record_spread(torch, rec, prefix, rows, device=sol.xs.device)
    return hold_within_spread(torch, sol, ref, spread, lo, hi, what)


def urdf_variant_key(arm, base_type):
    return f"{arm}_{base_type}"


def load_record(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def upright_share(xs):
    """Share of swing-ups whose pole ends within CARTPOLE_UPRIGHT_RAD of
    upright (|theta| at the last node, as tests/test_ddp.py reads it)."""
    return float((xs[:, -1, 0].abs() < CARTPOLE_UPRIGHT_RAD).float().mean())


def cartpole_swingup_b4096(torch, riccati_cuda, riccati_ct_cuda, at_k1, at_k6):
    """4,096 cartpole swing-ups from scattered starts (cartpole_x0s), N = 60
    over 3 s, 6 iterations: ``ddp.solve`` with SLQ on the unconstrained
    problem (the sweep: K6 at (4, 1, 4096, 60)) and with iLQR on the hard
    input bound, an augmented-Lagrangian inequality (K1 at (4, 1, 4096, 60),
    clamped).  Per lane: a one-iteration warm-up on the first
    CARTPOLE_PLAIN_BATCH starts, one timed solve of the whole batch, then the
    plain route on the first CARTPOLE_PLAIN_BATCH, held against those rows of
    the kernel route's; the whole batch's first CARTPOLE_RECORD_BATCH
    scenarios against the JAX package's record.  Both comparisons take
    hold_within_spread's rule: equal iterations (or a tie) and SOLVE_ATOL +
    SOLVE_RTOL |value|, or, on a start where the JAX package's own routes
    part by more (the record's spread; at 20 iterations one start of the 64
    with the hard bound parted by 0.095 in xs), within that spread."""
    from ocs2_tpu_torch.models import cartpole
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.solvers import ddp

    nx, nu, batch, n = CARTPOLE_SHAPE
    grid = uniform_grid(0.0, CARTPOLE_HORIZON, n)
    params = cartpole.make_params(device=DEVICE)
    x0_np = cartpole_x0s(batch)
    x0s = torch.as_tensor(x0_np, device=DEVICE)
    rec = load_record(CARTPOLE_RECORD)
    assert np.array_equal(rec["x0s"], x0_np[:CARTPOLE_RECORD_BATCH]), "the record's starts differ"
    out = {"phase": "cartpole_swingup_b4096", "problem": "cartpole", "B": batch, "N": n,
           "nx": nx, "nu": nu, "horizon_s": CARTPOLE_HORIZON}
    for lane, (mode, kw) in CARTPOLE_SOLVES.items():
        problem = cartpole.make_problem(mode, device=DEVICE)
        settings = ddp.DdpSettings(**kw)

        def solve(x0, st=settings, **k):
            sol = ddp.solve(problem, grid, x0, params, settings=st, device=DEVICE, **k)
            torch.cuda.synchronize()
            return sol

        sub = slice(0, CARTPOLE_PLAIN_BATCH)
        t0 = time.perf_counter()
        solve(x0s[sub], dataclasses.replace(settings, max_iterations=1))  # the warm-up
        t1 = time.perf_counter()
        riccati_cuda.launch_count = riccati_ct_cuda.launch_count = 0
        sol = solve(x0s)
        t2 = time.perf_counter()
        sec = t2 - t1
        k1, k6 = riccati_cuda.launch_count, riccati_ct_cuda.launch_count
        slq = settings.algorithm == "slq"
        launches, other = (k6, k1) if slq else (k1, k6)
        dims = (riccati_ct_cuda if slq else riccati_cuda).last_launch_dims
        assert launches == int(sol.iterations.max()) and launches > 0, (lane, launches)
        assert other == 0, f"cartpole {lane} launched the other kernel {other} times"
        want = (batch, n, nx, nu) + ((settings.riccati_substeps,) if slq else ())
        assert dims == want, (lane, dims)
        assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
        # The two routes may part as far as the JAX package's own routes did
        # on a start (its solve, vmapped and alone), no farther.
        spread, lo, hi = record_spread(torch, rec, f"{lane}_")
        slack = hi - lo
        p_sub = solve(x0s[sub], force_plain_riccati=True)
        t3 = time.perf_counter()
        vs_plain = hold_within_spread(torch, take_rows(sol, sub), p_sub, spread,
                                      p_sub.iterations - slack, p_sub.iterations + slack,
                                      f"cartpole {lane} kernel vs plain")
        vs_record = compare_with_record(torch, take_rows(sol, slice(0, CARTPOLE_RECORD_BATCH)),
                                        rec, f"{lane}_", f"cartpole {lane} vs the JAX record")
        its = sol.iterations.tolist()
        at = at_k6 if slq else at_k1
        out[lane] = {
            "algorithm": settings.algorithm, "constraint_mode": mode,
            "max_iterations": settings.max_iterations, "min_rel_cost": settings.min_rel_cost,
            "seconds_per_solve": sec, "solves_per_s": batch / sec,
            "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
            "mean_iterations": float(sol.iterations.float().mean()),
            "converged_share": float(sol.converged.float().mean()),
            "upright_share": upright_share(sol.xs),
            "record_upright_share": float(
                (np.abs(rec[f"{lane}_xs"][:, -1, 0]) < CARTPOLE_UPRIGHT_RAD).mean()),
            "max_abs_input": float(sol.us.abs().max()),
            "kernel": "riccati_ct_backward" if slq else "riccati_backward",
            "launches": launches, "kernel_dims": list(dims),
            "share_of_solve": launches * 1e-3 * at["kernel_ms"] / sec,
            "kernel_vs_plain": vs_plain, "vs_jax_record": vs_record,
            "jax_spread_max": {f: float(v.max()) for f, v in spread.items()},
            "stage_seconds": {"warm_up": t1 - t0, "timed_solve": sec, "plain_route": t3 - t2},
        }
    emit(out)
    return out


def manipulator_setup(torch):
    from ocs2_tpu_torch.models import mobile_manipulator as mm
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.solvers import sqp

    return dict(mm=mm, sqp=sqp, problem=mm.make_problem("soft"),
                grid=uniform_grid(0.0, MANIP_HORIZON, MANIP_N),
                settings=sqp.SqpSettings(max_iterations=MANIP_MAX_ITERATIONS, integrator="rk2"),
                record=load_record(MANIP_RECORD))


def check_manipulator_bounds(torch, mm, xs, target=None):
    """The JAX tests' bounds (tests/test_robot_zoo.py:98-130) on one solve's
    xs [N+1, 9]: joints inside their box, every monitored sphere pair apart
    next to the base body, and the EE within MANIP_EE_TOL of ``target``.
    Returns the EE error and the least sphere distance."""
    qs = xs[:, 3:9]
    lower = torch.as_tensor(mm.JOINT_LOWER, device=xs.device)
    assert bool((qs > lower - MANIP_JOINT_TOL).all() and (qs < -lower + MANIP_JOINT_TOL).all())
    sphere = float(mm.self_collision(0.0, xs, {}).min())
    assert sphere > MANIP_SPHERE_TOL, sphere
    ee_err = float((mm.ee_pose(xs[-1])[0] - torch.as_tensor(
        np.float32(target), device=xs.device)).norm()) if target is not None else None
    assert ee_err is None or ee_err < MANIP_EE_TOL, ee_err
    return ee_err, sphere


def manipulator_sqp_b1(torch, riccati_cuda, at_b1, cfg):
    """The built-in mobile manipulator (``make_problem("soft")`` with
    self-collision, SQP, rk2, N = 40 over 3 s, 40 iterations at most) from
    home to the reach target and to the self-collision target, two cold
    solves at B = 1 after a one-iteration warm-up; the sweep is K1 at
    (1, 40, 9, 8) with strict pivots, one launch an iteration.  Each solve is
    held against the JAX package's record (compare_with_record) and the JAX
    tests' bounds."""
    mm, sqp = cfg["mm"], cfg["sqp"]
    x0 = mm.home_state(DEVICE)
    sqp.solve(cfg["problem"], cfg["grid"], x0,
              mm.make_params(MANIP_TARGETS["reach"], device=DEVICE),
              settings=sqp.SqpSettings(max_iterations=1, integrator="rk2"), device=DEVICE)
    out = {"phase": "manipulator_sqp_b1", "problem": "mobile_manipulator (soft, self-collision)",
           "B": 1, "N": MANIP_N, "nx": mm.NX, "nu": mm.NU, "integrator": "rk2",
           "max_iterations": MANIP_MAX_ITERATIONS, "solves": {}}
    launches_all, seconds = 0, []
    for name, target in MANIP_TARGETS.items():
        riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
        t0 = time.perf_counter()
        sol = sqp.solve(cfg["problem"], cfg["grid"], x0, mm.make_params(target, device=DEVICE),
                        settings=cfg["settings"], device=DEVICE)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = riccati_cuda.launch_count
        assert launches == int(sol.iterations.max()) > 0, launches
        assert riccati_cuda.last_launch_dims == (1, MANIP_N, mm.NX, mm.NU)
        vs_record = compare_with_record(torch, sol, cfg["record"], f"builtin_{name}_",
                                        f"manipulator {name} vs the JAX record", rows=None)
        ee_err, sphere = check_manipulator_bounds(
            torch, mm, sol.xs[0], target if name == "reach" else None)
        launches_all += launches
        seconds.append(sec)
        out["solves"][name] = {
            "target": list(target), "seconds": sec, "iterations": int(sol.iterations[0]),
            "record_iterations": int(cfg["record"][f"builtin_{name}_iterations"]),
            "converged": bool(sol.converged[0]), "launches": launches,
            "ee_error": ee_err, "min_sphere_distance": sphere, "vs_jax_record": vs_record,
        }
    out.update({"riccati_launches": launches_all, "seconds_per_solve": statistics.median(seconds),
                "kernel_dims": [1, MANIP_N, mm.NX, mm.NU],
                "share_of_solve": launches_all * 1e-3 * at_b1["kernel_ms"] / sum(seconds)})
    emit(out)
    return out


def manipulator_sqp_b256(torch, riccati_cuda, at_b256, cfg):
    """The same problem for MANIP_BATCH scenarios, each with its own EE target
    from manipulator_targets (``params["scenario"]``), 30 iterations at most:
    a one-iteration warm-up on the first MANIP_PLAIN_BATCH targets, one timed
    solve of the batch (K1 at (256, 40, 9, 8), clamped, one launch an
    iteration), the plain route on the first MANIP_PLAIN_BATCH.  Those rows
    of the kernel route are held against the plain route within SOLVE_ATOL +
    SOLVE_RTOL |value|, or within the JAX package's own spread on a target
    (its vmapped solve against the target solved alone and vmapped alone, the
    record's "b256" entries) where that is wider (hold_within_spread), and
    against the JAX package's vmapped solve: a target whose JAX spread is
    within SOLVE_ATOL is held to the tolerance; a target the JAX package
    itself decides by float32 rounding is reported, not held (three samples
    of the JAX package's routes there bound no fourth route: on the card
    target 3 lands 1.03e-2 from the record, past the JAX package's 8.8e-3,
    and the port's own sweep in float64 moves it by 1.1e-2 on the CPU)."""
    mm, sqp = cfg["mm"], cfg["sqp"]
    targets = manipulator_targets(MANIP_BATCH)
    rec = cfg["record"]
    assert np.array_equal(rec["b256_targets"], targets[:MANIP_PLAIN_BATCH])
    x0s = mm.home_state(DEVICE)[None].expand(MANIP_BATCH, mm.NX).contiguous()

    b256_settings = dataclasses.replace(cfg["settings"], max_iterations=MANIP_B256_MAX_ITERATIONS)

    def solve(rows, settings=b256_settings, **kw):
        sol = sqp.solve(cfg["problem"], cfg["grid"], x0s[rows],
                        mm.make_params(targets[rows], device=DEVICE),
                        settings=settings, device=DEVICE, **kw)
        torch.cuda.synchronize()
        return sol

    sub = slice(0, MANIP_PLAIN_BATCH)
    t0 = time.perf_counter()
    solve(sub, settings=dataclasses.replace(b256_settings, max_iterations=1))  # the warm-up
    t1 = time.perf_counter()
    riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
    sol = solve(slice(None))
    t2 = time.perf_counter()
    sec = t2 - t1
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    assert launches == int(sol.iterations.max()) > 0, launches
    assert dims == (MANIP_BATCH, MANIP_N, mm.NX, mm.NU), dims
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    p_sub = solve(sub, force_plain_riccati=True)
    t3 = time.perf_counter()
    # Two routes of the port may part as far as the JAX package's own routes
    # did on the target, no farther.
    spread, lo, hi = record_spread(torch, rec, "b256_")
    slack = hi - lo
    vs_plain = hold_within_spread(torch, take_rows(sol, sub), p_sub, spread,
                                  p_sub.iterations - slack, p_sub.iterations + slack,
                                  "manipulator b256 kernel vs plain")
    agree = np.nonzero((rec["b256_spread_xs"] <= SOLVE_ATOL)
                       & (rec["b256_spread_us"] <= SOLVE_ATOL))[0]
    vs_record = compare_with_record(torch, take_rows(sol, agree), rec, "b256_",
                                    "manipulator b256 vs the JAX record", rows=agree)
    vs_record["decided_by_rounding"] = {
        str(i): {"xs": float((sol.xs[i].cpu() - torch.as_tensor(rec["b256_xs"][i])).abs().max()),
                 "us": float((sol.us[i].cpu() - torch.as_tensor(rec["b256_us"][i])).abs().max()),
                 "jax_spread_xs": float(rec["b256_spread_xs"][i]),
                 "jax_spread_us": float(rec["b256_spread_us"][i]),
                 "iterations": int(sol.iterations[i]),
                 "jax_iterations": int(rec["b256_iterations"][i])}
        for i in np.setdiff1d(np.arange(MANIP_PLAIN_BATCH), agree).tolist()}
    its = sol.iterations.tolist()
    ee_err = (mm.ee_pose(sol.xs[:, -1])[0] - torch.as_tensor(targets, device=DEVICE)).norm(dim=-1)
    out = {
        "phase": "manipulator_sqp_b256", "problem": "mobile_manipulator (soft, self-collision)",
        "B": MANIP_BATCH, "N": MANIP_N, "nx": mm.NX, "nu": mm.NU, "integrator": "rk2",
        "max_iterations": MANIP_B256_MAX_ITERATIONS, "targets_seed": MANIP_SEED,
        "seconds_per_solve": sec, "solves_per_s": MANIP_BATCH / sec,
        "iterations_histogram": {str(k): its.count(k) for k in sorted(set(its))},
        "converged_share": float(sol.converged.float().mean()),
        "ee_error_median": float(ee_err.median()), "ee_error_max": float(ee_err.max()),
        "riccati_launches": launches, "kernel_dims": list(dims),
        "share_of_solve": launches * 1e-3 * at_b256["kernel_ms"] / sec,
        "kernel_vs_plain": vs_plain, "vs_jax_record": vs_record,
        "jax_spread_max": {f: float(v.max()) for f, v in spread.items()},
        "stage_seconds": {"warm_up": t1 - t0, "timed_solve": sec, "plain_route": t3 - t2},
    }
    emit(out)
    return out


def urdf_variants_b1(torch, riccati_cuda, at_shapes):
    """The franka on the reference's four base types and the UR5 on the
    default and the fully actuated floating base (URDF_VARIANTS): SQP, rk4,
    N = 40 over 2 s, 25 iterations at most, the EE target URDF_TARGET_OFFSET
    from the home EE position, a cold solve each at B = 1 (the sweep: K1 at
    (1, 40, nx, nu) with strict pivots, one launch an iteration).  Each solve
    is held against the JAX package's record (compare_with_record) and the
    JAX test's bound (the EE within URDF_EE_TOL of the target); the floating
    arm's unactuated base must not move."""
    from ocs2_tpu_torch.models import mobile_manipulator as mm
    from ocs2_tpu_torch.models.urdf import asset_path, chain_from_urdf
    from ocs2_tpu_torch.oc.time_discretization import uniform_grid
    from ocs2_tpu_torch.solvers import sqp

    rec = load_record(MANIP_RECORD)
    grid = uniform_grid(0.0, URDF_HORIZON, URDF_N)
    settings = sqp.SqpSettings(max_iterations=URDF_MAX_ITERATIONS, integrator="rk4")
    out = {"phase": "urdf_variants_b1", "B": 1, "N": URDF_N, "integrator": "rk4",
           "max_iterations": URDF_MAX_ITERATIONS, "variants": {}}
    launches_all, seconds_all = 0, 0.0
    for arm, base_type in URDF_VARIANTS:
        key = urdf_variant_key(arm, base_type)
        c = URDF_ARMS[arm]
        loaded = chain_from_urdf(asset_path(c["urdf"]), c["base"], c["ee"],
                                 remove_joints=c["remove"])
        nb, _, nx, nu = mm._base_dims(base_type, loaded.chain.num_dof)
        x0 = mm.variant_home_state(loaded, base_type, q_home=c["q_home"], device=DEVICE)
        target = (loaded.chain.forward(x0[nb:])[0].cpu().numpy()
                  + np.float32(URDF_TARGET_OFFSET))
        assert np.abs(target - rec[f"{key}_target"]).max() <= 1e-5, key
        problem = mm.make_urdf_manipulator_problem(loaded, base_type=base_type)
        riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
        t0 = time.perf_counter()
        sol = sqp.solve(problem, grid, x0, mm.make_params(target, device=DEVICE),
                        settings=settings, device=DEVICE)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = riccati_cuda.launch_count
        assert launches == int(sol.iterations.max()) > 0, (key, launches)
        assert riccati_cuda.last_launch_dims == (1, URDF_N, nx, nu), key
        vs_record = compare_with_record(torch, sol, rec, f"{key}_", f"{key} vs the JAX record",
                                        rows=None)
        ee = mm.variant_ee_pose(loaded.chain, base_type, sol.xs[0, -1])[0]
        ee_err = float((ee - torch.as_tensor(target, device=DEVICE)).norm())
        assert ee_err < URDF_EE_TOL, (key, ee_err)
        if base_type == "floating_arm":
            assert float((sol.xs[0, :, :6] - x0[:6]).abs().max()) <= 1e-5, "the base moved"
        at = at_shapes[(nx, nu)]
        launches_all += launches
        seconds_all += sec
        out["variants"][key] = {
            "nx": nx, "nu": nu, "seconds": sec, "iterations": int(sol.iterations[0]),
            "record_iterations": int(rec[f"{key}_iterations"]), "launches": launches,
            "ee_error": ee_err, "share_of_solve": launches * 1e-3 * at["kernel_ms"] / sec,
            "vs_jax_record": vs_record,
        }
    out.update({"riccati_launches": launches_all, "seconds": seconds_all})
    emit(out)
    return out


# -- loopshaping: the frequency-shaped legged MPC at nx = 48 ----------------------

# The loopshaped trot (tests/test_legged_loopshaping.py:29-40): the flagship
# problem behind one low-pass filter state per input (nx = 24 + 24), the
# 12-row foot constraint projected, so K1 runs at (48, 12); trot 0.7 s, N = 40
# over 1 s, SQP with rk2 and 2 substeps, 12 iterations at most
# (loopshaping_mpc.make_solver_settings).  The unshaped comparison solve
# (:142-149) runs the same task on interface.make_problem() at (24, 12).
# One timed solve, not two: a depth cut for the card's time (PERF.md §4).
LS_N, LS_HORIZON, LS_TIMED_SOLVES = 40, 1.0, 1
# K1's shape on the trot; the unshaped solve's is CK_TROT_SHAPE, (24, 12, 1, 40).
LS_SHAPE = (48, 12, 1, LS_N)
# The dummy MRT loop (:158-199): Mpc at N = 28 over 0.7 s, 6 iterations at
# most, 12.5 Hz MPC and 50 Hz control (rk4, 2 substeps: |lambda| h = 1 at
# the 100 rad/s pole), from the augmented default state; 0.48 s (6 ticks) of
# the test's 1.2 s (15): a depth cut for the card's time (PERF.md §4: 10 ticks
# until the MPC-Net phases; the record holds the 15, and the float64-eigh
# window the loop is held over ends at its 17th control step, inside the 24).
LS_LOOP_N, LS_LOOP_HORIZON, LS_LOOP_MAX_ITERATIONS = 28, 0.7, 6
LS_LOOP_DURATION, LS_MRT_HZ, LS_MPC_HZ = 0.48, 50.0, 12.5
LS_LOOP_SHAPE = (48, 12, 1, LS_LOOP_N)
# The batch shape K1 is also checked at (clamped pivots; no lane runs it).
LS_BATCH_SHAPE = (48, 12, 256, LS_N)
# The JAX tests' own bounds: dynamics violation, base height (solve and loop),
# swing-leg forces, roll / pitch / yaw of the loop; and the shaping
# functional of the shaped inputs against the unshaped ones.
LS_DYN_SSE, LS_HEIGHT_TOL, LS_SWING_FORCE = 1e-3, 0.12, 2.0
LS_LOOP_HEIGHT_TOL, LS_LOOP_ATTITUDE_TOL, LS_SHAPING_RATIO = 0.15, 0.35, 0.9
LS_RECORD = os.path.join(_DATA, "loopshaping_reference.npz")


def shaping_functional(us, p_diag, g_diag, dt, u0):
    """sum_k |y_k|^2 with y = g (u - lowpass(u)), the low-pass integrated by
    the solver's RK2 with 2 substeps (tests/test_legged_loopshaping.py's
    ``_y_sse``, in numpy float32 with the sums in float64).  us [N, 24]; the
    filter's poles p and gains g; u0 the low-pass state's start."""
    xi = np.array(u0, np.float32)
    acc = 0.0
    for k in range(us.shape[0]):
        u = np.asarray(us[k], np.float32)
        y = g_diag * (u - xi)
        acc += float(np.sum(y * y))
        for _ in range(2):
            h = dt / 2
            k1 = p_diag * (u - xi)
            k2 = p_diag * (u - (xi + h * k1))
            xi = xi + h * 0.5 * (k1 + k2)
    return acc


def loopshaping_setup(torch):
    """The loopshaped trot's problem, grid, params, augmented start, warm
    start and settings (the JAX test's ``trot_setup``), held against the
    record's copies; the keys of legged_setup, so profile_legged takes it."""
    from ocs2_tpu_torch.models.legged_robot import interface, model
    from ocs2_tpu_torch.models.legged_robot import loopshaping_mpc as lm

    problem, defn = lm.make_loopshaping_problem(device=DEVICE)
    grid = trot_grid(LS_HORIZON, LS_N)
    x0 = model.default_state(DEVICE)
    u0 = model.weight_compensating_input(np.ones(4, np.float32), DEVICE)
    xs_init, us_init = lm.loopshaped_warm_start(defn, grid, x0)
    cfg = {"lm": lm, "defn": defn, "problem": problem, "grid": grid,
           "params": interface.make_params(grid, device=DEVICE), "u0": u0,
           "x0": lm.augment_state(defn, x0, u0), "xs_init": xs_init, "us_init": us_init,
           "settings": lm.make_solver_settings(), "record": load_record(LS_RECORD)}
    rec = cfg["record"]
    assert np.array_equal(np.asarray(grid.times), rec["grid_times"]), "the record's grid differs"
    for key in ("x0", "xs_init", "us_init"):
        want = rec["xa0" if key == "x0" else key]
        assert np.abs(cfg[key].cpu().numpy() - want).max() <= 1e-5, f"the record's {key} differs"
    return cfg


def shaped_functional(cfg, us):
    """shaping_functional of plant inputs us [N, 24] (a tensor) under cfg's
    filter, from the low-pass state u0, at the grid's first step."""
    defn, grid = cfg["defn"], cfg["grid"]
    return shaping_functional(us.cpu().numpy(), -np.diag(defn.A.cpu().numpy()),
                              np.diag(defn.D.cpu().numpy()),
                              float(grid.times[1] - grid.times[0]), cfg["u0"].cpu().numpy())


def check_loopshaped_trot(torch, cfg, sol):
    """The JAX test's assertions (tests/test_legged_loopshaping.py:72-110):
    finite, dynamics violation SSE under LS_DYN_SSE, the base within
    LS_HEIGHT_TOL of its stand height, swing legs' forces under
    LS_SWING_FORCE N, the filtered output finite.  Returns the three
    measures."""
    from ocs2_tpu_torch.models.legged_robot import model
    from ocs2_tpu_torch.models.legged_robot.gait import contact_flags_static

    lm, defn = cfg["lm"], cfg["defn"]
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    dyn = float(sol.performance.dynamics_violation_sse[0])
    assert dyn < LS_DYN_SSE, dyn
    xs_p, us_p = lm.plant_trajectory(defn, sol.xs[0], sol.us[0])
    height = float((xs_p[:, 8] - model.STAND_HEIGHT).abs().max())
    assert height < LS_HEIGHT_TOL, height
    modes = np.asarray(cfg["grid"].modes)[:LS_N]
    swing = torch.as_tensor(np.stack([contact_flags_static(int(m)) < 0.5 for m in modes]),
                            device=DEVICE)
    forces = us_p[:, :12].reshape(LS_N, 4, 3).abs().amax(-1)
    swing_force = float(torch.where(swing, forces, torch.zeros_like(forces)).max())
    assert swing_force < LS_SWING_FORCE, swing_force
    assert bool(torch.isfinite(lm.filtered_output(defn, sol.xs[0], sol.us[0])).all())
    return {"dynamics_violation_sse": dyn, "base_height_max_abs_dev": height,
            "max_swing_force": swing_force}


def loopshaping_trot_b1(torch, riccati_cuda, at_ls, at_plain, cfg, out=None):
    """The loopshaped trot (tests/test_legged_loopshaping.py:29-110): SQP on
    the augmented problem (nx = 48) from the augmented stance, warm-started
    by ``loopshaped_warm_start``, rk2 with 2 substeps, 12 iterations; the
    sweep is K1 at (1, 40, 48, 12) with strict pivots, one launch an
    iteration.  A one-iteration warm-up, then LS_TIMED_SOLVES timed cold
    solves (the median reported).  The first iteration is held through the
    kernel against the single-scenario sweep (compare_solves); three
    iterations with the eigh in float64 against the JAX package's solve with
    its eigh in float64, to the tolerance (hold_eigh64_trot); the 12-iteration
    solve against the JAX package's record by hold_float32_decided (its xs
    and us are decided by float32 rounding: iterations and merit held) and
    by the JAX test's bounds.  Then the unshaped solve of the
    same task (:142-149; K1 at (1, 40, 24, 12)), held against the record by
    compare_with_record, and the shaping functional of the shaped inputs must
    be under LS_SHAPING_RATIO of the unshaped one's."""
    from ocs2_tpu_torch.models.legged_robot import interface
    from ocs2_tpu_torch.solvers import sqp

    lm, rec = cfg["lm"], cfg["record"]

    def solve(settings, **kw):
        return sqp.solve(cfg["problem"], cfg["grid"], cfg["x0"], cfg["params"],
                         xs_init=cfg["xs_init"], us_init=cfg["us_init"], settings=settings,
                         device=DEVICE, **kw)

    # The warm-up: one iteration, through the kernel and through the
    # single-scenario sweep of torch ops.  After one iteration the two routes
    # differ only by the sweep's rounding (every other operation is the same
    # on the same data), and they must agree; after a few more a float32
    # eigh's rounding decides the solve (PERF.md §6; hold_float32_decided).
    one = lm.make_solver_settings(max_iterations=1)
    t0 = time.perf_counter()
    first = solve(one)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    first_single = solve(one, force_single_riccati=True)
    torch.cuda.synchronize()
    first_vs_single = compare_solves(torch, first, first_single,
                                     "loopshaped trot, first iteration: kernel vs single sweep")
    # Three iterations with the Hessian correction's eigh in float64, against
    # the JAX package's solve with its eigh in float64: there the rounding of
    # the zero block no longer decides the step, and the solve is held to the
    # tolerance (hold_eigh64_trot).
    with eigh_in_float64(torch):
        three = solve(lm.make_solver_settings(max_iterations=3))
    three_vs_eigh64 = hold_eigh64_trot(torch, three, rec)
    riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
    seconds, sols = [], []
    for _ in range(LS_TIMED_SOLVES):
        t0 = time.perf_counter()
        sols.append(solve(cfg["settings"]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    sol = sols[0]
    assert all(bool(torch.equal(s.iterations, sol.iterations)) for s in sols), "solves differ"
    assert launches == sum(int(s.iterations[0]) for s in sols) > 0, launches
    assert dims == (1, LS_N, 48, 12), dims
    bounds = check_loopshaped_trot(torch, cfg, sol)
    xs_np, us_np = sol.xs[0].cpu().numpy(), sol.us[0].cpu().numpy()
    vs_record = hold_float32_decided(int(sol.iterations[0]), float(sol.performance.merit[0]),
                                     xs_np, us_np, rec, "trot_", "loopshaped trot vs the JAX record")
    sec = statistics.median(seconds)
    shaped = shaped_functional(cfg, sol.us[0])

    plain_problem = interface.make_problem(device=DEVICE)
    plain_settings = sqp.SqpSettings(max_iterations=12, integrator="rk2")
    riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
    t0 = time.perf_counter()
    plain = sqp.solve(plain_problem, cfg["grid"], cfg["x0"][:24], cfg["params"],
                      us_init=cfg["u0"][None].expand(LS_N, 24), settings=plain_settings,
                      device=DEVICE)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches, plain_dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    assert plain_launches == int(plain.iterations[0]) > 0, plain_launches
    assert plain_dims == (1, LS_N, 24, 12), plain_dims
    plain_vs_record = compare_with_record(torch, plain, rec, "unshaped_",
                                          "unshaped trot vs the JAX record", rows=None)
    unshaped = shaped_functional(cfg, plain.us[0])
    assert shaped < LS_SHAPING_RATIO * unshaped, (shaped, unshaped)

    launches_per_solve = launches / LS_TIMED_SOLVES
    rec_out = {
        "phase": "loopshaping_trot_b1", "B": 1, "N": LS_N, "nx": 48, "nu": 24,
        "projected_nu": 12, "integrator": "rk2", "substeps": cfg["settings"].substeps,
        "max_iterations": cfg["settings"].max_iterations, "solves_timed": LS_TIMED_SOLVES,
        "seconds_per_solve": sec, "seconds_per_solve_all": seconds,
        "seconds_per_iteration": sec / int(sol.iterations[0]), "warm_up_seconds": warm_s,
        "iterations": int(sol.iterations[0]), "record_iterations": int(rec["trot_iterations"]),
        "converged": bool(sol.converged[0]), "merit": float(sol.performance.merit[0]),
        "record_merit": float(rec["trot_merit"]), **bounds,
        "riccati_launches": launches, "kernel_dims": list(dims),
        "launches_per_solve": launches_per_solve,
        "share_of_solve": launches_per_solve * 1e-3 * at_ls["kernel_ms"] / sec,
        "first_iteration_kernel_vs_single_sweep": first_vs_single, "vs_jax_record": vs_record,
        "three_iterations_float64_eigh_vs_jax": three_vs_eigh64,
        "shaping_functional": shaped, "unshaped_shaping_functional": unshaped,
        "shaping_ratio": shaped / unshaped,
        "record_shaping_functional": float(rec["trot_shaping_functional"]),
        "record_unshaped_shaping_functional": float(rec["unshaped_shaping_functional"]),
        "unshaped": {
            "seconds": plain_s, "iterations": int(plain.iterations[0]),
            "record_iterations": int(rec["unshaped_iterations"]),
            "riccati_launches": plain_launches, "kernel_dims": list(plain_dims),
            "share_of_solve": plain_launches * 1e-3 * at_plain["kernel_ms"] / plain_s,
            "vs_jax_record": plain_vs_record,
        },
    }
    emit(rec_out)
    if out is not None:
        out["trot"] = {"iterations": int(sol.iterations[0]), "xs": sol.xs[0].tolist(),
                       "us": sol.us[0].tolist(), "shaping_functional": shaped}
        out["unshaped"] = {"iterations": int(plain.iterations[0]), "xs": plain.xs[0].tolist(),
                           "us": plain.us[0].tolist(), "shaping_functional": unshaped}
    return rec_out


# The record's routes besides its own (tools/loopshaping_reference.py), and
# those of them whose Hessian correction's eigendecomposition ran in float64.
LS_ROUTES = ("vmapped_one", "ulp_up", "ulp_down", "eigh64", "eigh64_vmapped_one", "eigh64_ulp_up")
LS_LOOP_ROUTES = ("", "vmapped_", "ulp_up_", "eigh64_", "eigh64_vmapped_", "eigh64_ulp_up_")


class eigh_in_float64:
    """Within the block, ``torch.linalg.eigh`` (the eigendecomposition of
    SQP's Hessian correction, ``ops/riccati.convexify_stage_hessians``) runs
    in float64 and is rounded back to the input's type: the same function,
    another rounding, as ``tools/loopshaping_reference.Eigh64`` gives the JAX
    package."""

    def __init__(self, torch):
        self.linalg = torch.linalg

    def __enter__(self):
        self.saved = saved = self.linalg.eigh

        def eigh64(z, *args, **kwargs):
            w, v = saved(z.double(), *args, **kwargs)
            return w.to(z.dtype), v.to(z.dtype)

        self.linalg.eigh = eigh64
        return self

    def __exit__(self, *exc):
        self.linalg.eigh = self.saved


def hold_eigh64_trot(torch, sol, rec):
    """The loopshaped trot at 3 iterations with the eigh in float64
    (eigh_in_float64) against the JAX package's, whose float64-eigh routes
    (the solve, vmapped, from a start one ulp up) agree within SOLVE_ATOL:
    iterations equal, xs and us within SOLVE_ATOL + SOLVE_RTOL |value|."""
    spread = [float(rec[f"trot3_eigh64_family_spread_{f}"]) for f in ("xs", "us")]
    assert max(spread) <= SOLVE_ATOL, ("the record's float64-eigh routes part", spread)
    assert int(sol.iterations[0]) == int(rec["trot3_eigh64_iterations"]), (
        "trot, 3 iterations, float64 eigh", int(sol.iterations[0]))
    out = {}
    for f in ("xs", "us"):
        mine, ref = getattr(sol, f)[0].cpu().numpy(), rec[f"trot3_eigh64_{f}"]
        d = np.abs(mine - ref)
        assert (d <= SOLVE_ATOL + SOLVE_RTOL * np.abs(ref)).all(), (
            "trot, 3 iterations, float64 eigh, vs the JAX package's", f, float(d.max()))
        out[f"max_abs_{f}"] = float(d.max())
    return out


def merit_ceiling(merits):
    """The highest merit of the JAX package's routes plus their span."""
    return max(merits) + (max(merits) - min(merits))


def hold_float32_decided(iterations, merit, xs, us, rec, prefix, what):
    """A loopshaped solve against the JAX record, where float32 rounding
    decides the solution: the stage Hessians have an exactly zero block (no
    cost on the filter state at the last node), whose eigenvalues come out of
    a float32 eigh as rounding noise and are clamped or kept by their sign,
    so the first SQP step moves by 1.4 in xs with the eigh's rounding and the
    JAX package's own routes (its solve vmapped, from a start one ulp apart,
    with a float64 eigh) land up to 1.8 apart after 12 iterations
    (PERF.md §6).  Held: the iterations within the routes' range, and the
    merit no higher than the highest of the routes' by more than the routes'
    own span (a lower merit is a better solve).  The distance in xs and us
    from the record is returned beside the routes' largest pairwise distance
    (PERF.md §6 states how far past it the card's solve lands); it is not
    held: the routes are samples of float32 rounding and bound no other
    route."""
    names = ("",) + tuple(f"{r}_" for r in LS_ROUTES)
    its = [int(rec[f"{prefix}{n}iterations"]) for n in names]
    merits = [float(rec[f"{prefix}{n}merit"]) for n in names]
    assert min(its) <= iterations <= max(its), (what, "iterations", iterations, its)
    assert merit <= merit_ceiling(merits), (what, "merit", merit, merits)
    dx, du = float(np.abs(xs - rec[f"{prefix}xs"]).max()), float(np.abs(us - rec[f"{prefix}us"]).max())
    spread = {f: float(rec[f"{prefix}spread_{f}"]) for f in ("xs", "us")}
    return {"iterations": iterations, "jax_iterations": its, "merit": merit,
            "jax_merits": merits, "max_abs_xs": dx, "max_abs_us": du,
            "jax_pairwise_spread": spread}


def hold_loop_eigh64_window(ticks, states, rec):
    """The loop against the JAX package's loop with a float64 eigh, over the
    leading control steps where that loop's vmapped and one-ulp twins agree
    within SOLVE_ATOL (there the JAX package's loop is decided by its
    arithmetic): the states within SOLVE_ATOL + SOLVE_RTOL |value|, and the
    iterations of every tick that ends inside the window within the twins'
    range."""
    n_steps = states.shape[0]
    ratio = int(round(LS_MRT_HZ / LS_MPC_HZ))
    spread = rec["loop_eigh64_family_spread_states"][:n_steps]
    window = int(np.argmax(spread > SOLVE_ATOL)) if (spread > SOLVE_ATOL).any() else n_steps
    ref = rec["loop_eigh64_states"][:n_steps]
    d = np.abs(states - ref)
    assert (d[:window] <= SOLVE_ATOL + SOLVE_RTOL * np.abs(ref[:window])).all(), (
        "loop vs the JAX float64-eigh loop", window, float(d[:window].max()))
    family = ("eigh64_", "eigh64_vmapped_", "eigh64_ulp_up_")
    held_ticks = min(len(ticks), max(0, (window - 1) // ratio))
    for i in range(held_ticks):
        its = [int(rec[f"loop_{r}iterations"][i]) for r in family]
        assert min(its) <= ticks[i]["iterations"] <= max(its), ("loop tick", i, its)
    return {"eigh64_window_steps": window, "eigh64_window_ticks": held_ticks,
            "eigh64_window_max_abs_state_difference": float(d[:window].max()) if window else 0.0}


def hold_loop_first_tick(ticks, rec):
    """The loop's first tick ({"iterations", "merit"}) against the JAX
    package's loop: it solves the same problem from the same start as the
    record's, and is held as hold_float32_decided holds a solve (iterations
    within the routes' range, merit under merit_ceiling).  Later ticks start
    from states that float32 rounding has already moved
    (hold_loop_eigh64_window holds the leading control steps where the JAX
    package's loop is decided by its arithmetic)."""
    its0 = [int(rec[f"loop_{r}iterations"][0]) for r in LS_LOOP_ROUTES]
    merits0 = [float(rec[f"loop_{r}merit"][0]) for r in LS_LOOP_ROUTES]
    first = ticks[0]
    assert min(its0) <= first["iterations"] <= max(its0), ("loop tick 0", first, its0)
    assert first["merit"] <= merit_ceiling(merits0), ("loop tick 0 merit", first, merits0)
    return {"first_tick": {"iterations": first["iterations"], "jax_iterations": its0,
                           "merit": first["merit"], "jax_merits": merits0}}


def loopshaping_closed_loop(torch, riccati_cuda, at_loop, cfg, out=None):
    """The loopshaped dummy MRT loop (tests/test_legged_loopshaping.py:
    158-199): ``Mpc`` on the loopshaped problem with the gait's reference
    manager, N = 28 over 0.7 s, 6 iterations at most, 12.5 Hz MPC, 50 Hz
    control for LS_LOOP_DURATION from the augmented stance (6 ticks, 24
    control steps of rk4 with 2 substeps); each tick's sweep is K1 at
    (1, 28, 48, 12) with strict pivots, one launch an iteration.  Held
    against the JAX package's loop (the record) by hold_loop_first_tick (the
    later ticks are decided by float32 rounding), against the JAX package's
    loop with a float64 eigh over the leading control steps where that loop
    is decided by its arithmetic (hold_loop_eigh64_window), and by the JAX
    test's bounds (height, attitude)."""
    from ocs2_tpu_torch.models.legged_robot import interface, model
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.mpc.mpc import Mpc, MpcSettings
    from ocs2_tpu_torch.mpc.mrt import MpcMrtInterface, dummy_loop

    lm, rec = cfg["lm"], cfg["record"]
    grid0 = trot_grid(LS_LOOP_HORIZON, LS_LOOP_N)
    mpc = Mpc(cfg["problem"], interface.make_params(grid0, device=DEVICE),
              MpcSettings(time_horizon=LS_LOOP_HORIZON, num_intervals=LS_LOOP_N, solver="sqp"),
              solver_settings=lm.make_solver_settings(max_iterations=LS_LOOP_MAX_ITERATIONS),
              reference_manager=interface.SwitchedModelReferenceManager(
                  GaitSchedule(trot_gait(0.7)), device=DEVICE),
              device=DEVICE)
    ticks, step_s, last = [], [], {"count": 0, "t": None}

    def observe(t, x, u):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if mpc.solve_timer.count != last["count"]:
            last["count"] = mpc.solve_timer.count
            ticks.append({"solve_s": mpc.solve_timer.last, "tick_s": mpc.tick_timer.last,
                          "iterations": int(mpc.last_solution.iterations[0]),
                          "merit": float(mpc.last_solution.performance.merit[0])})
        elif last["t"] is not None:
            step_s.append(now - last["t"])
        last["t"] = now

    torch.cuda.synchronize()
    riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
    t0 = time.perf_counter()
    _, states, inputs = dummy_loop(MpcMrtInterface(mpc), cfg["x0"], duration=LS_LOOP_DURATION,
                                   mrt_frequency=LS_MRT_HZ, mpc_frequency=LS_MPC_HZ,
                                   observers=[observe])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    n_ticks = int(round(LS_LOOP_DURATION * LS_MPC_HZ))
    n_steps = int(round(LS_LOOP_DURATION * LS_MRT_HZ))
    assert len(ticks) == n_ticks and states.shape == (n_steps + 1, 48), (len(ticks), states.shape)
    assert bool(torch.isfinite(states).all()) and bool(torch.isfinite(inputs).all())
    height = float((states[:, 8] - model.STAND_HEIGHT).abs().max())
    attitude = float(states[:, 9:12].abs().max())
    assert height < LS_LOOP_HEIGHT_TOL and attitude < LS_LOOP_ATTITUDE_TOL, (height, attitude)
    its = [k["iterations"] for k in ticks]
    assert launches == sum(its) > 0, (launches, its)
    assert dims == (1, LS_LOOP_N, 48, 12), dims

    vs_record = hold_loop_first_tick(ticks, rec)
    vs_eigh64 = hold_loop_eigh64_window(ticks, states.cpu().numpy(), rec)
    solve_ms = [1e3 * k["solve_s"] for k in ticks]
    host_ms = [1e3 * (k["tick_s"] - k["solve_s"]) for k in ticks]
    rec_out = {
        "phase": "loopshaping_closed_loop", "B": 1, "N": LS_LOOP_N, "nx": 48, "nu": 24,
        "max_iterations": LS_LOOP_MAX_ITERATIONS, "duration_s": LS_LOOP_DURATION,
        "mrt_frequency": LS_MRT_HZ, "mpc_frequency": LS_MPC_HZ, "ticks": len(ticks),
        "control_steps": n_steps, "loop_seconds": loop_s,
        "mpc_tick_ms_median": statistics.median(solve_ms), "mpc_tick_ms_worst": max(solve_ms),
        "mpc_tick_ms_first": solve_ms[0],
        "mpc_tick_host_ms_median": statistics.median(host_ms),
        "mrt_step_ms_median": 1e3 * statistics.median(step_s),
        "mrt_step_ms_worst": 1e3 * max(step_s),
        "iterations_per_tick": its, "vs_jax_record": vs_record,
        "vs_jax_eigh64_loop": vs_eigh64,
        "base_height_max_abs_dev": height, "attitude_max_abs": attitude,
        "riccati_launches": launches, "kernel_dims": list(dims),
        "launches_per_tick": launches / len(ticks),
        "share_of_tick": launches / len(ticks) * at_loop["kernel_ms"]
        / statistics.median(solve_ms),
    }
    emit(rec_out)
    if out is not None:
        out["loop"] = {"iterations_per_tick": its, "merit_per_tick": [k["merit"] for k in ticks],
                       "states": states.tolist()}
    return rec_out


# -- MPC-Net -------------------------------------------------------------------------

MPCNET_FIELDS = ("t", "x", "u_star", "h0", "hu", "Huu")
# Round 0's Adam steps replay the record's draws on the port's own samples,
# which sit within SOLVE_ATOL + SOLVE_RTOL |value| of the record's (or within
# the JAX package's spread).  The Hamiltonian loss and Adam's update are
# smooth in the samples, so the loss curve and the weights follow them:
# losses within MPCNET_LOSS_ATOL + MPCNET_LOSS_RTOL |loss|, weights within
# MPCNET_WEIGHT_ATOL (PERF.md §6: what the CPU and the card give).
MPCNET_LOSS_RTOL, MPCNET_LOSS_ATOL, MPCNET_WEIGHT_ATOL = 1e-3, 1e-3, 1e-3
MPCNET_DIVERGENCE = 1.5  # tests/test_learning.py:365-366: a round's last loss <= 1.5 x its first
MPCNET_FORCE_COLS = {"legged": 12, "b256": 12, "small": 12}  # u*'s contact forces


def mpcnet_record_weights(rec, prefix):
    """The export-format weights ({"params/<layer>/kernel": ...}) the record
    holds under ``prefix`` (e.g. "legged/init")."""
    head = prefix + "/"
    return {k[len(head):]: v for k, v in rec.items() if k.startswith(head + "params/")}


def mpcnet_record_sampler(torch, rec, lane, device=None):
    """An x0 sampler that returns the record's draws in the order the
    training loop asks for them: the example start, then each round's
    starts (on ``device``, DEVICE by default)."""
    calls, device = [], device or DEVICE

    def sampler(generator, n):
        key = f"{lane}/example_x" if not calls else f"{lane}/r{len(calls) - 1}/x0s"
        x = np.array(rec[key], np.float32).reshape(-1, rec[key].shape[-1])
        assert len(x) == n, (key, len(x), n)
        calls.append(key)
        return torch.as_tensor(x, device=device)

    return sampler


def hold_mpcnet_samples(samples, rec, prefix, steps, what, scenarios=None, force_cols=0):
    """MPC-Net samples ([S * steps, ...], scenario-major) against the
    record's (``prefix/samples/*``), scenario by scenario and field by
    field: within SOLVE_ATOL + SOLVE_RTOL |value|, or, where the JAX
    package's own routes to the scenario part by more than SOLVE_ATOL
    (``prefix/spread/*``), within that spread, never past it.  The first
    ``force_cols`` columns of u* are the legged robot's contact forces,
    whose split between the stance legs is held by a 1e-3 weight only (the
    matched quirk of ROADMAP.md §3): they are held within FORCE_ATOL +
    SOLVE_RTOL |value|, as compare_with_ties holds the re-solved ticks'
    forces, and the scenarios where they lie past the JAX spread are
    reported.  Returns the largest difference of each field
    and the scenarios held to the spread."""
    err, held, forces_past = {}, set(), []
    for f in MPCNET_FIELDS:
        a = getattr(samples, f).detach().cpu().double().numpy()
        b = np.asarray(rec[f"{prefix}/samples/{f}"], np.float64)
        s = scenarios or b.shape[0] // steps
        a = a[: s * steps]
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        d = np.abs(a - b)
        tol = SOLVE_ATOL + SOLVE_RTOL * np.abs(b)
        spread = np.asarray(rec[f"{prefix}/spread/{f}"], np.float64)
        if f == "u_star" and force_cols:
            fd = d[:, :force_cols].reshape(s, -1)
            force_tol = FORCE_ATOL + SOLVE_RTOL * np.abs(b[:, :force_cols]).reshape(s, -1)
            assert bool((fd <= force_tol).all()), (f"{what}: contact forces of u*",
                                                  float(fd.max()))
            forces_past = np.nonzero(fd.max(1) > np.maximum(spread, SOLVE_ATOL))[0].tolist()
            err["u_star_forces"] = float(fd.max())
            d, tol = d[:, force_cols:], tol[:, force_cols:]
        d, tol = d.reshape(s, -1), tol.reshape(s, -1)
        ok = (d <= tol).all(1)
        wide = (spread > SOLVE_ATOL) & (d <= np.maximum(tol, spread[:, None])).all(1)
        bad = np.nonzero(~(ok | wide))[0].tolist()
        assert not bad, (f"{what}: samples outside the tolerance and the JAX package's spread",
                         f, bad, float(d.max()))
        held |= set(np.nonzero(~ok)[0].tolist())
        err[f] = float(d.max())
    err["held_to_jax_spread"] = sorted(held)
    err["forces_past_jax_spread"] = forces_past
    return err


def hold_mpcnet_round0(info, rec, lane, what):
    """Round 0 of a training run against the record: its samples
    (hold_mpcnet_samples), its Adam losses on the record's draws and the
    weights after them (MPCNET_LOSS_*, MPCNET_WEIGHT_ATOL)."""
    steps = rec[f"{lane}/r0/samples/t"].shape[0] // rec[f"{lane}/r0/x0s"].shape[0]
    out = {"samples": hold_mpcnet_samples(info["samples"], rec, f"{lane}/r0", steps, what,
                                          force_cols=MPCNET_FORCE_COLS.get(lane, 0))}
    mine = np.asarray(info["step_losses"], np.float64)
    ref = np.asarray(rec[f"{lane}/r0/losses"], np.float64)
    d = np.abs(mine - ref)
    assert mine.shape == ref.shape and bool(
        (d <= MPCNET_LOSS_ATOL + MPCNET_LOSS_RTOL * np.abs(ref)).all()), (
        f"{what}: round 0's losses", float(d.max()), int(d.argmax()))
    want = mpcnet_record_weights(rec, f"{lane}/r0/weights")
    assert info["weights"].keys() == want.keys(), (what, sorted(info["weights"]), sorted(want))
    w_err = max(float(np.abs(info["weights"][k] - want[k]).max()) for k in want)
    assert w_err <= MPCNET_WEIGHT_ATOL, (f"{what}: weights after round 0", w_err)
    out.update({"loss_max_abs_err": float(d.max()), "loss_max_rel_err": float(
        (d / np.maximum(np.abs(ref), 1e-12)).max()), "weights_max_abs_err": w_err})
    return out


class NonFiniteQpSteps:
    """Counts the QP solves of ``solvers.sqp`` whose forward pass is not
    finite (every scenario of every iteration the batched loop runs), on the
    device, without a host read until ``take``: the tool's count of the JAX
    package (tools/mpcnet_reference.py) beside the port's."""

    def __init__(self, torch):
        from ocs2_tpu_torch.solvers import sqp

        self.torch, self.sqp, self.count = torch, sqp, None

    def __enter__(self):
        torch, original = self.torch, self.sqp.lqr_forward
        self.original = original

        def forward(qp, sol, dx0):
            dxs, dus = original(qp, sol, dx0)
            bad = ~(torch.isfinite(dxs).flatten(1).all(1) & torch.isfinite(dus).flatten(1).all(1))
            self.count = bad.sum() if self.count is None else self.count + bad.sum()
            return dxs, dus

        self.sqp.lqr_forward = forward
        return self

    def __exit__(self, *exc):
        self.sqp.lqr_forward = self.original

    def take(self) -> int:
        out, self.count = (0 if self.count is None else int(self.count)), None
        return out


def mpcnet_train_lane(torch, riccati_cuda, net, rec, lane, what):
    """``Mpcnet.train`` from the record's initial weights and starts, round
    0's Adam steps on the record's draws (later rounds draw from a
    generator): per round its samples, losses, weights after round 0, time,
    SQP iterations and non-finite QP steps, and the run's K1 launches."""
    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.learning import export

    s = net.s
    policy = convert.policy_from_numpy(mpcnet_record_weights(rec, f"{lane}/init"),
                                       net.init_policy(None, rec[f"{lane}/example_x"]))
    indices = [torch.as_tensor(rec[f"{lane}/r0/indices"])] + [None] * (s.rounds - 1)
    rounds, iterations = [], []
    generator = torch.Generator(device=DEVICE).manual_seed(MPCNET_KEYS[lane])
    with NonFiniteQpSteps(torch) as nonfinite:

        def on_round(info):
            info = dict(info, nonfinite_qp_steps=nonfinite.take(),
                        sqp_iterations=torch.stack(iterations).float().cpu())
            iterations.clear()
            if info["round"] == 0:
                info["weights"] = export.export_params(info["policy"])
            rounds.append(info)

        torch.cuda.synchronize()
        riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
        t0 = time.perf_counter()
        policy, losses = net.train(generator, mpcnet_record_sampler(torch, rec, lane),
                                   policy=policy, indices=indices, on_round=on_round,
                                   on_solve=lambda sol: iterations.append(sol.iterations))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    its = torch.cat([r["sqp_iterations"].flatten() for r in rounds])
    # Every control step is one batched solve: one launch an iteration of
    # the batch's longest-running scenario.
    longest = sum(float(r["sqp_iterations"].reshape(s.rollout_steps, -1).max(1).values.sum())
                  for r in rounds)
    assert launches == int(longest) > 0, (what, launches, longest)
    assert dims == (s.data_scenarios, s.mpc_intervals, net.problem.nx, 12 if lane == "legged"
                    else net.problem.nu), (what, dims)
    for r in rounds:
        sl = r["step_losses"]
        assert bool(torch.isfinite(sl).all()), (what, r["round"], sl)
    return dict(policy=policy, losses=losses, rounds=rounds, seconds=seconds, launches=launches,
                dims=list(dims), sqp_iterations_per_solve=float(its.mean()),
                longest=longest)


def mpcnet_round_metrics(r, s):
    samples = s.data_scenarios * s.rollout_steps
    return {"round": r["round"], "alpha": r["alpha"], "round_seconds": r["data_s"] + r["train_s"],
            "data_seconds": r["data_s"], "train_seconds": r["train_s"],
            "samples_per_s": samples / r["data_s"],
            "train_steps_per_s": s.learning_iterations / r["train_s"],
            "loss_first": float(r["step_losses"][0]), "loss_last": float(r["step_losses"][-1]),
            "sqp_iterations_per_solve": float(r["sqp_iterations"].mean()),
            "nonfinite_qp_steps": r["nonfinite_qp_steps"]}


def mpcnet_evaluate(torch, riccati_cuda, net, policy, x0, eval_shape):
    """``evaluate`` of one start (solves at B = 1: K1 strict), timed, with
    its launches."""
    torch.cuda.synchronize()
    riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
    t0 = time.perf_counter()
    metrics = net.evaluate(policy, 0.0, np.asarray(x0, np.float32))
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    nx, nu, b, n = eval_shape
    assert launches > 0 and dims == (b, n, nx, nu), (launches, dims)
    out = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in out.values()), out
    return out, {"seconds": sec, "riccati_launches": launches, "kernel_dims": list(dims)}


def mpcnet_legged_train(torch, riccati_cuda, at_train, at_eval, out=None):
    """MPC-Net's training loop on the legged robot at its full width,
    ``make_legged_mpcnet()`` as the JAX package sets it: a mixture of 3
    linear experts on the 26-wide observation (state and gait phase), the
    weight-compensating action transform, 4 scenarios x 4 control steps of
    0.05 s a round, 2 rounds (alpha 1 then 0) of 150 Adam steps at batch 32
    from a memory of 512, each control step one batched SQP solve at N = 14
    over 0.7 s (5 iterations, rk2; K1 at (4, 14, 24, 12), clamped) and the
    Hamiltonian expansion of its solution.  From the record's initial weights
    and starts: round 0 held against the JAX package's (hold_mpcnet_round0),
    round 1 (the policy alone acts) by the JAX test's criteria (finite, last
    loss <= 1.5 x first), ``evaluate`` from the record's start beside the JAX
    package's."""
    from ocs2_tpu_torch.learning import robots

    rec = load_record(MPCNET_RECORD)
    net = robots.make_legged_mpcnet(device=DEVICE)
    s = net.s
    run = mpcnet_train_lane(torch, riccati_cuda, net, rec, "legged", "mpcnet_legged_train")
    vs_record = hold_mpcnet_round0(run["rounds"][0], rec, "legged", "mpcnet_legged_train")
    last = run["rounds"][-1]["step_losses"]
    assert float(last[-1]) <= MPCNET_DIVERGENCE * float(last[0]), last.tolist()
    metrics, ev = mpcnet_evaluate(torch, riccati_cuda, net, run["policy"], rec["legged/eval/x0"],
                                  MPCNET_EVAL_SHAPES["legged"])
    data_s = sum(r["data_s"] for r in run["rounds"])
    rec_out = {
        "phase": "mpcnet_legged_train", "policy": "mixture_of_linear_experts (3)",
        "observation": 26, "nx": 24, "nu": 24, "scenarios": s.data_scenarios,
        "rollout_steps": s.rollout_steps, "rounds": s.rounds,
        "learning_iterations": s.learning_iterations, "batch_size": s.batch_size,
        "memory_capacity": s.memory_capacity, "N": s.mpc_intervals,
        "sqp_max_iterations": s.solver_settings.max_iterations,
        "seconds": run["seconds"], "rounds_metrics": [mpcnet_round_metrics(r, s)
                                                       for r in run["rounds"]],
        "samples_per_s": s.rounds * s.data_scenarios * s.rollout_steps / data_s,
        "train_steps_per_s": s.rounds * s.learning_iterations
        / sum(r["train_s"] for r in run["rounds"]),
        "sqp_iterations_per_solve": run["sqp_iterations_per_solve"],
        "riccati_launches": run["launches"], "kernel_dims": run["dims"],
        "share_of_data_rounds": run["launches"] * 1e-3 * at_train["kernel_ms"] / data_s,
        "vs_jax_round0": vs_record, "losses": run["losses"],
        "jax_losses": [float(rec[f"legged/r{r}/losses"][-1]) for r in range(s.rounds)],
        "evaluate": metrics, "jax_evaluate": {
            k: float(rec[f"legged/eval/{k}"]) for k in ("survival_time", "incurred_hamiltonian")},
        "evaluate_run": ev, "evaluate_share": ev["riccati_launches"] * 1e-3 * at_eval["kernel_ms"]
        / ev["seconds"],
        "nonfinite_qp_steps": [r["nonfinite_qp_steps"] for r in run["rounds"]],
        "jax_nonfinite_qp_steps": [int(rec[f"legged/r{r}/nonfinite_qp_steps"])
                                   for r in range(s.rounds)],
    }
    emit(rec_out)
    if out is not None:
        out["legged"] = {k: rec_out[k] for k in ("losses", "evaluate", "nonfinite_qp_steps")}
        out["legged"]["round0_losses"] = run["rounds"][0]["step_losses"].tolist()
    return rec_out


def profile_mpcnet(torch):
    """Where one control step of mpcnet_legged_train's data round spends its
    time (B = 4, N = 14, the record's starts): host-clock medians of the SQP
    solve, the LQ data of its solution, the Hamiltonian expansion, the
    policy and the plant step, one Adam step of the round's batch, and the
    card's busy share over one control step from torch.profiler."""
    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.learning import robots
    from ocs2_tpu_torch.learning.loss import hamiltonian_from_lq
    from ocs2_tpu_torch.learning.memory import CircularMemory
    from ocs2_tpu_torch.oc.approx import approximate_lq
    from ocs2_tpu_torch.solvers import sqp

    rec = load_record(MPCNET_RECORD)
    net = robots.make_legged_mpcnet(device=DEVICE)
    st = net.s.solver_settings
    policy = convert.policy_from_numpy(mpcnet_record_weights(rec, "legged/init"),
                                       net.init_policy(None, rec["legged/example_x"]))
    x = torch.as_tensor(rec["legged/r0/x0s"], device=DEVICE)
    grid = net.grid_fn(np.float32(0.0))
    timed = lambda fn: timed_stage(torch, fn)  # noqa: E731
    stages = {}
    sol, stages["sqp_solve_ms"] = timed(
        lambda: sqp.solve(net.problem, grid, x, net.params, settings=st, device=DEVICE))
    lq, stages["approximate_lq_ms"] = timed(lambda: approximate_lq(
        net.problem, grid, sol.xs, sol.us, net.params, method=st.integrator,
        substeps=st.substeps))
    _, stages["hamiltonian_ms"] = timed(
        lambda: hamiltonian_from_lq(lq, sol.value_S, sol.value_s, sol.xs))
    with torch.no_grad():
        u, stages["policy_ms"] = timed(lambda: net.policy_u(policy, np.float32(0.0), x))
        _, stages["plant_step_ms"] = timed(
            lambda: net.flow(net._time(np.float32(0.0)), x, u, net.s.control_dt))
    samples = net.generate_data(policy, 1.0, np.zeros(1, np.float32), x)
    memory = CircularMemory.create(net.example_sample(24), net.s.memory_capacity,
                                   device=DEVICE).push_batch(samples)
    optimizer = net.make_optimizer(policy)
    generator = torch.Generator(device=DEVICE).manual_seed(0)
    _, stages["adam_step_ms"] = timed(
        lambda: net.train_step(policy, optimizer, memory, generator))
    busy = device_busy(torch, lambda: net._mpc_step(np.float32(0.0), x))
    emit({"phase": "profile", "path": "mpcnet_legged_control_step", "B": x.shape[0],
          "N": net.s.mpc_intervals, "sqp_iterations": sol.iterations.tolist(),
          "stages": stages, "profiler": busy})


def mpcnet_legged_datagen_b256(torch, riccati_cuda, at_b256, out=None):
    """One alpha = 1 data round of ``make_legged_mpcnet()`` over MPCNET_B256
    starts (mpcnet_b256_x0s: legged_x0_sampler's scales, noise from a numpy
    seed): 256 scenarios x 4 control steps, each one batched SQP solve (K1 at
    (256, 14, 24, 12), clamped), 1,024 samples pushed into a memory of 1,024,
    then MPCNET_B256_STEPS Adam steps.  The first MPCNET_B256_RECORD
    scenarios' samples are held against the JAX package's vmapped round over
    the same 256 starts (hold_mpcnet_samples, with its spread)."""
    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.learning import robots
    from ocs2_tpu_torch.learning.memory import CircularMemory
    from ocs2_tpu_torch.models.legged_robot import model

    rec = load_record(MPCNET_RECORD)
    net = robots.make_legged_mpcnet(device=DEVICE)
    s = net.s
    x0s = mpcnet_b256_x0s(model.default_state("cpu").numpy())
    assert np.array_equal(x0s[:MPCNET_B256_RECORD], rec["b256/x0s"])
    policy = convert.policy_from_numpy(mpcnet_record_weights(rec, "b256/init"),
                                       net.init_policy(None, x0s[0]))
    iterations = []
    with NonFiniteQpSteps(torch) as nonfinite:
        torch.cuda.synchronize()
        riccati_cuda.launch_count, riccati_cuda.last_launch_dims = 0, None
        t0 = time.perf_counter()
        samples = net.generate_data(policy, 1.0, np.zeros(1, np.float32), x0s,
                                    on_solve=lambda sol: iterations.append(sol.iterations))
        torch.cuda.synchronize()
        data_s = time.perf_counter() - t0
        bad = nonfinite.take()
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    its = torch.stack(iterations)
    assert launches == int(its.max(1).values.sum()) > 0, (launches, its.max(1).values)
    assert dims == (MPCNET_B256, s.mpc_intervals, 24, 12), dims
    memory = CircularMemory.create(net.example_sample(24), MPCNET_B256 * s.rollout_steps,
                                   device=DEVICE)
    memory.push_batch(samples)
    assert memory.size == MPCNET_B256 * s.rollout_steps
    optimizer = net.make_optimizer(policy)
    generator = torch.Generator(device=DEVICE).manual_seed(MPCNET_B256_SEED)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    losses = torch.stack([net.train_step(policy, optimizer, memory, generator)
                          for _ in range(MPCNET_B256_STEPS)]).cpu()
    train_s = time.perf_counter() - t1
    assert bool(torch.isfinite(losses).all()), losses
    assert float(losses[-1]) <= MPCNET_DIVERGENCE * float(losses[0]), losses.tolist()
    vs_record = hold_mpcnet_samples(samples, rec, "b256", s.rollout_steps,
                                    "mpcnet_legged_datagen_b256", scenarios=MPCNET_B256_RECORD,
                                    force_cols=MPCNET_FORCE_COLS["b256"])
    rec_out = {
        "phase": "mpcnet_legged_datagen_b256", "scenarios": MPCNET_B256,
        "rollout_steps": s.rollout_steps, "N": s.mpc_intervals, "samples": memory.size,
        "data_seconds": data_s, "samples_per_s": memory.size / data_s,
        "train_steps": MPCNET_B256_STEPS, "train_seconds": train_s,
        "train_steps_per_s": MPCNET_B256_STEPS / train_s,
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "sqp_iterations_per_solve": float(its.float().mean()),
        "riccati_launches": launches, "kernel_dims": list(dims),
        "share_of_data_round": launches * 1e-3 * at_b256["kernel_ms"] / data_s,
        "vs_jax_first_32": vs_record, "nonfinite_qp_steps": bad,
        "jax_nonfinite_qp_steps": int(rec["b256/nonfinite_qp_steps"]),
    }
    emit(rec_out)
    if out is not None:
        out["b256"] = {"vs_record": vs_record, "nonfinite_qp_steps": bad}
    return rec_out


def mpcnet_closed_loop_err(torch, net, policy, x0, steps=6, dt=0.1):
    """tests/test_learning.py:293-307: the sum over 6 policy steps of 0.1 s
    (rk4, 2 substeps) of |x[:5]|^2."""
    x = torch.as_tensor(np.asarray(x0, np.float32), device=DEVICE)[None]
    err = 0.0
    with torch.no_grad():
        for k in range(steps):
            t = np.float32(dt * k)
            x = net.flow(net._time(t), x, net.policy_u(policy, t, x), dt)
            err += float((x[0, :5] ** 2).sum())
    return err


def mpcnet_ballbot_train(torch, riccati_cuda, at_train, at_eval, out=None):
    """MPC-Net's training loop on the ballbot, ``make_ballbot_mpcnet()`` as
    the JAX package sets it: an MLP with one tanh layer of 6, 8 scenarios x 6
    control steps of 0.1 s a round, 3 rounds (alpha 1, 0.5, 0) of 200 Adam
    steps at batch 32 from a memory of 1,024, SQP at N = 16 over 1 s (6
    iterations, rk4; K1 at (8, 16, 10, 3), clamped).  From the record's
    initial weights and starts: round 0 held against the JAX package's
    (hold_mpcnet_round0); the trained policy by the JAX test's criteria
    (tests/test_learning.py:278-309): it survives the lean x[3] = 0.12 for
    the whole evaluation with a finite incurred Hamiltonian, and its
    closed-loop error is below the fresh policy's (the record's PRNGKey(3)
    weights)."""
    from ocs2_tpu_torch import convert
    from ocs2_tpu_torch.learning import robots

    rec = load_record(MPCNET_RECORD)
    net = robots.make_ballbot_mpcnet(device=DEVICE)
    s = net.s
    run = mpcnet_train_lane(torch, riccati_cuda, net, rec, "ballbot", "mpcnet_ballbot_train")
    vs_record = hold_mpcnet_round0(run["rounds"][0], rec, "ballbot", "mpcnet_ballbot_train")
    metrics, ev = mpcnet_evaluate(torch, riccati_cuda, net, run["policy"],
                                  rec["ballbot/eval/x0"], MPCNET_EVAL_SHAPES["ballbot"])
    assert abs(metrics["survival_time"] - s.rollout_steps * s.control_dt) < 1e-5, metrics
    fresh = convert.policy_from_numpy(mpcnet_record_weights(rec, "ballbot/fresh"),
                                      net.init_policy(None, rec["ballbot/eval/x0"]))
    err = {"trained": mpcnet_closed_loop_err(torch, net, run["policy"], rec["ballbot/eval/x0"]),
           "fresh": mpcnet_closed_loop_err(torch, net, fresh, rec["ballbot/eval/x0"])}
    assert err["trained"] < err["fresh"], err
    data_s = sum(r["data_s"] for r in run["rounds"])
    rec_out = {
        "phase": "mpcnet_ballbot_train", "policy": "nonlinear (one tanh layer of 6)",
        "nx": 10, "nu": 3, "scenarios": s.data_scenarios, "rollout_steps": s.rollout_steps,
        "rounds": s.rounds, "learning_iterations": s.learning_iterations,
        "batch_size": s.batch_size, "memory_capacity": s.memory_capacity, "N": s.mpc_intervals,
        "sqp_max_iterations": s.solver_settings.max_iterations, "seconds": run["seconds"],
        "rounds_metrics": [mpcnet_round_metrics(r, s) for r in run["rounds"]],
        "samples_per_s": s.rounds * s.data_scenarios * s.rollout_steps / data_s,
        "train_steps_per_s": s.rounds * s.learning_iterations
        / sum(r["train_s"] for r in run["rounds"]),
        "sqp_iterations_per_solve": run["sqp_iterations_per_solve"],
        "riccati_launches": run["launches"], "kernel_dims": run["dims"],
        "share_of_data_rounds": run["launches"] * 1e-3 * at_train["kernel_ms"] / data_s,
        "vs_jax_round0": vs_record, "losses": run["losses"],
        "jax_losses": [float(rec[f"ballbot/r{r}/losses"][-1]) for r in range(s.rounds)],
        "evaluate": metrics, "jax_evaluate": {
            k: float(rec[f"ballbot/eval/{k}"]) for k in ("survival_time", "incurred_hamiltonian")},
        "evaluate_run": ev, "evaluate_share": ev["riccati_launches"] * 1e-3 * at_eval["kernel_ms"]
        / ev["seconds"],
        "closed_loop_err": err, "jax_closed_loop_err": {
            k: float(rec[f"ballbot/closed_loop_err/{k}"]) for k in ("trained", "fresh")},
        "nonfinite_qp_steps": [r["nonfinite_qp_steps"] for r in run["rounds"]],
        "jax_nonfinite_qp_steps": [int(rec[f"ballbot/r{r}/nonfinite_qp_steps"])
                                   for r in range(s.rounds)],
    }
    emit(rec_out)
    if out is not None:
        out["ballbot"] = {k: rec_out[k] for k in ("losses", "evaluate", "nonfinite_qp_steps")}
        out["ballbot"]["round0_losses"] = run["rounds"][0]["step_losses"].tolist()
    return rec_out


# -- the last slice: the associative-scan Riccati (K7), the phase profile, the
# entry step and the multi-device dry run with the horizon-sharded PIPG (K9).

PR_RECORD = os.path.join(_DATA, "parallel_riccati_reference.npz")
# parallel_riccati_check's (nx, nu, B, N): the legged tick's, the legged
# batch's and the ballbot batch's sweeps, on random_lq data.
K7_SHAPES = [(24, 12, 1, 100), (24, 12, 256, 100), (10, 3, 4096, 32)]
K7_SEEDS = (81, 82, 83)
# K7 against K1 and the plain version: tests/test_riccati.py:41-48's atol
# beside a relative part for the legged value function (entries in the
# thousands).
K7_ATOL, K7_RTOL = 5e-3, 1e-3
K7_FIELDS = ("value_S", "value_s", "gains", "kff")
PR_BALLBOT_RECORD_BATCH = 64  # the record holds the ballbot batch's first 64
ENTRY_N = 32  # __graft_entry__.entry()'s horizon
ENTRY_SHAPE = (24, 12, 1, ENTRY_N)
ENTRY_COST_RTOL = 1e-5
HORIZON_SHARDS = 4  # the time mesh on cuda:0, the device listed four times
# The dry run's scenario chunks: two flagship solves at N = 8 a shard.
DRYRUN_SHAPE = (24, 12, 2, 8)
SHARDED_XS_ATOL = 5e-3  # tests/test_sharding.py:174-175
HORIZON_JAX_TOL = 2e-3  # tests/test_sharding.py:45-51


def hold_k7(torch, out, ref):
    """K7 against another route to the same sweep: every entry of K7_FIELDS
    within K7_ATOL + K7_RTOL |value| and finite.  Returns the largest
    absolute difference."""
    worst = 0.0
    for f in K7_FIELDS:
        a, b = getattr(out, f), getattr(ref, f)
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        assert bool(torch.isfinite(a).all()), f"K7: non-finite {f}"
        assert bool((d <= K7_ATOL + K7_RTOL * b.abs()).all()), (f"K7: {f}", float(d.max()))
    return worst


def parallel_riccati_check(torch, riccati, riccati_cuda, k1_checks):
    """K7 (``lqr_backward_parallel``, torch ops) on the card at K7_SHAPES,
    held against K1 (strict at B = 1, clamped otherwise) and the plain
    version on the same random_lq data; it launches K1 no time.  Its time is
    the median of 20 calls by CUDA events after 3 warm-ups, beside K1's, the
    plain version's (kernel_check's at the shape) and the sweep's bound;
    its launches per call come from the profiler.  Beside the largest
    difference, the JAX package's own distance from its K7 to its sequential
    sweep on the same inputs (the record)."""
    rec_pr = load_record(PR_RECORD)
    out_recs = []
    for shape, seed in zip(K7_SHAPES, K7_SEEDS):
        nx, nu, batch, n = shape
        coeffs, reg = random_lq(torch, riccati, nx, nu, batch, n, seed)
        before = riccati_cuda.launch_count
        out = riccati.lqr_backward_parallel(coeffs, reg)
        torch.cuda.synchronize()
        assert riccati_cuda.launch_count == before, "K7 launched K1"
        k1 = riccati.lqr_backward(coeffs, reg)
        plain = riccati._lqr_backward_batched(coeffs, reg, strict=batch == 1)
        err = {"vs_k1": hold_k7(torch, out, k1), "vs_plain": hold_k7(torch, out, plain)}
        key = "k7_{}_{}_{}_{}".format(*shape)
        jax_dist = {f: float(rec_pr[f"{key}_{f}_max_abs"]) for f in K7_FIELDS}
        k7 = lambda: riccati.lqr_backward_parallel(coeffs, reg)  # noqa: E731
        rec = {
            "phase": "parallel_riccati_check", "kernel": "lqr_backward_parallel",
            "route": "torch", "nx": nx, "nu": nu, "B": batch, "N": n,
            "max_abs_err": max(err.values()), "max_abs_err_vs": err,
            "atol": K7_ATOL, "rtol": K7_RTOL, "jax_k7_vs_sequential_max_abs": jax_dist,
            "ms": time_ms(torch, k7, reps=20, warmup=3),
            "ms_queued": time_ms_queued(torch, k7, reps=20, warmup=3),
            "launches_per_call": count_launches(torch, k7),
            "k1_ms": time_ms(torch, lambda: riccati.lqr_backward(coeffs, reg), reps=20, warmup=3),
            "plain_ms": k1_checks[shape]["plain_ms"],
            **{k: v for k, v in riccati_bound(nx, nu, batch, n).items()
               if k in ("bound_ms", "bound_by", "bound_term", "bytes_ms", "flops_ms",
                        "chain_ms")},
            "ok": True,
        }
        rec["k7_over_k1"] = rec["ms"] / rec["k1_ms"]
        emit(rec)
        out_recs.append(rec)
    return out_recs


def legged_parallel_riccati_b1(torch, riccati, riccati_cuda, cfg, cold_b1):
    """The flagship SQP (N = 100, 10 iterations) at B = 1, one cold solve with
    ``parallel_riccati=True``: K1 launches no time, K7 once an iteration.  Held
    to the JAX package's record of the same solve (iterations equal or tied
    at equal merit; xs, us within SOLVE_ATOL + SOLVE_RTOL |value|, contact
    forces at FORCE_ATOL) and to the port's K1 route (legged_tick_b1's cold
    solve) alike."""
    rec_pr = load_record(PR_RECORD)
    par_cfg = dict(cfg, settings=dataclasses.replace(cfg["settings"], parallel_riccati=True))
    riccati_cuda.launch_count = 0
    riccati.parallel_calls = 0
    t0 = time.perf_counter()
    sol = legged_solve(par_cfg, cfg["x0"], cfg["us_init"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, k7_calls = riccati_cuda.launch_count, riccati.parallel_calls
    assert launches == 0, f"K1 ran {launches} times with parallel_riccati=True"
    assert k7_calls == int(sol.iterations[0]) > 0, (k7_calls, sol.iterations.tolist())
    check_legged_solution(torch, cfg, sol, "parallel Riccati b1")
    assert np.array_equal(rec_pr["flagship_x0"], cfg["x0"].cpu().numpy())
    ref = record_solution(torch, rec_pr, "flagship_", rows=None)
    vs_jax, tied_jax, _ = compare_with_ties(torch, sol, ref, "parallel Riccati vs the JAX record",
                                            max_tied_share=1.0, force_atol=FORCE_ATOL)
    vs_k1, tied_k1, _ = compare_with_ties(torch, sol, cold_b1, "parallel Riccati vs K1",
                                          max_tied_share=1.0, force_atol=FORCE_ATOL)
    rec = {
        "phase": "legged_parallel_riccati_b1", "B": 1, "N": LEGGED_N, "nx": 24, "nu": 24,
        "max_iterations": par_cfg["settings"].max_iterations,
        "seconds_per_solve": seconds, "iterations": int(sol.iterations[0]),
        "k1_route_iterations": int(cold_b1.iterations[0]),
        "jax_record_iterations": int(rec_pr["flagship_iterations"]),
        "jax_spread": {"xs": float(rec_pr["flagship_spread_xs"]),
                       "us": float(rec_pr["flagship_spread_us"])},
        "riccati_launches": launches, "k7_calls": k7_calls,
        "vs_jax_record": vs_jax, "tied_with_jax_record": tied_jax,
        "vs_k1_route": vs_k1, "tied_with_k1_route": tied_k1,
        "merit": float(sol.performance.merit[0]), "ok": True,
    }
    emit(rec)
    return rec


def hold_against_the_sequential_route(torch, sol, k1_sol, rec_pr, what, max_share=0.02):
    """K7's ballbot batch solve against the K1 route, scenario by scenario.

    A scenario agrees as compare_with_ties holds two routes: iterations equal
    (or tied: apart at a merit equal to 1e-6 relative), xs (and us unless
    tied) within SOLVE_ATOL + SOLVE_RTOL |value|.  The JAX package's own
    associative scan and sequential sweep part on some scenarios of the same
    batch by more than that (the record's ``ballbot_all_k7_seq_*``: float32
    rounding carried through iterations that stop at the budget).  A
    scenario that does not agree is held to the largest distance in xs and
    in us between the JAX package's two sweeps over the batch, never past
    it, and such scenarios together with the ties to ``max_share`` of the
    batch (main_path's share of ties).  Returns the counts and the largest
    differences beside the JAX package's own."""
    env = {f: float(rec_pr[f"ballbot_all_k7_seq_{f}"].max()) for f in ("xs", "us")}
    rel = (sol.performance.merit - k1_sol.performance.merit).abs() / (
        k1_sol.performance.merit.abs().clamp(min=1e-30))
    its_equal = sol.iterations == k1_sol.iterations
    tied = ~its_equal & (rel <= 1e-6)
    ok, within_env, err = {}, torch.ones_like(its_equal), {}
    for f in ("xs", "us"):
        a, b = getattr(sol, f), getattr(k1_sol, f)
        d = (a - b).abs()
        err[f] = float(d.max())
        ok[f] = (d <= SOLVE_ATOL + SOLVE_RTOL * b.abs()).flatten(1).all(1)
        within_env &= d.flatten(1).amax(1) <= env[f]
    strict = (its_equal & ok["xs"] & ok["us"]) | (tied & ok["xs"])
    held = ~strict & within_env
    bad = torch.nonzero(~(strict | held)).flatten().tolist()
    assert not bad, (f"{what}: scenarios past the JAX package's own K7-to-sequential distance",
                     bad, err, env)
    apart = int((~strict).sum())
    assert apart <= max_share * strict.shape[0], (f"{what}: {apart} scenarios apart", err)
    jax_apart = ((rec_pr["ballbot_all_k7_seq_xs"] > SOLVE_ATOL)
                 | (rec_pr["ballbot_all_k7_seq_us"] > SOLVE_ATOL))
    return {"max_abs_err": err, "tied": int(tied.sum()),
            "held_to_jax_k7_vs_sequential": int(held.sum()),
            "iterations_differ": int((~its_equal).sum()),
            "jax_k7_vs_sequential_max": env,
            "jax_k7_vs_sequential_apart_by_1e-3": int(jax_apart.sum()),
            "jax_k7_vs_sequential_iterations_differ": int(
                (rec_pr["ballbot_all_iterations"] != rec_pr["ballbot_all_seq_iterations"]).sum())}


def ballbot_ilqr_parallel_b4096(torch, riccati, riccati_cuda, main_run, solves=TIMED_SOLVES):
    """``ddp.solve`` (iLQR) on main_path's 4,096 scenarios with
    ``parallel_riccati=True``, timed once after a warm-up: K1 launches no
    time.  Held to the K1 route by hold_against_the_sequential_route (at most
    2 % of the scenarios apart, none past the JAX package's own distance
    between its two sweeps), its first 64 scenarios to the JAX package's
    record."""
    from ocs2_tpu_torch.solvers import ddp

    problem, params, grid, x0s = ballbot_batch(torch)
    settings = ddp.DdpSettings(algorithm="ilqr", max_iterations=8)
    par_settings = dataclasses.replace(settings, parallel_riccati=True)

    def solve(st):
        sol = ddp.solve(problem, grid, x0s, params, settings=st, device=DEVICE)
        torch.cuda.synchronize()
        return sol

    solve(par_settings)  # warm-up
    riccati_cuda.launch_count = 0
    riccati.parallel_calls = 0
    seconds = []
    for _ in range(solves):
        t0 = time.perf_counter()
        sol = solve(par_settings)
        seconds.append(time.perf_counter() - t0)
    launches, k7_calls = riccati_cuda.launch_count, riccati.parallel_calls
    assert launches == 0, f"K1 ran {launches} times with parallel_riccati=True"
    assert k7_calls == solves * int(sol.iterations.max()) > 0, k7_calls
    assert bool(torch.isfinite(sol.xs).all()) and bool(torch.isfinite(sol.us).all())
    k1_sol = solve(settings)
    rec_pr = load_record(PR_RECORD)
    vs_k1 = hold_against_the_sequential_route(torch, sol, k1_sol, rec_pr, "ballbot K7 vs K1")
    first = slice(0, PR_BALLBOT_RECORD_BATCH)
    assert np.array_equal(rec_pr["ballbot_x0s"], x0s[first].cpu().numpy())
    vs_record = compare_with_record(torch, take_rows(sol, first), rec_pr, "ballbot_",
                                    "ballbot K7 vs the JAX record")
    sec = statistics.median(seconds)
    rec = {
        "phase": "ballbot_ilqr_parallel_b4096", "B": x0s.shape[0], "N": grid.num_intervals,
        "max_iterations": settings.max_iterations, "solves_timed": solves,
        "seconds_per_solve": sec, "solves_per_s": x0s.shape[0] / sec,
        "main_path_solves_per_s": main_run["solves_per_s"],
        "riccati_launches": launches, "k7_calls": k7_calls,
        "vs_k1_route": vs_k1,
        "vs_jax_record": vs_record,
        "iterations_equal_to_jax_record": int((sol.iterations[first].cpu().numpy()
                                               == rec_pr["ballbot_iterations"]).sum()),
        "ok": True,
    }
    emit(rec)
    return rec


def sqp_phase_profile(torch, riccati, riccati_cuda, full=False):
    """``utils/profiling.profile_sqp_phases`` on entry()'s problem (N = 32;
    with ``full`` also the flagship at N = 100), warmup 1, reps 3; prints
    ``format_report``'s lines.  Its riccati_seq phase and its full solves run
    K1 at (1, N, 24, 12) strict."""
    from ocs2_tpu_torch.models.legged_robot import interface, model
    from ocs2_tpu_torch.models.legged_robot.gait import GaitSchedule, trot_gait
    from ocs2_tpu_torch.oc.time_discretization import make_time_grid
    from ocs2_tpu_torch.solvers import sqp
    from ocs2_tpu_torch.utils.profiling import format_report, profile_sqp_phases

    recs = []
    for n in (ENTRY_N, LEGGED_N) if full else (ENTRY_N,):
        ms = GaitSchedule(trot_gait(0.7)).mode_schedule(0.0, 1.0)
        grid = make_time_grid(0.0, 1.0, n, event_times=ms.event_times,
                              mode_sequence=ms.mode_sequence)
        u0 = model.weight_compensating_input(np.ones(4, np.float32), DEVICE)
        riccati_cuda.launch_count = 0
        riccati.parallel_calls = 0
        report = profile_sqp_phases(
            interface.make_problem(device=DEVICE), grid, model.default_state(DEVICE),
            interface.make_params(grid, device=DEVICE),
            sqp.SqpSettings(max_iterations=10, integrator="rk2"),
            us_init=u0[None].expand(n, model.NU), device=DEVICE, warmup=1, reps=3)
        assert all(np.isfinite(v) and v > 0 for v in report.values()), report
        rec = {"phase": "sqp_phase_profile", "N": n, "warmup": 1, "reps": 3,
               "report_ms": {k: 1e3 * v for k, v in report.items()},
               "report": format_report(report).splitlines(),
               "riccati_launches": riccati_cuda.launch_count,
               "k7_calls": riccati.parallel_calls,
               "kernel_dims": list(riccati_cuda.last_launch_dims or ())}
        assert rec["riccati_launches"] > 0 and rec["k7_calls"] > 0, rec
        emit(rec)
        recs.append(rec)
    return recs


def entry_step(torch, riccati_cuda):
    """``entry()``'s step on the card: K1 at (1, 32, 24, 12) strict, one
    launch an SQP iteration; held to the JAX package's record of
    ``__graft_entry__.entry()``'s jitted step (iterations, xs and us within
    SOLVE_ATOL + SOLVE_RTOL |value|, cost within ENTRY_COST_RTOL)."""
    from ocs2_tpu_torch.entry import entry

    rec_pr = load_record(PR_RECORD)
    step, (x0,) = entry(device=DEVICE)
    assert np.array_equal(rec_pr["entry_x0"], x0.cpu().numpy())
    riccati_cuda.launch_count = 0
    riccati_cuda.last_launch_dims = None
    k10_before = k10_reset()
    t0 = time.perf_counter()
    xs, us, cost = step(x0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, dims = riccati_cuda.launch_count, riccati_cuda.last_launch_dims
    assert dims == (1, ENTRY_N, 24, 12), dims
    assert launches == int(rec_pr["entry_iterations"]), (launches, rec_pr["entry_iterations"])
    k10_launches = k10_took_every_approximation(k10_before, launches, (1, ENTRY_N), "entry")
    err = {}
    for name, mine in (("xs", xs), ("us", us)):
        ref = torch.as_tensor(rec_pr[f"entry_{name}"], device=DEVICE)
        err[name] = float((mine - ref).abs().max())
        assert bool(((mine - ref).abs() <= SOLVE_ATOL + SOLVE_RTOL * ref.abs()).all()), (
            name, err[name])
    cost_rel = abs(float(cost) - float(rec_pr["entry_cost"])) / abs(float(rec_pr["entry_cost"]))
    assert cost_rel <= ENTRY_COST_RTOL, cost_rel
    rec = {"phase": "entry_step", "N": ENTRY_N, "seconds_first_call": seconds,
           "iterations": launches, "jax_record_iterations": int(rec_pr["entry_iterations"]),
           "riccati_launches": launches, "kernel_dims": list(dims),
           "k10_launches": k10_launches, "vs_jax_record": err,
           "cost": float(cost), "cost_rel_diff": cost_rel, "ok": True}
    emit(rec)
    return rec


def dryrun_multichip_phase(torch, riccati_cuda):
    """``dryrun_multichip`` over every card, then over HORIZON_SHARDS shards
    on cuda:0 (the device listed four times, so that the halo exchange runs
    on the card): its horizon-sharded QP held against ``pipg_solve`` on the
    same data, its ``"pipg_sharded"`` SQP against ``"pipg"``.  The scenario
    batches' flagship solves run K1 at (2, 8, 24, 12), clamped."""
    from ocs2_tpu_torch.entry import dryrun_multichip, dryrun_qp_coeffs, dryrun_sqp
    from ocs2_tpu_torch.ops.pipg import PipgSettings, pipg_solve, ruiz_equilibrate

    riccati_cuda.launch_count = 0
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    dryrun_multichip(cards, devices=[torch.device(DEVICE, i) for i in range(cards)])
    torch.cuda.synchronize()
    seconds_all = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = dryrun_multichip(HORIZON_SHARDS, devices=[torch.device(DEVICE, 0)] * HORIZON_SHARDS)
    torch.cuda.synchronize()
    seconds_shards = time.perf_counter() - t0
    launches = riccati_cuda.launch_count
    assert launches > 0 and riccati_cuda.last_launch_dims == (2, 8, 24, 12), (
        launches, riccati_cuda.last_launch_dims)
    scaled, scal = ruiz_equilibrate(dryrun_qp_coeffs(HORIZON_SHARDS, DEVICE), 3)
    ref_dxs = scal.d_x * pipg_solve(scaled, PipgSettings(num_iterations=200)).dxs
    qp_err = float((out["qp_dxs"] - ref_dxs).abs().max())
    assert bool(((out["qp_dxs"] - ref_dxs).abs()
                 <= HORIZON_JAX_TOL + HORIZON_JAX_TOL * ref_dxs.abs()).all()), qp_err
    plain = dryrun_sqp(HORIZON_SHARDS, DEVICE, qp_solver="pipg")
    sqp_err = float((out["sqp"].xs - plain.xs).abs().max())
    assert sqp_err <= SHARDED_XS_ATOL, sqp_err
    rec = {"phase": "dryrun_multichip", "cards": cards, "seconds_over_cards": seconds_all,
           "shards_on_cuda0": HORIZON_SHARDS, "seconds_over_shards": seconds_shards,
           "qp_vs_pipg_solve_max_abs_err": qp_err, "qp_residual": float(out["qp_residual"][0]),
           "sqp_sharded_vs_pipg_xs_max_abs_err": sqp_err, "riccati_launches": launches,
           "kernel_dims": list(riccati_cuda.last_launch_dims), "ok": True}
    emit(rec)
    return rec


def profile_slq(torch):
    """Where one SLQ iteration of the b4096 lane spends its time: host-clock
    medians of approximate_lq_ct, the CT sweep (kernel), the line search's
    rollout of 8 candidates and their evaluation; the card's busy share over
    one solve."""
    from ocs2_tpu_torch.oc.approx import approximate_lq_ct
    from ocs2_tpu_torch.oc.metrics import evaluate_trajectory
    from ocs2_tpu_torch.oc.rollout import ddp_search_policy, open_loop_policy, rollout
    from ocs2_tpu_torch.ops import riccati_ct
    from ocs2_tpu_torch.solvers import ddp

    problem, params, grid, x0s = ballbot_batch(torch)
    batch, n, nu = x0s.shape[0], grid.num_intervals, problem.nu
    settings = ddp.DdpSettings(algorithm="slq", max_iterations=8)
    ro = lambda x0, pol: rollout(problem, grid, x0, pol, params, substeps=settings._substeps)  # noqa: E731
    alphas = 0.5 ** torch.arange(8, dtype=torch.float32, device=DEVICE)
    timed = lambda fn: timed_stage(torch, fn)  # noqa: E731
    stages = {}
    (xs, us), stages["initial_rollout_ms"] = timed(
        lambda: ro(x0s, open_loop_policy(torch.zeros((batch, n, nu), device=DEVICE))))
    ct, stages["approximate_lq_ct_ms"] = timed(
        lambda: approximate_lq_ct(problem, grid, xs, us, params))
    reg = torch.full((batch,), 1e-6, device=DEVICE)
    sol, stages["riccati_ct_backward_ms"] = timed(
        lambda: riccati_ct.slq_backward(ct, reg, settings.riccati_substeps))
    policy = ddp_search_policy(us, sol.kff, sol.gains, xs, alphas)
    x0c = x0s[:, None, :].expand(batch, 8, x0s.shape[1])
    (xs_c, us_c), stages["line_search_rollout_ms"] = timed(lambda: ro(x0c, policy))
    _, stages["evaluate_candidates_ms"] = timed(
        lambda: evaluate_trajectory(problem, grid, xs_c, us_c, params))
    busy = device_busy(torch, lambda: ddp.solve(problem, grid, x0s, params, settings=settings,
                                                device=DEVICE))
    emit({"phase": "profile", "path": "slq_ballbot_b4096", "B": batch, "N": n,
          "stages": stages, "profiler": busy})


def terrain_check(torch):
    """The elevation-map problem's in-solver gathers and plane fits on the
    card against the same calls on the CPU in this process: approximate_lq
    of terrain.make_perceptive_problem at N = 46, ElevationMap.sdf, and 1,000
    random height_at / plane_at queries.  Tolerance rtol 1e-4 / atol 1e-5
    (LQ leaves: atol 1e-5 times the leaf's largest entry, Hessians reach
    1e4)."""
    from ocs2_tpu_torch.models.legged_robot import interface, model, terrain
    from ocs2_tpu_torch.oc.approx import approximate_lq

    grid = trot_grid(PERC_HORIZON, PERC_N)
    rng = np.random.default_rng(5)
    xs = model.default_state("cpu").numpy()[None] + 0.02 * rng.standard_normal((PERC_N + 1, 24))
    xs[:, 6] = np.linspace(-0.2, 0.9, PERC_N + 1)  # the feet cross the step
    u0 = model.weight_compensating_input(np.ones(4, np.float32), "cpu").numpy()
    us = u0[None] + 5.0 * rng.standard_normal((PERC_N, 24))
    xy = rng.uniform(-2.2, 2.2, (1000, 2)).astype(np.float32)
    out, times = {}, {}
    for dev in ("cpu", DEVICE):
        em = stepped_map(PERC_STEP_X, PERC_STEP_H, device=dev)
        problem = terrain.make_perceptive_problem(em, device=dev)
        params = interface.make_params(grid, device=dev)
        x_t = torch.as_tensor(xs[None].astype(np.float32), device=dev)
        u_t = torch.as_tensor(us[None].astype(np.float32), device=dev)
        q = torch.as_tensor(xy, device=dev)
        lq = approximate_lq(problem, grid, x_t, u_t, params, method="rk2")
        plane = em.plane_at(q)
        out[dev] = {"lq": lq, "sdf": em.sdf(-0.1, 0.5).values, "height": em.height_at(q),
                    "normal": plane.normal, "point": plane.point}
        if dev == DEVICE:
            times = {
                "approximate_lq_ms": time_ms(torch, lambda: approximate_lq(
                    problem, grid, x_t, u_t, params, method="rk2"), reps=3, warmup=1),
                "sdf_ms": time_ms(torch, lambda: em.sdf(-0.1, 0.5), reps=5, warmup=1),
                "plane_at_1000_ms": time_ms(torch, lambda: em.plane_at(q), reps=10, warmup=2),
                "height_at_1000_ms": time_ms(torch, lambda: em.height_at(q), reps=10, warmup=2),
            }
    torch.cuda.synchronize()
    errs, bad = {}, []

    def held(name, a, b, atol):
        a = a.cpu()
        err = float((a - b).abs().max())
        errs[name] = err
        if a.shape != b.shape or not bool(((a - b).abs() <= atol + TERRAIN_RTOL * b.abs()).all()):
            bad.append(name)

    for name in ("sdf", "height"):
        held(name, out[DEVICE][name], out["cpu"][name], 1e-6)
    for name in ("normal", "point"):
        held(name, out[DEVICE][name], out["cpu"][name], ATOL)
    for rec_name in ("cost", "dynamics", "eq"):
        for f in getattr(out["cpu"]["lq"], rec_name)._fields:
            b = getattr(getattr(out["cpu"]["lq"], rec_name), f)
            if b is None:
                continue
            held(f"lq.{rec_name}.{f}", getattr(getattr(out[DEVICE]["lq"], rec_name), f), b,
                 ATOL * max(1.0, float(b.abs().max())))
    rec = {"phase": "terrain_check", "N": PERC_N, "queries": len(xy),
           "sdf_shape": list(out["cpu"]["sdf"].shape), "max_abs_err": errs,
           "rtol": TERRAIN_RTOL, "atol": ATOL, "ok": not bad, **times}
    emit(rec)
    if bad:
        raise SystemExit(f"terrain_check: the card disagrees with the CPU in {bad}")
    return rec


def profile_legged(torch, cfg, batch, path=None):
    """Stage times of one SQP iteration of the legged tick at the cold start
    (host-clock medians, each stage synchronised), the two QR routes of the
    projection side by side, and the card's busy share over one whole solve.
    ``cfg`` is the flagship tick's (``legged_setup``), the perceptive lane's
    (``perceptive_setup``) or the loopshaped trot's (``loopshaping_setup``,
    nx = 48, whose costs are not PSD by structure: its Hessian correction,
    ``eigh`` on [N, 72, 72], is a stage of its own)."""
    from ocs2_tpu_torch.oc.approx import approximate_lq, example_params
    from ocs2_tpu_torch.oc.metrics import al_dual_ascent, al_merit, evaluate_trajectory
    from ocs2_tpu_torch.ops import projection, riccati
    from ocs2_tpu_torch.solvers import sqp
    from ocs2_tpu_torch.solvers.al import AlState, augment_problem

    timed = lambda fn: timed_stage(torch, fn)  # noqa: E731
    problem, grid, params, st = cfg["problem"], cfg["grid"], cfg["params"], cfg["settings"]
    n, nx, nu = grid.num_intervals, problem.nx, problem.nu
    path = path or f"legged_sqp_b{batch}"
    i = torch.arange(batch, dtype=torch.float32, device=DEVICE)[:, None]
    x0s = cfg["x0"][None] + 1e-3 * torch.sin(i * torch.arange(nx, device=DEVICE)[None, :])
    xs = x0s[:, None, :].expand(batch, n + 1, nx).contiguous()
    us = cfg["us_init"].expand(batch, n, nu).contiguous()
    aug = augment_problem(problem, project_equalities=True)
    dims = problem.constraint_dims(example_params(params, DEVICE), device=DEVICE)
    al = AlState.init(dims, n, st.al_rho_init, batch=(batch,), device=DEVICE)
    p_al = dict(params, al=al)

    stages = {}
    lq, stages["approximate_lq_ms"] = timed(
        lambda: approximate_lq(aug, grid, xs, us, p_al, method=st.integrator,
                               substeps=st.substeps))
    coeffs = riccati.LqrCoeffs(
        A=lq.dynamics.dfdx, B=lq.dynamics.dfdu, b=lq.dynamics.f - xs[:, 1:],
        Qxx=lq.cost.dfdxx[:, :-1], qx=lq.cost.dfdx[:, :-1],
        Quu=lq.cost.dfduu[:, :-1] + st.hessian_reg * torch.eye(nu, device=DEVICE),
        qu=lq.cost.dfdu[:, :-1], Qux=lq.cost.dfdux[:, :-1],
        Qf=lq.cost.dfdxx[:, -1], qf=lq.cost.dfdx[:, -1])
    if not aug.cost_structure_psd:
        coeffs, stages[f"convexify_{st.hessian_correction}_ms"] = timed(
            lambda: riccati.convexify(coeffs, st.hessian_reg, method=st.hessian_correction))
    d_t = lq.eq.dfdu.transpose(-1, -2)
    _, stages["qr_torch_linalg_ms"] = timed(lambda: torch.linalg.qr(d_t, mode="complete"))
    _, stages["qr_householder_ms"] = timed(lambda: projection.householder_qr(d_t))
    (reduced, proj), stages["project_lqr_coeffs_ms"] = timed(
        lambda: projection.project_lqr_coeffs(coeffs, lq.eq.f, lq.eq.dfdx, lq.eq.dfdu))
    reduced = riccati.LqrCoeffs(*(leaf.contiguous() for leaf in reduced))
    reg = torch.full((batch,), st.reg_init, device=DEVICE)
    sol, stages["riccati_backward_ms"] = timed(lambda: riccati.lqr_backward(reduced, reg))
    (dxs, dvs), stages["lqr_forward_ms"] = timed(
        lambda: riccati.lqr_forward(reduced, sol, torch.zeros((batch, nx), device=DEVICE)))
    dus, stages["remap_ms"] = timed(lambda: (
        projection.remap_projected_input(proj, dxs[:, :-1], dvs),
        projection.remap_projected_gain(proj, sol.gains))[0])
    a4 = (st.alpha_decay ** torch.arange(st.num_alphas, device=DEVICE))[None, :, None, None]
    xs_c, us_c = xs[:, None] + a4 * dxs[:, None], us[:, None] + a4 * dus[:, None]
    metrics, stages["evaluate_candidates_ms"] = timed(
        lambda: evaluate_trajectory(problem, grid, xs_c, us_c, params))
    _, stages["candidate_defects_ms"] = timed(
        lambda: sqp._defects(problem, grid, xs_c, us_c, params, st.integrator, st.substeps))
    al_c = AlState(*(a.unsqueeze(1) for a in al))
    _, stages["al_merit_and_dual_update_ms"] = timed(
        lambda: (al_merit(metrics, al_c), al_dual_ascent(metrics, al_c)))

    emit({"phase": "profile_stages", "path": path, "B": batch, "N": n, "stages": stages})
    x0 = x0s if batch > 1 else cfg["x0"]
    busy = device_busy(torch, lambda: legged_solve(cfg, x0, cfg["us_init"]))
    emit({"phase": "profile", "path": path, "B": batch, "N": n, "profiler": busy})
    return stages


def profile_ipm(torch, cfg, batch):
    """Stage times of one IPM iteration of the legged robot with the hard
    cone at the cold start (host-clock medians, each stage synchronised):
    the LQ approximation with the cone's rows, the condensation, the
    projection, the sweep, the forward pass, the slack/dual directions with
    the fraction-to-boundary rule, and the line search's candidates; and the
    card's busy share over one whole solve."""
    import dataclasses

    from ocs2_tpu_torch.oc.approx import approximate_lq, example_params
    from ocs2_tpu_torch.oc.metrics import evaluate_trajectory
    from ocs2_tpu_torch.ops import projection, riccati
    from ocs2_tpu_torch.solvers import ipm, sqp
    from ocs2_tpu_torch.solvers.al import AlState, augment_problem

    timed = lambda fn: timed_stage(torch, fn)  # noqa: E731
    problem, grid, params, st = cfg["problem"], cfg["grid"], cfg["params"], cfg["settings"]
    n, nx, nu = grid.num_intervals, 24, 24
    i = torch.arange(batch, dtype=torch.float32, device=DEVICE)[:, None]
    x0s = cfg["x0"][None] + 1e-3 * torch.sin(i * torch.arange(nx, device=DEVICE)[None, :])
    xs = x0s[:, None, :].expand(batch, n + 1, nx).contiguous()
    us = cfg["us_init"].expand(batch, n, nu).contiguous()
    eq_only = dataclasses.replace(problem, inequality_terms=(), state_inequality_terms=())
    aug = dataclasses.replace(augment_problem(eq_only, project_equalities=True),
                              inequality_terms=problem.inequality_terms)
    dims = problem.constraint_dims(example_params(params, DEVICE), device=DEVICE)
    al = AlState.init(dims, n, st.al_rho_init, batch=(batch,), device=DEVICE)
    metrics = evaluate_trajectory(problem, grid, xs, us, params)
    mu = torch.full((batch,), st.mu_init, device=DEVICE)
    s, v = ipm._init_slack_dual(metrics.h_ineq, mu, st.slack_init_min, None)
    empty = torch.zeros((batch, n + 1, 0), device=DEVICE)
    ipm_vars = ipm.IpmVars(s, v, empty, empty, mu)

    stages = {}
    lq, stages["approximate_lq_ms"] = timed(
        lambda: approximate_lq(aug, grid, xs, us, dict(params, al=al), method=st.integrator))
    d, stages["condense_ms"] = timed(lambda: ipm._condense(lq, ipm_vars))
    coeffs = riccati.LqrCoeffs(
        A=lq.dynamics.dfdx, B=lq.dynamics.dfdu, b=lq.dynamics.f - xs[:, 1:],
        Qxx=lq.cost.dfdxx[:, :-1] + d[0], qx=lq.cost.dfdx[:, :-1] + d[1],
        Quu=lq.cost.dfduu[:, :-1] + d[2] + st.hessian_reg * torch.eye(nu, device=DEVICE),
        qu=lq.cost.dfdu[:, :-1] + d[3], Qux=lq.cost.dfdux[:, :-1] + d[4],
        Qf=lq.cost.dfdxx[:, -1] + d[5], qf=lq.cost.dfdx[:, -1] + d[6])
    (reduced, proj), stages["project_lqr_coeffs_ms"] = timed(
        lambda: projection.project_lqr_coeffs(coeffs, lq.eq.f, lq.eq.dfdx, lq.eq.dfdu))
    reduced = riccati.LqrCoeffs(*(leaf.contiguous() for leaf in reduced))
    reg = torch.zeros((batch,), device=DEVICE)
    sol, stages["riccati_backward_ms"] = timed(lambda: riccati.lqr_backward(reduced, reg))
    (dxs, dvs), stages["lqr_forward_ms"] = timed(
        lambda: riccati.lqr_forward(reduced, sol, torch.zeros((batch, nx), device=DEVICE)))
    dus = projection.remap_projected_input(proj, dxs[:, :-1], dvs)
    _, stages["slack_dual_steps_and_ftb_ms"] = timed(lambda: (
        ipm._ftb_alpha(s, ipm._slack_dual_steps(lq, ipm_vars, dxs, dus)[0], st.ftb_margin)))
    a4 = (st.alpha_decay ** torch.arange(st.num_alphas, device=DEVICE))[None, :, None, None]
    xs_c, us_c = xs[:, None] + a4 * dxs[:, None], us[:, None] + a4 * dus[:, None]
    _, stages["evaluate_candidates_ms"] = timed(
        lambda: evaluate_trajectory(problem, grid, xs_c, us_c, params))
    _, stages["candidate_defects_ms"] = timed(
        lambda: sqp._defects(problem, grid, xs_c, us_c, params, st.integrator, st.substeps))
    path = f"legged_ipm_b{batch}"
    emit({"phase": "profile_stages", "path": path, "B": batch, "N": n, "stages": stages})
    x0 = x0s if batch > 1 else cfg["x0"]
    busy = device_busy(torch, lambda: ipm_solve(cfg, x0, cfg["us_init"]))
    emit({"phase": "profile", "path": path, "B": batch, "N": n, "profiler": busy})
    return stages


def profile_perceptive(torch, cfg):
    """Stages of one perceptive tick (host-clock medians, each synchronised):
    the host re-plan, the plan's copy, the grid, then one SQP iteration's
    stages (``profile_legged`` on the lane's problem) and the whole solve;
    the card's busy share over one tick; and where the card's time goes in
    the terrain's own work: the share of gather kernels in one
    approximate_lq of the elevation-map problem, and the distance transform
    of ElevationMap.sdf."""
    from ocs2_tpu_torch.models.legged_robot import interface, terrain
    from ocs2_tpu_torch.models.legged_robot.foothold_planner import plan_footholds, plan_to_params
    from ocs2_tpu_torch.oc.approx import approximate_lq

    timed = lambda fn, reps=3: timed_stage(torch, fn, reps)  # noqa: E731
    x = cfg["x0"]
    stages = {}
    plan, stages["plan_footholds_ms"] = timed(lambda: plan_footholds(
        cfg["terrain_host"], cfg["em_host"], cfg["grid"].times, cfg["grid"].modes, x,
        cfg["target_host"]))
    params, stages["plan_copy_ms"] = timed(lambda: plan_to_params(plan, cfg["params"]))
    _, stages["make_time_grid_ms"] = timed(lambda: trot_grid(PERC_HORIZON, PERC_N))
    stages.update(profile_legged(torch, dict(cfg, params=params), 1, path="perceptive_mpc"))
    _, stages["solve_ms"] = timed(lambda: legged_solve(dict(cfg, params=params), x,
                                                       cfg["us_init"]), reps=1)
    emit({"phase": "profile_stages", "path": "perceptive_mpc_tick", "N": PERC_N,
          "stages": stages})
    busy = device_busy(torch, lambda: legged_solve(dict(cfg, params=perceptive_plan(cfg, x)), x,
                                                   cfg["us_init"]))
    emit({"phase": "profile", "path": "perceptive_mpc_tick", "N": PERC_N, "profiler": busy})

    em = cfg["em"]
    problem = terrain.make_perceptive_problem(em, device=DEVICE)
    grid = cfg["grid"]
    xs = cfg["x0"][None, None].expand(1, PERC_N + 1, 24).contiguous()
    us = cfg["us_init"][None]
    p = interface.make_params(grid, device=DEVICE)
    for name, fn in (("elevation_problem_approximate_lq",
                      lambda: approximate_lq(problem, grid, xs, us, p, method="rk2")),
                     ("elevation_map_sdf", lambda: em.sdf(-0.1, 0.5))):
        emit({"phase": "profile", "path": name, "kernels": kernel_split(torch, fn)})


def kernel_split(torch, fn, top=8):
    """Device time of one call of fn by kernel family from torch.profiler:
    the total, the share of gather / index kernels, and the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0), e.count)
            for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    total = sum(r[1] for r in rows)
    if total <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    gather = sum(r[1] for r in rows if any(w in r[0].lower() for w in ("index", "gather")))
    rows.sort(key=lambda r: -r[1])
    return {"device_us": total, "wall_us_under_profiler": wall_us,
            "device_busy_share": total / wall_us, "gather_index_us": gather,
            "gather_index_share_of_device": gather / total,
            "top": [{"name": k[:80], "device_us": d, "count": c} for k, d, c in rows[:top]]}


def device_busy(torch, fn):
    """The card's busy share over one call of fn, from torch.profiler: the sum
    of the kernels' device time over the wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = 1e6 * (time.perf_counter() - t0)
    dev_us = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages())
    if dev_us <= 0:
        raise SystemExit("torch.profiler recorded no device time")
    return {"device_busy_us": dev_us, "wall_us_under_profiler": wall_us,
            "device_busy_share": dev_us / wall_us}


def timed_stage(torch, fn, reps=3):
    """fn's result and the host-clock median of its time in ms, each run
    ending in a synchronise; the first run warms up."""
    out, secs = None, []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if i:
            secs.append(time.perf_counter() - t0)
    return out, 1e3 * statistics.median(secs)


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

    timed = lambda fn: timed_stage(torch, fn)  # noqa: E731

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
    busy = device_busy(torch, lambda: ddp.solve(problem, grid, x0s, params, settings=settings))
    emit({"phase": "profile", "path": "ballbot_ilqr_b4096", "B": batch, "N": n,
          "stages": stages, "profiler": busy})


def ptxas_report(jobs, logs):
    """Registers, stack frame and spill of each library of ``jobs``, from
    ptxas' report ({(source, defines): log} of _build.build_libraries); a
    library found already built (not compiled in this run) is marked so."""
    import re

    out = {}
    for source, defines in jobs:
        name = (source.rsplit(".", 1)[0] + " " + "_".join(
            d[2:].replace("=", "").lower() for d in defines)).strip()
        log = logs.get((source, tuple(defines)))
        if log is None:
            out[name] = "already built"
            continue
        regs = re.findall(r"Used (\d+) registers", log)
        frame = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                           r"(\d+) bytes spill loads", log)
        out[name] = {"registers": max(map(int, regs)) if regs else None,
                     "stack_frame_bytes": max((int(f[0]) for f in frame), default=None),
                     "spill_store_bytes": max((int(f[1]) for f in frame), default=None),
                     "spill_load_bytes": max((int(f[2]) for f in frame), default=None)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also time the stages of one iteration of every path, of one MPC "
                         "tick and of one control step")
    ap.add_argument("--skip-main-path", action="store_true",
                    help="build and check the kernels only (no final ok line)")
    ap.add_argument("--iterations-out", metavar="PATH",
                    help="write the quadrotor batch's per-scenario iterations and merits "
                         "as JSON (for tools/quadrotor_reference_iterations.py)")
    ap.add_argument("--closed-loop-out", metavar="PATH",
                    help="write the closed loop's iterations per tick and states as JSON "
                         "(for tools/legged_closed_loop_reference.py)")
    ap.add_argument("--perceptive-out", metavar="PATH",
                    help="write both perceptive phases' iterations per tick and states as "
                         "JSON (for tools/perceptive_reference.py)")
    ap.add_argument("--comkino-out", metavar="PATH",
                    help="write the ComKino closed loop's iterations, merits per tick and "
                         "states as JSON (for tools/comkino_reference.py --compare)")
    ap.add_argument("--ipm-out", metavar="PATH",
                    help="write the IPM chains' tick states, iterations and merits and the "
                         "cold solve as JSON (for tools/legged_ipm_reference.py --compare)")
    ap.add_argument("--hybrid-out", metavar="PATH",
                    help="write the hybrid solve's events, modes, cost, states and inputs as "
                         "JSON (for tools/hybrid_reference.py --compare)")
    ap.add_argument("--mpcnet-out", metavar="PATH",
                    help="write the MPC-Net lanes' losses, evaluations, non-finite QP steps "
                         "and the b256 round's distance from the record as JSON (for "
                         "tools/mpcnet_reference.py --compare)")
    ap.add_argument("--loopshaping-out", metavar="PATH",
                    help="write the loopshaped trot's and the unshaped solve's states, inputs "
                         "and shaping functionals and the loopshaped closed loop's iterations "
                         "and states as JSON (for tools/loopshaping_reference.py --compare)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1

    from ocs2_tpu_torch.ops import (_build, lq_srbd_cuda, riccati, riccati_ct, riccati_ct_cuda,
                                    riccati_cuda)

    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    # Every library of both kernels, one nvcc each, all started together;
    # ptxas' registers and spill of each build.
    t0 = time.perf_counter()
    pairs = sorted({(nx, nu) for nx, nu, _, _ in KERNEL_SHAPES + [HYB_SHAPE, LS_SHAPE]
                    + ZOO_SHAPES})
    ct_pairs = sorted({(nx, nu) for nx, nu, _, _, _ in CT_SHAPES + [ZOO_CT_SHAPE]})
    jobs = (riccati_cuda.build_jobs(pairs) + riccati_ct_cuda.build_jobs(ct_pairs)
            + lq_srbd_cuda.build_jobs())
    logs = {}
    _build.build_libraries(jobs, logs=logs)
    emit({"phase": "build", "libraries": [f"riccati_backward nx{a}_nu{b}" for a, b in pairs]
          + [f"riccati_ct_backward nx{a}_nu{b}" for a, b in ct_pairs] + ["lq_srbd"],
          "seconds": time.perf_counter() - t0, "ptxas": ptxas_report(jobs, logs)})

    emit({"phase": "kernels", "kernels": ["riccati_backward", "riccati_ct_backward",
                                          "lqr_backward_parallel", "lq_srbd"],
          "shapes": [list(s) for s in KERNEL_SHAPES + [STRICT_SHAPE, PERC_SHAPE, LOOP_SHAPE,
                                                       CK_TROT_SHAPE, SLP_SHAPE, HYB_SHAPE,
                                                       SWITCH_SHAPE] + ZOO_SHAPES
                     + [LS_SHAPE, LS_LOOP_SHAPE, LS_BATCH_SHAPE]
                     + list(MPCNET_SHAPES.values()) + list(MPCNET_EVAL_SHAPES.values())
                     + [DRYRUN_SHAPE]],
          "parallel_shapes": [list(s) for s in K7_SHAPES],
          "ct_shapes": [list(s[:4]) for s in CT_SHAPES + [ZOO_CT_SHAPE]],
          "lq_srbd_shapes": [list(s) for s in K10_SHAPES]})
    checks = [
        check_kernel(torch, riccati, riccati_cuda, shape, seed=11 + i, timed=i < 3)
        for i, shape in enumerate(KERNEL_SHAPES)
    ]
    at_b1 = check_kernel(torch, riccati, riccati_cuda, STRICT_SHAPE, seed=21, timed=True)
    check_strict_nan(torch, riccati, STRICT_SHAPE, seed=22, node=60)
    # The perceptive lanes' strict shapes: the MPC at N = 46, the closed loop at 32.
    at_perc = check_kernel(torch, riccati, riccati_cuda, PERC_SHAPE, seed=23, timed=True)
    at_loop = check_kernel(torch, riccati, riccati_cuda, LOOP_SHAPE, seed=24, timed=True)
    # The ComKino trot solve's shape (the ComKino closed loop runs at LOOP_SHAPE).
    at_trot = check_kernel(torch, riccati, riccati_cuda, CK_TROT_SHAPE, seed=25, timed=True)
    check_strict_nan(torch, riccati, CK_TROT_SHAPE, seed=26, node=17)
    # The SLP phase's SQP check (ballbot at B = 256).
    at_slp = check_kernel(torch, riccati, riccati_cuda, SLP_SHAPE, seed=27, timed=True)
    # The hybrid and switch-time phases' shapes (2 states, 1 input, B = 1).
    at_hyb = check_kernel(torch, riccati, riccati_cuda, HYB_SHAPE, seed=28, timed=True)
    at_switch = check_kernel(torch, riccati, riccati_cuda, SWITCH_SHAPE, seed=29, timed=True)
    # The continuous-time sweep (SLQ).
    ct_checks = [check_ct_kernel(torch, riccati_ct, riccati_ct_cuda, shape, seed=31 + i, timed=True)
                 for i, shape in enumerate(CT_SHAPES)]
    check_ct_nan(torch, riccati_ct, CT_SHAPES[1], seed=34, scenario=0, node=60)
    check_ct_nan(torch, riccati_ct, CT_SHAPES[2], seed=35, scenario=5, node=3)
    # The robot model zoo's shapes: K1 at each, strict NaN placement at
    # (13, 13), a 64-thread group meeting on named barriers; K6 at the
    # cartpole batch's (4, 1), 8 threads a scenario with single-entry tiles.
    zoo = {shape: check_kernel(torch, riccati, riccati_cuda, shape, seed=41 + i, timed=True)
           for i, shape in enumerate(ZOO_SHAPES)}
    check_strict_nan(torch, riccati, (13, 13, 1, 40), seed=50, node=17)
    ct_zoo = check_ct_kernel(torch, riccati_ct, riccati_ct_cuda, ZOO_CT_SHAPE, seed=51, timed=True)
    check_ct_nan(torch, riccati_ct, ZOO_CT_SHAPE, seed=52, scenario=1234, node=37)
    # Loopshaping's (48, 12), the widest pair: the trot's and the closed
    # loop's strict shapes, a clamped batch, and NaN placement with a
    # 256-thread group on a named barrier.
    ls_checks = {shape: check_kernel(torch, riccati, riccati_cuda, shape, seed=61 + i, timed=True)
                 for i, shape in enumerate((LS_SHAPE, LS_LOOP_SHAPE, LS_BATCH_SHAPE))}
    check_strict_nan(torch, riccati, LS_SHAPE, seed=64, node=17)
    at_ls, at_ls_loop = ls_checks[LS_SHAPE], ls_checks[LS_LOOP_SHAPE]
    # MPC-Net's data rounds (clamped batches) and its evaluations (strict).
    mpcnet_checks = {
        lane: check_kernel(torch, riccati, riccati_cuda, shape, seed=71 + i, timed=True)
        for i, (lane, shape) in enumerate(list(MPCNET_SHAPES.items())
                                          + [(f"{k}_eval", v) for k, v in
                                             MPCNET_EVAL_SHAPES.items()])}
    # The dry run's scenario chunks (clamped at B = 2).
    at_dry = check_kernel(torch, riccati, riccati_cuda, DRYRUN_SHAPE, seed=85, timed=True)
    # K10 at the legged lanes' (B, N) and at the benchmark cell's.
    k10_checks = [check_k10(torch, shape, seed=91 + i) for i, shape in enumerate(K10_SHAPES)]
    k10_hard_checks = [check_k10(torch, shape, seed=94 + i, cone="hard")
                       for i, shape in enumerate(K10_SHAPES)]
    if args.skip_main_path:
        return 0
    run = main_path(torch, riccati_cuda)
    cfg = legged_setup(torch)
    b1, cold_b1 = legged_tick_b1(torch, riccati_cuda, cfg)
    b256 = legged_tick_b256(torch, riccati_cuda, cfg, cold_b1)
    closed, iface = legged_mpc_closed_loop(torch, riccati_cuda, args.closed_loop_out)
    quad = quadrotor_sqp_b4096(torch, riccati_cuda, checks[1], args.iterations_out)
    terrain_check(torch)
    perc_cfg = perceptive_setup(torch)
    perc, perc_record = perceptive_mpc(torch, riccati_cuda, perc_cfg, at_perc)
    loop, loop_record = perceptive_closed_loop(torch, riccati_cuda, at_loop)
    if args.perceptive_out:
        with open(args.perceptive_out, "w") as f:
            json.dump({"perceptive_mpc": perc_record, "perceptive_closed_loop": loop_record}, f)
    ck_loop = comkino_perceptive_closed_loop(torch, riccati_cuda, at_loop, args.comkino_out)
    ck_cfg = comkino_trot_setup(torch)
    ck_trot = comkino_trot(torch, riccati_cuda, ck_cfg, at_trot)
    ipm_cfg = legged_ipm_setup(cfg)
    ipm_b1 = legged_ipm_tick_b1(torch, riccati_cuda, ipm_cfg, ipm_out=args.ipm_out)
    ipm_b256 = legged_ipm_b256(torch, riccati_cuda, ipm_cfg)
    slp_run = slp_ballbot_b256(torch, riccati_cuda)
    slq = slq_ballbot_b4096(torch, riccati_cuda, riccati_ct_cuda, run)
    hyb = hybrid_bouncing_mass(torch, riccati_cuda, riccati_ct_cuda, at_hyb, args.hybrid_out)
    switch = switch_time_exp0(torch, riccati_cuda, at_switch)
    # The robot model zoo.
    zoo_seconds = {}
    t0 = time.perf_counter()
    cart = cartpole_swingup_b4096(torch, riccati_cuda, riccati_ct_cuda, zoo[ZOO_SHAPES[0]], ct_zoo)
    zoo_seconds["cartpole_swingup_b4096"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    manip_cfg = manipulator_setup(torch)
    manip_b1 = manipulator_sqp_b1(torch, riccati_cuda, zoo[ZOO_SHAPES[1]], manip_cfg)
    zoo_seconds["manipulator_sqp_b1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    manip_b256 = manipulator_sqp_b256(torch, riccati_cuda, zoo[ZOO_SHAPES[2]], manip_cfg)
    zoo_seconds["manipulator_sqp_b256"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    variants = urdf_variants_b1(
        torch, riccati_cuda, {(nx, nu): zoo[(nx, nu, b, n)] for nx, nu, b, n in ZOO_SHAPES[3:]})
    zoo_seconds["urdf_variants_b1"] = time.perf_counter() - t0
    emit({"phase": "zoo_seconds", **zoo_seconds, "total": sum(zoo_seconds.values())})
    # Loopshaping: the frequency-shaped legged MPC at nx = 48.
    ls_seconds, ls_out = {}, ({} if args.loopshaping_out else None)
    t0 = time.perf_counter()
    ls_cfg = loopshaping_setup(torch)
    ls_trot = loopshaping_trot_b1(torch, riccati_cuda, at_ls, at_trot, ls_cfg, ls_out)
    ls_seconds["loopshaping_trot_b1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ls_loop = loopshaping_closed_loop(torch, riccati_cuda, at_ls_loop, ls_cfg, ls_out)
    ls_seconds["loopshaping_closed_loop"] = time.perf_counter() - t0
    emit({"phase": "loopshaping_seconds", **ls_seconds, "total": sum(ls_seconds.values())})
    if args.loopshaping_out:
        with open(args.loopshaping_out, "w") as f:
            json.dump(ls_out, f)
    # MPC-Net: the training loops and the b256 data round.
    mn_seconds, mn_out = {}, ({} if args.mpcnet_out else None)
    t0 = time.perf_counter()
    mn_legged = mpcnet_legged_train(torch, riccati_cuda, mpcnet_checks["legged"],
                                    mpcnet_checks["legged_eval"], mn_out)
    mn_seconds["mpcnet_legged_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mn_b256 = mpcnet_legged_datagen_b256(torch, riccati_cuda, mpcnet_checks["b256"], mn_out)
    mn_seconds["mpcnet_legged_datagen_b256"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mn_ballbot = mpcnet_ballbot_train(torch, riccati_cuda, mpcnet_checks["ballbot"],
                                      mpcnet_checks["ballbot_eval"], mn_out)
    mn_seconds["mpcnet_ballbot_train"] = time.perf_counter() - t0
    emit({"phase": "mpcnet_seconds", **mn_seconds, "total": sum(mn_seconds.values())})
    if args.mpcnet_out:
        with open(args.mpcnet_out, "w") as f:
            json.dump(mn_out, f)
    # The associative-scan Riccati (K7), the phase profile, the entry step and
    # the multi-device dry run with the horizon-sharded PIPG (K9).
    last_seconds = {}
    t0 = time.perf_counter()
    k7_checks = parallel_riccati_check(torch, riccati, riccati_cuda, {
        MAIN_SHAPE: checks[0], LEGGED_SHAPE: checks[2], STRICT_SHAPE: at_b1})
    last_seconds["parallel_riccati_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pr_b1 = legged_parallel_riccati_b1(torch, riccati, riccati_cuda, cfg, cold_b1)
    last_seconds["legged_parallel_riccati_b1"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pr_ballbot = ballbot_ilqr_parallel_b4096(torch, riccati, riccati_cuda, run)
    last_seconds["ballbot_ilqr_parallel_b4096"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prof = sqp_phase_profile(torch, riccati, riccati_cuda, full=args.profile)
    last_seconds["sqp_phase_profile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ent = entry_step(torch, riccati_cuda)
    last_seconds["entry_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = dryrun_multichip_phase(torch, riccati_cuda)
    last_seconds["dryrun_multichip"] = time.perf_counter() - t0
    emit({"phase": "last_slice_seconds", **last_seconds, "total": sum(last_seconds.values())})
    if args.profile:
        profile_slq(torch)
        profile_main_path(torch)
        profile_legged(torch, cfg, LEGGED_BATCH)
        profile_legged(torch, cfg, 1)
        profile_mpc(torch, iface)
        profile_perceptive(torch, perc_cfg)
        profile_legged(torch, ck_cfg, 1, path="comkino_sqp_b1")
        profile_ipm(torch, ipm_cfg, 1)
        profile_ipm(torch, ipm_cfg, LEGGED_BATCH)
        profile_legged(torch, ls_cfg, 1, path="loopshaping_sqp_b1")
        profile_mpcnet(torch)

    at_main, at_quad, at_legged = checks[0], checks[1], checks[2]
    shape_keys = ("nx", "nu", "B", "N", "pivots", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                  "bound_term", "bytes_ms", "flops_ms", "chain_ms", "design_floor_ms",
                  "max_abs_err")
    b1_sweeps = b1["riccati_launches"] / (1 + b1["chains"] * b1["ticks_per_chain"])
    ipm_b1_sweeps = ipm_b1["riccati_launches"] / (1 + ipm_b1["chains"] * ipm_b1["ticks_per_chain"])
    emit({"kernels": [{
        "name": "riccati_backward", "route": "cuda",
        "source": "ocs2_tpu_torch/csrc/riccati_backward.cu",
        "replaces": "ocs2_tpu/ops/riccati_pallas.py:189",
        "launches": sum(r["riccati_launches"]
                        for r in (run, b1, b256, closed, quad, perc, loop, ck_loop, ck_trot,
                                  ipm_b1, ipm_b256, hyb, switch, manip_b1, manip_b256, variants,
                                  ls_loop))
        + slp_run["sqp_check_riccati_launches"] + cart["ilqr"]["launches"]
        + ls_trot["riccati_launches"] + ls_trot["unshaped"]["riccati_launches"]
        + sum(r["riccati_launches"] + r["evaluate_run"]["riccati_launches"]
              for r in (mn_legged, mn_ballbot)) + mn_b256["riccati_launches"]
        + sum(r["riccati_launches"] for r in prof) + ent["riccati_launches"]
        + dry["riccati_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in checks + [
            at_b1, at_perc, at_loop, at_trot, at_slp, at_hyb, at_switch, at_dry]
            + list(zoo.values()) + list(ls_checks.values()) + list(mpcnet_checks.values())),
        "shape": dict(zip(("nx", "nu", "B", "N"), MAIN_SHAPE)),
        "ms": at_main["kernel_ms"], "plain_ms": at_main["plain_ms"],
        "bound_ms": at_main["bound_ms"], "bound_by": at_main["bound_by"],
        "library_ms": None,
        # One entry per main path, each driven with the count set to 0 just
        # before it and read just after.
        "paths": [
            {"path": "ballbot_ilqr_b4096", "launches": run["riccati_launches"],
             **{k: at_main[k] for k in shape_keys}},
            {"path": "legged_sqp_b256", "launches": b256["riccati_launches"],
             "launches_per_solve": b256["riccati_launches"] / b256["solves_timed"],
             "share_of_solve": b256["riccati_launches"] / b256["solves_timed"]
             * 1e-3 * at_legged["kernel_ms"] / b256["seconds_per_solve"],
             **{k: at_legged[k] for k in shape_keys}},
            {"path": "legged_sqp_b1", "launches": b1["riccati_launches"],
             "launches_per_tick": b1_sweeps,
             "share_of_tick": b1_sweeps * at_b1["kernel_ms"] / b1["tick_ms_median"],
             "single_sweep_ms": at_b1["single_sweep_ms"],
             **{k: at_b1[k] for k in shape_keys}},
            {"path": "legged_mpc_closed_loop", "launches": closed["riccati_launches"],
             "launches_per_tick": closed["riccati_launches"] / closed["ticks"],
             "share_of_tick": closed["riccati_launches"] / closed["ticks"]
             * at_b1["kernel_ms"] / closed["mpc_tick_ms_median"],
             **{k: at_b1[k] for k in shape_keys}},
            {"path": "quadrotor_sqp_b4096", "launches": quad["riccati_launches"],
             "launches_per_solve": quad["launches_per_solve"],
             "share_of_solve": quad["kernel_share_of_solve"],
             **{k: at_quad[k] for k in shape_keys}},
            {"path": "perceptive_mpc", "launches": perc["riccati_launches"],
             "launches_per_tick": perc["riccati_launches"] / perc["ticks"],
             "share_of_tick": perc["kernel_share_of_tick"],
             "single_sweep_ms": at_perc["single_sweep_ms"],
             **{k: at_perc[k] for k in shape_keys}},
            {"path": "perceptive_closed_loop", "launches": loop["riccati_launches"],
             "launches_per_tick": loop["riccati_launches"] / loop["ticks"],
             "share_of_tick": loop["kernel_share_of_tick"],
             "single_sweep_ms": at_loop["single_sweep_ms"],
             **{k: at_loop[k] for k in shape_keys}},
            {"path": "comkino_perceptive_closed_loop", "launches": ck_loop["riccati_launches"],
             "launches_per_tick": ck_loop["riccati_launches"] / ck_loop["ticks"],
             "share_of_tick": ck_loop["kernel_share_of_tick"],
             "single_sweep_ms": at_loop["single_sweep_ms"],
             **{k: at_loop[k] for k in shape_keys}},
            {"path": "comkino_trot", "launches": ck_trot["riccati_launches"],
             "launches_per_solve": ck_trot["riccati_launches"] / ck_trot["solves_timed"],
             "share_of_solve": ck_trot["kernel_share_of_solve"],
             "single_sweep_ms": at_trot["single_sweep_ms"],
             **{k: at_trot[k] for k in shape_keys}},
            {"path": "legged_ipm_b1", "launches": ipm_b1["riccati_launches"],
             "launches_per_tick": ipm_b1_sweeps,
             "share_of_tick": ipm_b1_sweeps * at_b1["kernel_ms"] / ipm_b1["tick_ms_median"],
             "single_sweep_ms": at_b1["single_sweep_ms"],
             **{k: at_b1[k] for k in shape_keys}},
            {"path": "legged_ipm_b256", "launches": ipm_b256["riccati_launches"],
             "launches_per_solve": ipm_b256["launches_per_solve"],
             "share_of_solve": ipm_b256["launches_per_solve"] * 1e-3 * at_legged["kernel_ms"]
             / ipm_b256["seconds_per_solve"],
             **{k: at_legged[k] for k in shape_keys}},
            {"path": "ballbot_sqp_b256 (slp_ballbot_b256's check)",
             "launches": slp_run["sqp_check_riccati_launches"],
             "launches_per_solve": slp_run["sqp_check_riccati_launches"],
             "share_of_solve": slp_run["sqp_check_riccati_launches"] * 1e-3 * at_slp["kernel_ms"]
             / slp_run["sqp_seconds_per_solve"],
             **{k: at_slp[k] for k in shape_keys}},
            {"path": "hybrid_bouncing_mass", "launches": hyb["riccati_launches"],
             "launches_per_solve": hyb["riccati_launches"],
             "share_of_solve": hyb["riccati_launches"] * 1e-3 * at_hyb["kernel_ms"]
             / hyb["seconds_per_solve"],
             "single_sweep_ms": at_hyb["single_sweep_ms"],
             **{k: at_hyb[k] for k in shape_keys}},
            {"path": "switch_time_exp0", "launches": switch["riccati_launches"],
             "share_of_run": switch["riccati_launches"] * 1e-3 * at_switch["kernel_ms"]
             / switch["seconds"],
             "single_sweep_ms": at_switch["single_sweep_ms"],
             **{k: at_switch[k] for k in shape_keys}},
            {"path": "cartpole_swingup_b4096 (iLQR, hard bound)",
             "launches": cart["ilqr"]["launches"], "launches_per_solve": cart["ilqr"]["launches"],
             "share_of_solve": cart["ilqr"]["share_of_solve"],
             **{k: zoo[ZOO_SHAPES[0]][k] for k in shape_keys + ("kernel_ms_queued",)}},
            {"path": "manipulator_sqp_b1", "launches": manip_b1["riccati_launches"],
             "launches_per_solve": manip_b1["riccati_launches"] / len(MANIP_TARGETS),
             "share_of_solve": manip_b1["share_of_solve"],
             "single_sweep_ms": zoo[ZOO_SHAPES[1]]["single_sweep_ms"],
             **{k: zoo[ZOO_SHAPES[1]][k] for k in shape_keys + ("kernel_ms_queued",)}},
            {"path": "manipulator_sqp_b256", "launches": manip_b256["riccati_launches"],
             "launches_per_solve": manip_b256["riccati_launches"],
             "share_of_solve": manip_b256["share_of_solve"],
             **{k: zoo[ZOO_SHAPES[2]][k] for k in shape_keys + ("kernel_ms_queued",)}},
        ] + [
            {"path": f"urdf_variants_b1 ({key})", "launches": v["launches"],
             "launches_per_solve": v["launches"], "share_of_solve": v["share_of_solve"],
             "single_sweep_ms": zoo[(v["nx"], v["nu"], 1, URDF_N)]["single_sweep_ms"],
             **{k: zoo[(v["nx"], v["nu"], 1, URDF_N)][k]
                for k in shape_keys + ("kernel_ms_queued",)}}
            for key, v in variants["variants"].items()
        ] + [
            {"path": "loopshaping_trot_b1", "launches": ls_trot["riccati_launches"],
             "launches_per_solve": ls_trot["launches_per_solve"],
             "share_of_solve": ls_trot["share_of_solve"],
             "single_sweep_ms": at_ls["single_sweep_ms"],
             **{k: at_ls[k] for k in shape_keys + ("kernel_ms_queued",)}},
            {"path": "loopshaping_trot_b1 (the unshaped solve)",
             "launches": ls_trot["unshaped"]["riccati_launches"],
             "launches_per_solve": ls_trot["unshaped"]["riccati_launches"],
             "share_of_solve": ls_trot["unshaped"]["share_of_solve"],
             "single_sweep_ms": at_trot["single_sweep_ms"],
             **{k: at_trot[k] for k in shape_keys + ("kernel_ms_queued",)}},
            {"path": "loopshaping_closed_loop", "launches": ls_loop["riccati_launches"],
             "launches_per_tick": ls_loop["launches_per_tick"],
             "share_of_tick": ls_loop["share_of_tick"],
             "single_sweep_ms": at_ls_loop["single_sweep_ms"],
             **{k: at_ls_loop[k] for k in shape_keys + ("kernel_ms_queued",)}},
        ] + [
            {"path": f"{run['phase']} (data rounds)", "launches": run["riccati_launches"],
             "share_of_data_rounds": run["share_of_data_rounds"],
             **{k: mpcnet_checks[lane][k] for k in shape_keys + ("kernel_ms_queued",)}}
            for lane, run in (("legged", mn_legged), ("ballbot", mn_ballbot))
        ] + [
            {"path": f"{run['phase']} (evaluate)",
             "launches": run["evaluate_run"]["riccati_launches"],
             "share_of_evaluate": run["evaluate_share"],
             "single_sweep_ms": mpcnet_checks[f"{lane}_eval"]["single_sweep_ms"],
             **{k: mpcnet_checks[f"{lane}_eval"][k] for k in shape_keys + ("kernel_ms_queued",)}}
            for lane, run in (("legged", mn_legged), ("ballbot", mn_ballbot))
        ] + [
            {"path": "mpcnet_legged_datagen_b256", "launches": mn_b256["riccati_launches"],
             "share_of_data_round": mn_b256["share_of_data_round"],
             **{k: mpcnet_checks["b256"][k] for k in shape_keys + ("kernel_ms_queued",)}},
        ] + [
            {"path": f"sqp_phase_profile (N = {r['N']})", "launches": r["riccati_launches"],
             "riccati_seq_ms": r["report_ms"]["riccati_seq"],
             **{k: (at_loop if r["N"] == ENTRY_N else at_b1)[k]
                for k in shape_keys + ("kernel_ms_queued",)}}
            for r in prof
        ] + [
            {"path": "entry_step", "launches": ent["riccati_launches"],
             "launches_per_solve": ent["riccati_launches"],
             "single_sweep_ms": at_loop["single_sweep_ms"],
             **{k: at_loop[k] for k in shape_keys + ("kernel_ms_queued",)}},
            {"path": "dryrun_multichip (scenario chunks)", "launches": dry["riccati_launches"],
             **{k: at_dry[k] for k in shape_keys + ("kernel_ms_queued",)}},
        ],
        # Shapes held in kernel_check that no lane runs.
        "checks": [{k: ls_checks[LS_BATCH_SHAPE][k] for k in shape_keys + ("kernel_ms_queued",)}],
    }, {
        "name": "riccati_ct_backward", "route": "cuda",
        "source": "ocs2_tpu_torch/csrc/riccati_ct_backward.cu",
        # XLA code in the JAX package (the SLQ sweep), not a Pallas kernel.
        "replaces": "ocs2_tpu/ops/riccati_ct.py:80",
        "launches": slq["riccati_ct_launches"] + cart["slq"]["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in ct_checks + [ct_zoo]),
        "shape": dict(zip(("nx", "nu", "B", "N"), CT_SHAPES[0][:4])),
        "ms": ct_checks[0]["kernel_ms"], "plain_ms": ct_checks[0]["plain_ms"],
        "bound_ms": ct_checks[0]["bound_ms"], "bound_by": ct_checks[0]["bound_by"],
        "library_ms": None,
        "paths": [
            {"path": "slq_ballbot_b4096", "launches": slq["riccati_ct_launches"],
             "launches_per_solve": slq["riccati_ct_launches"] / slq["solves_timed"],
             "share_of_solve": slq["riccati_ct_launches"] / slq["solves_timed"]
             * 1e-3 * ct_checks[0]["kernel_ms"] / slq["seconds_per_solve"],
             **{k: ct_checks[0][k] for k in shape_keys if k in ct_checks[0]}},
            {"path": "cartpole_swingup_b4096 (SLQ)", "launches": cart["slq"]["launches"],
             "launches_per_solve": cart["slq"]["launches"],
             "share_of_solve": cart["slq"]["share_of_solve"],
             **{k: ct_zoo[k] for k in shape_keys + ("kernel_ms_queued",) if k in ct_zoo}},
        ],
        "checks": [{k: c[k] for k in ("nx", "nu", "B", "N", "kernel_ms", "kernel_ms_queued",
                                      "plain_ms", "bound_ms",
                                      "bound_by", "bound_term", "bytes_ms", "flops_ms",
                                      "chain_ms", "max_abs_err", "blocks", "threads",
                                      "shared_bytes", "blocks_per_sm", "waves")}
                   for c in ct_checks + [ct_zoo]],
        "wave_check": ct_checks[0]["wave_check"],
    }, {
        "name": "lqr_backward_parallel", "route": "torch",
        "source": "ocs2_tpu_torch/ops/riccati.py",
        # XLA code in the JAX package (the associative-scan Riccati), not a
        # Pallas kernel; torch ops in the port.
        "replaces": "ocs2_tpu/ops/riccati.py:489",
        "launches": pr_b1["k7_calls"] + pr_ballbot["k7_calls"] + sum(r["k7_calls"] for r in prof),
        "max_abs_err": max(c["max_abs_err"] for c in k7_checks),
        "shape": dict(zip(("nx", "nu", "B", "N"), K7_SHAPES[0])),
        "ms": k7_checks[0]["ms"], "plain_ms": k7_checks[0]["plain_ms"],
        "bound_ms": k7_checks[0]["bound_ms"], "bound_by": k7_checks[0]["bound_by"],
        "library_ms": None,
        "paths": [
            {"path": "legged_parallel_riccati_b1", "launches": pr_b1["k7_calls"],
             "seconds_per_solve": pr_b1["seconds_per_solve"]},
            {"path": "ballbot_ilqr_parallel_b4096", "launches": pr_ballbot["k7_calls"],
             "solves_per_s": pr_ballbot["solves_per_s"]},
        ] + [{"path": f"sqp_phase_profile (N = {r['N']})", "launches": r["k7_calls"],
              "riccati_parallel_ms": r["report_ms"]["riccati_parallel"]} for r in prof],
        "checks": [{k: c[k] for k in ("nx", "nu", "B", "N", "ms", "ms_queued", "k1_ms",
                                      "k7_over_k1", "launches_per_call", "plain_ms", "bound_ms",
                                      "bound_by", "bound_term", "max_abs_err",
                                      "jax_k7_vs_sequential_max_abs")}
                   for c in k7_checks],
    }, {
        "name": "lq_srbd", "route": "cuda", "source": "ocs2_tpu_torch/csrc/lq_srbd.cu",
        # XLA's fusion of vmap over jacfwd in the JAX package, not a Pallas kernel.
        "replaces": "ocs2_tpu/oc/approx.py:approximate_lq",
        "launches": sum(r["k10_launches"] for r in (b1, b256, closed, ent, ipm_b1, ipm_b256)),
        "max_abs_err": max(c["max_abs_err"] for c in k10_checks + k10_hard_checks),
        "shape": dict(zip(("nx", "nu", "B", "N"), (24, 24) + K10_SHAPES[-1])),
        "ms": k10_checks[-1]["kernel_ms"], "ms_queued": k10_checks[-1]["kernel_ms_queued"],
        "plain_ms": k10_checks[-1]["plain_ms"], "bound_ms": k10_checks[-1]["bound_ms"],
        "bound_by": k10_checks[-1]["bound_by"], "library_ms": None,
        # One entry per lane, each driven with the count set to 0 just before
        # it and read just after; the IPM lanes (hard cone) launch the hard
        # variant.
        "paths": [
            {"path": path, "launches": r["k10_launches"], "B": r_shape[0], "N": r_shape[1]}
            for path, r, r_shape in (
                ("legged_sqp_b1", b1, K10_SHAPES[0]), ("legged_sqp_b256", b256, K10_SHAPES[1]),
                ("legged_mpc_closed_loop", closed, K10_SHAPES[0]),
                ("entry_step", ent, (1, ENTRY_N)), ("legged_ipm_b1", ipm_b1, K10_SHAPES[0]),
                ("legged_ipm_b256", ipm_b256, K10_SHAPES[1]))
        ],
        "checks": [{k: c[k] for k in ("cone", "B", "N", "kernel_ms", "kernel_ms_queued",
                                      "plain_ms", "bound_ms", "bound_by", "bytes", "max_abs_err",
                                      "worst_in_tolerance_units", "blocks", "threads")}
                   for c in k10_checks + k10_hard_checks],
    }]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
