"""CUDA continuous-time Riccati sweep (SLQ): wrapper of ``csrc/riccati_ct_backward.cu``.

The JAX package leaves ``slq_backward`` (``ocs2_tpu/ops/riccati_ct.py``) to
XLA; on the card its recursion, 16 dependent right-hand-side evaluations an
interval with a Cholesky each, is one hand-written kernel: a warp per
scenario, the time loop and the RK4 steps inside, every operand and
intermediate in shared memory, strict Cholesky pivots.  Its plain PyTorch
version is ``riccati_ct._slq_backward_plain``.

The state and input sizes are compile-time constants of the kernel: one small
library per ``(nx, nu)`` pair is built with ``nvcc`` at first use (see
``_build.py``) and bound through ``ctypes``.  The scenarios per block are
chosen here, by ``launch_geometry``.  There is no fallback: on a CUDA tensor
the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterable, NamedTuple, Tuple

import torch

from . import _build
from .riccati import LqrSolution
from .riccati_ct import CtLqCoeffs

SOURCE = "riccati_ct_backward.cu"
MAX_DIM = 32
THREADS_PER_SCENARIO = 32  # a warp
MAX_BLOCK_THREADS = 256  # the kernel's __launch_bounds__
MAX_SHARED_BYTES = 232448  # 227 KB a block
# Scenarios a block holds at most (a few warps keep the SM's schedulers busy
# while one waits on shared memory).
MAX_SCENARIOS_PER_BLOCK = 4

# Number of kernel launches made by slq_backward_cuda (and by nothing else),
# and the (B, N, nx, nu, substeps) of the latest one.
launch_count = 0
last_launch_dims = None

_NODE_NDIM = {"A": 4, "B": 4, "Q": 4, "q": 3, "R": 4, "r": 3, "P": 4,
              "A_jump": 4, "Q_jump": 4, "q_jump": 3, "Qf": 3, "qf": 2,
              "times": 1, "is_jump": 1}


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def shared_bytes_per_scenario(nx: int, nu: int) -> int:
    """The kernel's shared-memory layout of one scenario: three node-sized
    coefficient blocks (nodes k and k+1, one theta), the jump data, the value
    and stage buffers, the products, the factor and the solve."""
    node = (2 * _pad4(nx * nx) + _pad4(nx * nu) + _pad4(nx) + _pad4(nu * nu) + _pad4(nu)
            + _pad4(nu * nx))
    floats = (3 * node + 2 * _pad4(nx * nx) + _pad4(nx)          # nodes, C, jump data
              + 4 * (_pad4(nx * nx) + _pad4(nx))                  # S, Sy, KS, SJ (+ vectors)
              + 2 * _pad4(nx * nx) + _pad4(nx)                    # T, U, A's
              + 2 * _pad4(nu * (nx + 1)) + 2 * _pad4(nu * nu))    # G, Z, RR, L
    return 4 * floats


class LaunchGeometry(NamedTuple):
    blocks: int
    threads: int  # of a block
    shared_bytes: int  # of a block, dynamic
    scenarios_per_block: int


def launch_geometry(nx: int, nu: int, batch: int) -> LaunchGeometry:
    """Up to MAX_SCENARIOS_PER_BLOCK warps a block, as the shared memory
    allows; fewer while the batch does not fill every SM with a block."""
    per = shared_bytes_per_scenario(nx, nu)
    cap = min(MAX_SCENARIOS_PER_BLOCK, MAX_BLOCK_THREADS // THREADS_PER_SCENARIO,
              MAX_SHARED_BYTES // per)
    if cap < 1:
        raise ValueError(f"no launch geometry for nx={nx}, nu={nu}")
    spb = max(1, min(cap, batch // 132))
    return LaunchGeometry(
        blocks=-(-batch // spb), threads=spb * THREADS_PER_SCENARIO,
        shared_bytes=spb * per, scenarios_per_block=spb,
    )


def _defines(nx: int, nu: int) -> Tuple[str, ...]:
    return (f"-DNX={nx}", f"-DNU={nu}")


def build_jobs(pairs: Iterable[Tuple[int, int]]):
    """The (source, defines) jobs of several (nx, nu) pairs, for
    ``_build.build_libraries``, which starts the compilers together."""
    return [(SOURCE, _defines(nx, nu)) for nx, nu in pairs]


_LIBRARIES: Dict[Tuple[int, int], ctypes.CDLL] = {}


def _library(nx: int, nu: int) -> ctypes.CDLL:
    """The library of one (nx, nu) pair, built and checked against this
    module's layout at first use; later calls touch no file."""
    lib = _LIBRARIES.get((nx, nu))
    if lib is None:
        lib = _build.load_library(SOURCE, _defines(nx, nu))
        fn = lib.riccati_ct_backward_launch
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        probes = (
            lib.riccati_ct_backward_nx, lib.riccati_ct_backward_nu,
            lib.riccati_ct_backward_threads_per_scenario,
            lib.riccati_ct_backward_shared_bytes_per_scenario,
        )
        for probe in probes:
            probe.argtypes, probe.restype = [], ctypes.c_int
        built = tuple(probe() for probe in probes)
        want = (nx, nu, THREADS_PER_SCENARIO, shared_bytes_per_scenario(nx, nu))
        if built != want:
            raise RuntimeError(
                f"riccati_ct library and wrapper disagree for nx={nx}, nu={nu}: "
                f"(nx, nu, threads, shared bytes) built {built}, wanted {want}"
            )
        _LIBRARIES[(nx, nu)] = lib
    return lib


def check_inputs(coeffs: CtLqCoeffs, reg, substeps: int) -> Tuple[int, int, int, int]:
    """Raise on anything the kernel does not take; returns (B, N, nx, nu).
    Runs before any build, and needs no card."""
    for name, ndim in _NODE_NDIM.items():
        leaf = getattr(coeffs, name)
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"coeffs.{name} must be a tensor, got {type(leaf)}")
        if leaf.dtype != torch.float32:
            raise TypeError(f"coeffs.{name} must be float32, got {leaf.dtype}")
        if leaf.ndim != ndim:
            raise ValueError(f"coeffs.{name} must have {ndim} dims, got {tuple(leaf.shape)}")
        if not leaf.is_contiguous():
            raise ValueError(f"coeffs.{name} must be contiguous")
        if leaf.device != coeffs.A.device:
            raise ValueError(f"coeffs.{name} is on {leaf.device}, coeffs.A on {coeffs.A.device}")
    batch, n1, nx = coeffs.A.shape[0], coeffs.A.shape[1], coeffs.A.shape[2]
    n, nu = n1 - 1, coeffs.B.shape[3]
    if nx > MAX_DIM or nu > MAX_DIM:
        raise ValueError(f"the CT Riccati kernel takes nx, nu <= {MAX_DIM}, got {nx}, {nu}")
    if batch < 1 or n < 1 or nx < 1 or nu < 1:
        raise ValueError(f"empty problem: B={batch}, N={n}, nx={nx}, nu={nu}")
    if not isinstance(substeps, int) or substeps < 1:
        raise ValueError(f"substeps must be a positive int, got {substeps!r}")
    want = {
        "A": (batch, n + 1, nx, nx), "B": (batch, n + 1, nx, nu), "Q": (batch, n + 1, nx, nx),
        "q": (batch, n + 1, nx), "R": (batch, n + 1, nu, nu), "r": (batch, n + 1, nu),
        "P": (batch, n + 1, nu, nx), "A_jump": (batch, n, nx, nx),
        "Q_jump": (batch, n, nx, nx), "q_jump": (batch, n, nx), "Qf": (batch, nx, nx),
        "qf": (batch, nx), "times": (n + 1,), "is_jump": (n,),
    }
    for name, shape in want.items():
        if tuple(getattr(coeffs, name).shape) != shape:
            raise ValueError(
                f"coeffs.{name} must be {shape}, got {tuple(getattr(coeffs, name).shape)}")
    if isinstance(reg, torch.Tensor):
        if reg.dtype != torch.float32:
            raise TypeError(f"reg must be float32, got {reg.dtype}")
        if reg.ndim > 1 or (reg.ndim == 1 and reg.shape[0] != batch):
            raise ValueError(f"reg must be a scalar or [{batch}], got {tuple(reg.shape)}")
        if reg.device != coeffs.A.device:
            raise ValueError(f"reg is on {reg.device}, coeffs.A on {coeffs.A.device}")
    return batch, n, nx, nu


def slq_backward_cuda(coeffs: CtLqCoeffs, reg, substeps: int = 4) -> LqrSolution:
    """The CT sweep of a batch on the card; leaves contiguous float32 (same
    contract as riccati_ct._slq_backward_plain).  The result's fields are
    contiguous [B, ...] tensors."""
    global launch_count, last_launch_dims
    batch, n, nx, nu = check_inputs(coeffs, reg, substeps)
    dev = coeffs.A.device
    if not coeffs.A.is_cuda:
        raise ValueError("slq_backward_cuda takes CUDA tensors")
    geometry = launch_geometry(nx, nu, batch)
    lib = _library(nx, nu)
    reg_b = torch.as_tensor(reg, dtype=torch.float32, device=dev).expand(batch).contiguous()
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    results = (
        new(batch, n, nu, nx), new(batch, n, nu), new(batch, n + 1, nx, nx),
        new(batch, n + 1, nx), new(batch), new(batch),
    )
    with torch.cuda.device(dev):
        err = lib.riccati_ct_backward_launch(
            *(t.data_ptr() for t in (*coeffs, reg_b, *results)),
            batch, n, geometry.scenarios_per_block, substeps,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"riccati_ct_backward kernel launch failed: CUDA error {err} "
            f"(B={batch}, N={n}, nx={nx}, nu={nu}, {geometry})"
        )
    launch_count += 1
    last_launch_dims = (batch, n, nx, nu, substeps)
    return LqrSolution(*results)
