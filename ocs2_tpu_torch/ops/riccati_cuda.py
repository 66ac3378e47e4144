"""CUDA Riccati backward sweep: wrapper of ``csrc/riccati_backward.cu``.

Replaces the Pallas TPU kernel ``lqr_backward_pallas`` of
``ocs2_tpu/ops/riccati_pallas.py``.  The kernel runs the time loop inside, a
group of threads per scenario (2 x 2 register tiles, the value function in
shared memory for the whole sweep, the next node's operands prefetched while
the current one computes), and reads and writes the standard layout
``[B, N, n, m]`` itself: the wrapper copies no operand.  It clamps the
Cholesky pivots or, ``strict``, turns a pivot that is not positive into NaN.
Its plain PyTorch version is ``riccati._lqr_backward_batched`` (with the same
``strict`` flag).

The state and input sizes are compile-time constants of the kernel: one
small library per ``(nx, nu)`` pair is built with ``nvcc`` at first use (see
``_build.py``) and bound through ``ctypes``.  The launch geometry (scenarios
per block from the batch) is chosen here, by ``launch_geometry``, and handed
to the kernel as launch arguments.  There is no fallback: on a CUDA tensor
the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Iterable, NamedTuple, Tuple

import torch

from . import _build
from .riccati import LqrCoeffs, LqrSolution

SOURCE = "riccati_backward.cu"
# The sweep is written for small control-sized blocks (one scenario's
# matrices in shared memory, a column of the solve in a thread's registers).
# 48 is the widest a path needs: the loopshaped legged problem's nx = 24 + 24
# (models/legged_robot/loopshaping_mpc.py), 256 threads and 89,248 bytes of
# shared memory a scenario at (48, 12).
MAX_DIM = 48
# The card's limits the geometry is held to, and the kernel's own.
NUM_SMS = 132
MAX_SHARED_BYTES = 232448  # 227 KB a block
MAX_BLOCK_THREADS = 256  # the kernel's __launch_bounds__ (the card takes 1,024)
MAX_NAMED_BARRIERS = 15  # a group wider than a warp meets on bar.sync 1 ... 15

# Number of kernel launches made by lqr_backward_cuda (and by nothing else),
# and the (B, N, nx, nu) of the latest one.
launch_count = 0
last_launch_dims = None

STAGE_LEAVES = ("A", "B", "b", "Qxx", "qx", "Quu", "qu", "Qux")

_FIELD_NDIM = {
    "A": 4, "B": 4, "b": 3, "Qxx": 4, "qx": 3, "Quu": 4, "qu": 3, "Qux": 4,
    "Qf": 3, "qf": 2,
}


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def stage_leaf_floats(nx: int, nu: int) -> Dict[str, int]:
    """Floats of one node of each per-node leaf: the contiguous run the
    kernel copies into a stage buffer."""
    return {"A": nx * nx, "B": nx * nu, "b": nx, "Qxx": nx * nx, "qx": nx,
            "Quu": nu * nu, "qu": nu, "Qux": nu * nx}


def copy_widths(nx: int, nu: int) -> Dict[str, int]:
    """Bytes per copy of each per-node leaf: 16 where the leaf's per-node run
    is a multiple of 16 bytes (the 1-D bulk copy), else 4 (``cp.async``)."""
    return {k: 16 if (4 * v) % 16 == 0 else 4 for k, v in stage_leaf_floats(nx, nu).items()}


def threads_per_scenario(nx: int, nu: int) -> int:
    """Whole warps, about one thread per 2 x 2 tile of the widest matrix."""
    wide = (max(nx, nu) + 1) // 2
    return 32 * min(8, max(1, (wide * wide + 16) // 32))


def shared_bytes_per_scenario(nx: int, nu: int) -> int:
    """Two stage barriers, the arrays kept for the sweep, two stages of
    operands; every array padded to 16 bytes (the kernel's layout)."""
    kept = (
        3 * _pad4(nx * nx) + _pad4(nx * nu) + 3 * _pad4(nu * nx) + _pad4(nu * nu)
        + _pad4(nu * (nu + nx + 1)) + 3 * _pad4(nx) + 4 * _pad4(nu)
    )
    stage = sum(_pad4(v) for v in stage_leaf_floats(nx, nu).values())
    return 16 + 4 * (kept + 2 * stage)


class LaunchGeometry(NamedTuple):
    blocks: int
    threads: int  # of a block
    shared_bytes: int  # of a block, dynamic
    scenarios_per_block: int


def launch_geometry(nx: int, nu: int, batch: int) -> LaunchGeometry:
    """One scenario a block until every SM has one, then as many as the
    block's limits take: a small batch spreads over the card, a large one
    keeps many warps resident on each SM."""
    group = threads_per_scenario(nx, nu)
    per = shared_bytes_per_scenario(nx, nu)
    cap = min(MAX_BLOCK_THREADS // group, MAX_SHARED_BYTES // per)
    if group > 32:
        cap = min(cap, MAX_NAMED_BARRIERS)
    if cap < 1:
        raise ValueError(f"no launch geometry for nx={nx}, nu={nu}")
    spb = max(1, min(cap, batch // NUM_SMS))
    return LaunchGeometry(
        blocks=-(-batch // spb), threads=spb * group, shared_bytes=spb * per,
        scenarios_per_block=spb,
    )


# Further -D flags of every build (tools/riccati_phase_clocks.py sets one
# before the first launch).
EXTRA_DEFINES: Tuple[str, ...] = ()


def _defines(nx: int, nu: int) -> Tuple[str, ...]:
    return (f"-DNX={nx}", f"-DNU={nu}", *EXTRA_DEFINES)


def build_jobs(pairs: Iterable[Tuple[int, int]]):
    """The (source, defines) jobs of several (nx, nu) pairs, for
    ``_build.build_libraries``, which starts the compilers together."""
    return [(SOURCE, _defines(nx, nu)) for nx, nu in pairs]


def build(pairs: Iterable[Tuple[int, int]], verbose: bool = False) -> None:
    """Build the libraries of several (nx, nu) pairs at once, in parallel."""
    _build.build_libraries(build_jobs(pairs), verbose=verbose)


_LIBRARIES: Dict[Tuple[int, int], ctypes.CDLL] = {}


def _library(nx: int, nu: int) -> ctypes.CDLL:
    """The library of one (nx, nu) pair, built and checked against this
    module's geometry at first use; later calls touch no file."""
    lib = _LIBRARIES.get((nx, nu))
    if lib is None:
        lib = _build.load_library(SOURCE, _defines(nx, nu))
        fn = lib.riccati_backward_launch
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        probes = (
            lib.riccati_backward_nx, lib.riccati_backward_nu,
            lib.riccati_backward_threads_per_scenario,
            lib.riccati_backward_shared_bytes_per_scenario,
            lib.riccati_backward_bulk_leaves,
        )
        for probe in probes:
            probe.argtypes, probe.restype = [], ctypes.c_int
        built = tuple(probe() for probe in probes)
        widths = copy_widths(nx, nu)
        bulk = sum((widths[name] == 16) << i for i, name in enumerate(STAGE_LEAVES))
        want = (nx, nu, threads_per_scenario(nx, nu), shared_bytes_per_scenario(nx, nu), bulk)
        if built != want:
            raise RuntimeError(
                f"riccati library and wrapper disagree for nx={nx}, nu={nu}: "
                f"(nx, nu, threads, shared bytes, bulk leaves) built {built}, wanted {want}"
            )
        _LIBRARIES[(nx, nu)] = lib
    return lib


def check_inputs(coeffs: LqrCoeffs, reg) -> Tuple[int, int, int, int]:
    """Raise on anything the kernel does not take; returns (B, N, nx, nu).
    Runs before any build, and needs no card."""
    for name, ndim in _FIELD_NDIM.items():
        leaf = getattr(coeffs, name)
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"coeffs.{name} must be a tensor, got {type(leaf)}")
        if leaf.dtype != torch.float32:
            raise TypeError(f"coeffs.{name} must be float32, got {leaf.dtype}")
        if leaf.ndim != ndim:
            raise ValueError(
                f"coeffs.{name} must have {ndim} dims [B, ...], got {tuple(leaf.shape)}"
            )
        if not leaf.is_contiguous():
            raise ValueError(f"coeffs.{name} must be contiguous")
        if leaf.device != coeffs.A.device:
            raise ValueError(
                f"coeffs.{name} is on {leaf.device}, coeffs.A on {coeffs.A.device}"
            )
    batch, n, nx, nu = coeffs.A.shape[0], coeffs.A.shape[1], coeffs.A.shape[2], coeffs.B.shape[3]
    if nx > MAX_DIM or nu > MAX_DIM:
        raise ValueError(
            f"the Riccati kernel takes nx, nu <= {MAX_DIM}, got nx={nx}, nu={nu}"
        )
    if batch < 1 or n < 1 or nx < 1 or nu < 1:
        raise ValueError(f"empty problem: B={batch}, N={n}, nx={nx}, nu={nu}")
    want = {
        "A": (batch, n, nx, nx), "B": (batch, n, nx, nu), "b": (batch, n, nx),
        "Qxx": (batch, n, nx, nx), "qx": (batch, n, nx),
        "Quu": (batch, n, nu, nu), "qu": (batch, n, nu),
        "Qux": (batch, n, nu, nx), "Qf": (batch, nx, nx), "qf": (batch, nx),
    }
    for name, shape in want.items():
        if tuple(getattr(coeffs, name).shape) != shape:
            raise ValueError(
                f"coeffs.{name} must be {shape}, got {tuple(getattr(coeffs, name).shape)}"
            )
    if isinstance(reg, torch.Tensor):
        if reg.dtype != torch.float32:
            raise TypeError(f"reg must be float32, got {reg.dtype}")
        if reg.ndim > 1 or (reg.ndim == 1 and reg.shape[0] != batch):
            raise ValueError(f"reg must be a scalar or [{batch}], got {tuple(reg.shape)}")
        if reg.device != coeffs.A.device:
            raise ValueError(f"reg is on {reg.device}, coeffs.A on {coeffs.A.device}")
    return batch, n, nx, nu


def lqr_backward_cuda(coeffs: LqrCoeffs, reg, strict: bool = False) -> LqrSolution:
    """Batched backward pass on the card; coeffs leaves [B, N, ...] contiguous,
    reg [B] or scalar (same contract as riccati._lqr_backward_batched).  The
    result's fields are contiguous [B, N, ...] tensors.  ``strict`` selects
    NaN instead of a clamp on a pivot that is not positive."""
    global launch_count, last_launch_dims
    batch, n, nx, nu = check_inputs(coeffs, reg)
    dev = coeffs.A.device
    if not coeffs.A.is_cuda:
        raise ValueError("lqr_backward_cuda takes CUDA tensors")
    for name, width in copy_widths(nx, nu).items():
        if width == 16 and getattr(coeffs, name).data_ptr() % 16:
            raise ValueError(f"coeffs.{name} must start at a multiple of 16 bytes")
    geometry = launch_geometry(nx, nu, batch)
    lib = _library(nx, nu)
    reg_b = torch.as_tensor(reg, dtype=torch.float32, device=dev).expand(batch).contiguous()
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    results = (
        new(batch, n, nu, nx), new(batch, n, nu), new(batch, n + 1, nx, nx),
        new(batch, n + 1, nx), new(batch), new(batch),
    )
    with torch.cuda.device(dev):
        err = lib.riccati_backward_launch(
            *(t.data_ptr() for t in (*coeffs, reg_b, *results)),
            batch, n, geometry.scenarios_per_block, int(strict),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"riccati_backward kernel launch failed: CUDA error {err} "
            f"(B={batch}, N={n}, nx={nx}, nu={nu}, {geometry})"
        )
    launch_count += 1
    last_launch_dims = (batch, n, nx, nu)
    return LqrSolution(*results)
