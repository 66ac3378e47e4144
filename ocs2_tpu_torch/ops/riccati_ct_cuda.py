"""CUDA continuous-time Riccati sweep (SLQ): wrapper of ``csrc/riccati_ct_backward.cu``.

The JAX package leaves ``slq_backward`` (``ocs2_tpu/ops/riccati_ct.py``) to
XLA; on the card its recursion, 16 dependent right-hand-side evaluations an
interval with a Cholesky factor each, is one hand-written kernel with the time
loop and the RK4 steps inside and strict Cholesky pivots.  A group of threads
serves one scenario (16 at (nx, nu) = (10, 3), two scenarios a warp; one
thread where a scenario fits one thread's registers, as at (2, 1)): each
thread keeps its tiles of the symmetric S, of the RK4 sum and of the jump
branch in registers for the whole sweep, an evaluation takes two group
barriers, each step's Cholesky factors are formed in the step before, and the
next node's coefficients are copied while the current interval runs.  Its
plain PyTorch version is ``riccati_ct._slq_backward_plain``.

The state and input sizes are compile-time constants of the kernel: one small
library per ``(nx, nu)`` pair is built with ``nvcc`` at first use (see
``_build.py``) and bound through ``ctypes``.  The scenarios per block are
chosen here, by ``launch_geometry``, so that the batch runs in as few waves as
the card holds (one at the SLQ lane's B = 4096): on the card from the
library's occupancy probe (``riccati_ct_backward_blocks_per_sm``), without one
from ``modelled_blocks_per_sm``, the same arithmetic on the H100's limits.
There is no fallback: on a CUDA tensor the wrapper launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, Iterable, NamedTuple, Optional, Tuple

import torch

from . import _build
from .riccati import LqrSolution
from .riccati_ct import CtLqCoeffs

SOURCE = "riccati_ct_backward.cu"
MAX_DIM = 32
MAX_BLOCK_THREADS = 256  # the kernel's __launch_bounds__
MAX_SHARED_BYTES = 232448  # 227 KB a block
# An H100 SXM's SM, for the occupancy model (the card's own count and the
# library's probe replace it at launch).
NUM_SMS = 132
SM_MAX_BLOCKS = 32
SM_MAX_THREADS = 2048
SM_REGISTERS = 65536
SM_SHARED_BYTES = 233472  # 228 KB
SHARED_BYTES_RESERVED_PER_BLOCK = 1024
# The kernel's __launch_bounds__(256, 2) caps a thread at this many.
MAX_REGISTERS_PER_THREAD = 128

# Number of kernel launches made by slq_backward_cuda (and by nothing else),
# and the (B, N, nx, nu, substeps) of the latest one.
launch_count = 0
last_launch_dims = None

_NODE_NDIM = {"A": 4, "B": 4, "Q": 4, "q": 3, "R": 4, "r": 3, "P": 4,
              "A_jump": 4, "Q_jump": 4, "q_jump": 3, "Qf": 3, "qf": 2,
              "times": 1, "is_jump": 1}


def _pad(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _one_thread(nx: int, nu: int) -> bool:
    """A scenario small enough for one thread's registers (the kernel's
    kOneThread)."""
    return 5 * nx * nx + 2 * (nx + 1) * nu <= 48


def _tiles(nx: int, nu: int) -> int:
    """Tiles of an nx x nx matrix's upper triangle: the whole matrix for a
    one-thread scenario, else 2 x 2 entries, single entries for nx <= 4 (the
    kernel's T)."""
    edge = nx if _one_thread(nx, nu) else (1 if nx <= 4 else 2)
    blocks = -(-nx // edge)
    return blocks * (blocks + 1) // 2


def threads_per_scenario(nx: int, nu: int) -> int:
    """The kernel's group: one thread for a scenario that fits its registers,
    else about two jobs (a tile, or a column of the solve) a thread, a power
    of two from 4 to 32."""
    if _one_thread(nx, nu):
        return 1
    jobs = _tiles(nx, nu) + nx + 1
    p = 1
    while p < (jobs + 1) // 2:
        p *= 2
    return min(32, max(4, p))


def shared_bytes_per_scenario(nx: int, nu: int) -> int:
    """The kernel's shared-memory layout of one scenario: the stage input
    [S | s], G and Z (rows of nx + 1 floats padded to even), four Cholesky
    factors, dv1 and dv2 with two intervals' grid, A, B and [P | r] at one
    theta, the jump data and three node buffers (nx x nx matrices in
    rows padded to even); every array padded to 16 bytes, the whole to (group
    mod 32) banks past a multiple of 32."""
    xp, cp = _pad(nx, 2), _pad(nx + 1, 2)
    coeffs = _pad(nx * xp, 4) + _pad(nx * nu, 4) + _pad(nu * cp, 4)  # A, B, [P | r]
    node = coeffs + _pad(nu * nu, 4) + _pad(nx * xp, 4) + _pad(nx, 4)  # R, Q, q
    jump = 2 * _pad(nx * xp, 4) + _pad(nx, 4)
    factors = 4 * _pad(nu * nu + nu, 4)  # a step's three thetas, a node's own R
    used = _pad(nx * cp, 4) + 2 * _pad(nu * cp, 4) + factors + 8 + coeffs + jump + 3 * node
    group = threads_per_scenario(nx, nu)
    shift = 4 if group < 4 else group % 32
    return 4 * (used + (shift - used % 32) % 32)


def modelled_blocks_per_sm(nx: int, nu: int, spb: int) -> int:
    """Blocks of ``spb`` scenarios an H100 SM holds at once, from its limits
    (blocks, threads, registers at the kernel's cap, shared memory with
    1 KB reserved a block): the CPU-side model of the library's probe."""
    warps = -(-spb * threads_per_scenario(nx, nu) // 32)
    shared = spb * shared_bytes_per_scenario(nx, nu) + SHARED_BYTES_RESERVED_PER_BLOCK
    return min(SM_MAX_BLOCKS, SM_MAX_THREADS // (32 * warps),
               SM_REGISTERS // (32 * warps * MAX_REGISTERS_PER_THREAD),
               SM_SHARED_BYTES // shared)


class LaunchGeometry(NamedTuple):
    blocks: int
    threads: int  # of a block
    shared_bytes: int  # of a block, dynamic
    scenarios_per_block: int
    blocks_per_sm: int  # resident at once
    waves: int  # ceil(blocks / (SMs * blocks_per_sm))


def launch_geometry(nx: int, nu: int, batch: int,
                    blocks_per_sm: Optional[Callable[[int], int]] = None,
                    num_sms: int = NUM_SMS) -> LaunchGeometry:
    """Whole warps a block (as many scenarios as fill one), in the fewest
    waves the SMs hold, and among those the smallest blocks.  ``blocks_per_sm``
    maps scenarios per block to resident blocks per SM: the library's probe
    on the card, ``modelled_blocks_per_sm`` by default."""
    group = threads_per_scenario(nx, nu)
    per = shared_bytes_per_scenario(nx, nu)
    occupancy = blocks_per_sm or (lambda spb: modelled_blocks_per_sm(nx, nu, spb))
    fill = max(1, 32 // group)
    best = None
    for spb in range(fill, min(MAX_BLOCK_THREADS // group, MAX_SHARED_BYTES // per) + 1, fill):
        resident = occupancy(spb)
        if resident < 1:
            continue
        blocks = -(-batch // spb)
        waves = -(-blocks // (num_sms * resident))
        if best is None or waves < best.waves:
            best = LaunchGeometry(blocks=blocks, threads=spb * group, shared_bytes=spb * per,
                                  scenarios_per_block=spb, blocks_per_sm=resident, waves=waves)
    if best is None:
        raise ValueError(f"no launch geometry for nx={nx}, nu={nu}")
    return best


# Further -D flags of every build (tools/riccati_ct_phase_clocks.py sets one
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
    module's layout at first use; later calls touch no file."""
    lib = _LIBRARIES.get((nx, nu))
    if lib is None:
        lib = _build.load_library(SOURCE, _defines(nx, nu))
        fn = lib.riccati_ct_backward_launch
        fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.riccati_ct_backward_blocks_per_sm.argtypes = [ctypes.c_int]
        lib.riccati_ct_backward_blocks_per_sm.restype = ctypes.c_int
        probes = (
            lib.riccati_ct_backward_nx, lib.riccati_ct_backward_nu,
            lib.riccati_ct_backward_threads_per_scenario,
            lib.riccati_ct_backward_shared_bytes_per_scenario,
        )
        for probe in probes:
            probe.argtypes, probe.restype = [], ctypes.c_int
        built = tuple(probe() for probe in probes)
        want = (nx, nu, threads_per_scenario(nx, nu), shared_bytes_per_scenario(nx, nu))
        if built != want:
            raise RuntimeError(
                f"riccati_ct library and wrapper disagree for nx={nx}, nu={nu}: "
                f"(nx, nu, threads, shared bytes) built {built}, wanted {want}"
            )
        _LIBRARIES[(nx, nu)] = lib
    return lib


_CARD_GEOMETRY: Dict[Tuple[int, int, int, int], LaunchGeometry] = {}


def card_geometry(nx: int, nu: int, batch: int, device) -> LaunchGeometry:
    """``launch_geometry`` on the card of ``device``: its SM count and the
    library's occupancy probe (built at first use; cached)."""
    index = device.index if isinstance(device, torch.device) else torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    key = (nx, nu, batch, index)
    geometry = _CARD_GEOMETRY.get(key)
    if geometry is None:
        lib = _library(nx, nu)

        def probe(spb: int) -> int:
            with torch.cuda.device(index):
                blocks = lib.riccati_ct_backward_blocks_per_sm(spb)
            if blocks < 0:
                raise RuntimeError(f"riccati_ct occupancy probe failed: CUDA error {-blocks} "
                                   f"(nx={nx}, nu={nu}, {spb} scenarios a block)")
            return blocks

        sms = torch.cuda.get_device_properties(index).multi_processor_count
        geometry = _CARD_GEOMETRY[key] = launch_geometry(nx, nu, batch, probe, sms)
    return geometry


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
    lib = _library(nx, nu)
    geometry = card_geometry(nx, nu, batch, dev)
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
