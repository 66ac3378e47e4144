"""K10, the legged SRBD problem's whole LQ approximation on the card:
wrapper of ``csrc/lq_srbd.cu``.

One launch computes every leaf of ``oc.approx.LQData`` for the problems that
``models/legged_robot/interface.make_problem`` builds with the SRBD model and
the projected foot constraint: the discrete dynamics and their Jacobians, the
dt-weighted running cost quadratized in closed form and by Gauss-Newton, the
terminal cost, and the foot constraint's linearization.  Two variants of one
source differ in the friction cone: the soft one (``hard_cone=False``) holds
its relaxed barrier in the cost; the hard one leaves it out of the cost and
writes the cone's 4 rows as the inequality's linearization (``ineq_f``,
``ineq_dfdu``, and ``ineq_dfdx``, exactly zero).  Its plain version is
``oc.approx._approximate_lq_generic`` on the same problem, which ``vmap``s
``jacfwd`` over the nodes.  The discrete dynamics are one step of rk2 (the
explicit midpoint rule), the integrator every caller of this problem runs.
The kernel has no compile-time sizes: one library, built with ``nvcc`` at
first use (``_build.py``) and bound through ``ctypes``; the weights and
constants of the problem are its arguments.
There is no fallback: on CUDA tensors the wrapper launches the kernel or
raises.  ``models/legged_robot/lq_kernel.py`` gathers the inputs and
``oc/approx.approximate_lq`` decides when the kernel serves a call.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

SOURCE = "lq_srbd.cu"
NX = NU = 24
NE = 12  # foot-constraint rows
NI = 4  # the hard variant's inequality rows: the friction cone's, one a leg
THREADS_PER_NODE = NX + NU  # one thread a tangent direction
NODES_PER_BLOCK = 4
# The integrator of core/integrate.discretize the kernel implements, in one step.
METHOD = "rk2"
# The kernel's constants, in the order of its `Constants` struct.
CONSTANTS = (
    "mass", "gravity_x", "gravity_y", "gravity_z", "inertia_x", "inertia_y", "inertia_z",
    *(f"hip_{leg}_{a}" for leg in range(4) for a in "xyz"),
    *(f"lateral_{leg}" for leg in range(4)),
    "thigh", "shank", "euler_rate_cos_floor", "friction_mu", "cone_eps",
    "barrier_mu", "barrier_delta", "height_scale", "velocity_scale",
)

# Number of kernel launches made by lq_srbd_cuda (and by nothing else), and
# the (B, N) of the latest one.
launch_count = 0
last_launch_dims = None


class NodeInputs(NamedTuple):
    """Per-node inputs shared by the scenarios."""

    dt: torch.Tensor  # [N] t[k+1] - t[k]
    is_jump: torch.Tensor  # [N] jump mask
    modes: torch.Tensor  # [N] int32 contact modes
    swing_z: torch.Tensor  # [N, 4] swing height references, a leg each
    swing_vz: torch.Tensor  # [N, 4] swing vertical-velocity references
    x_ref: torch.Tensor  # [N+1, 24] state targets, row N the terminal cost's
    u_ref: torch.Tensor  # [N, 24] input targets


class Weights(NamedTuple):
    Q: torch.Tensor  # [24, 24] running state weight
    R: torch.Tensor  # [24, 24] running input weight
    Qf: torch.Tensor  # [24, 24] terminal weight


class Results(NamedTuple):
    """The kernel's outputs, every one contiguous [B, ...]; the ineq ones are
    the hard variant's, None in the soft one's."""

    cost_f: torch.Tensor  # [B, N+1]
    cost_dfdx: torch.Tensor  # [B, N+1, 24]
    cost_dfdu: torch.Tensor  # [B, N+1, 24]
    cost_dfdxx: torch.Tensor  # [B, N+1, 24, 24]
    cost_dfdux: torch.Tensor  # [B, N+1, 24, 24]
    cost_dfduu: torch.Tensor  # [B, N+1, 24, 24]
    dyn_f: torch.Tensor  # [B, N, 24]
    dyn_dfdx: torch.Tensor  # [B, N, 24, 24]
    dyn_dfdu: torch.Tensor  # [B, N, 24, 24]
    eq_f: torch.Tensor  # [B, N, 12]
    eq_dfdx: torch.Tensor  # [B, N, 12, 24]
    eq_dfdu: torch.Tensor  # [B, N, 12, 24]
    ineq_f: Optional[torch.Tensor] = None  # [B, N, 4]
    ineq_dfdx: Optional[torch.Tensor] = None  # [B, N, 4, 24]
    ineq_dfdu: Optional[torch.Tensor] = None  # [B, N, 4, 24]


def result_shapes(batch: int, n: int, hard_cone: bool = False) -> Results:
    """The outputs' shapes, None for those the variant does not write."""
    ineq = ((batch, n, NI), (batch, n, NI, NX), (batch, n, NI, NU)) if hard_cone else ()
    return Results(
        (batch, n + 1), (batch, n + 1, NX), (batch, n + 1, NU), (batch, n + 1, NX, NX),
        (batch, n + 1, NU, NX), (batch, n + 1, NU, NU), (batch, n, NX), (batch, n, NX, NX),
        (batch, n, NX, NU), (batch, n, NE), (batch, n, NE, NX), (batch, n, NE, NU), *ineq,
    )


def _check(name: str, t, shape: Tuple[int, ...], dtype, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, xs on {device}")


def check_inputs(xs, us, nodes: NodeInputs, weights: Weights,
                 constants: Sequence[float]) -> Tuple[int, int]:
    """Raise on anything the kernel does not take; returns (B, N).  Runs
    before any build, and needs no card."""
    if not isinstance(xs, torch.Tensor) or xs.ndim != 3:
        raise ValueError(f"xs must be a [B, N+1, {NX}] tensor")
    batch, n = xs.shape[0], xs.shape[1] - 1
    if batch < 1 or n < 1:
        raise ValueError(f"empty problem: B={batch}, N={n}")
    f32, dev = torch.float32, xs.device
    _check("xs", xs, (batch, n + 1, NX), f32, dev)
    _check("us", us, (batch, n, NU), f32, dev)
    for name in ("dt", "is_jump"):
        _check(name, getattr(nodes, name), (n,), f32, dev)
    for name in ("swing_z", "swing_vz"):
        _check(name, getattr(nodes, name), (n, 4), f32, dev)
    _check("modes", nodes.modes, (n,), torch.int32, dev)
    _check("x_ref", nodes.x_ref, (n + 1, NX), f32, dev)
    _check("u_ref", nodes.u_ref, (n, NU), f32, dev)
    for name, w in weights._asdict().items():
        _check(name, w, (NX, NX), f32, dev)
    if len(constants) != len(CONSTANTS):
        raise ValueError(f"{len(CONSTANTS)} constants wanted, got {len(constants)}")
    return batch, n


DEFINES: Tuple[str, ...] = ()
_LIBRARY: Optional[ctypes.CDLL] = None


def build_jobs():
    """The (source, defines) job of the library, for
    ``_build.build_libraries``, which starts the compilers together."""
    return [(SOURCE, DEFINES)]


def _library() -> ctypes.CDLL:
    """The library, built and checked against this module at first use;
    later calls touch no file."""
    global _LIBRARY
    if _LIBRARY is None:
        lib = _build.load_library(SOURCE, DEFINES)
        lib.lq_srbd_launch.argtypes = (
            [ctypes.c_void_p] * 27 + [ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                                         ctypes.c_void_p])
        lib.lq_srbd_launch.restype = ctypes.c_int
        probes = (lib.lq_srbd_num_constants, lib.lq_srbd_nodes_per_block,
                  lib.lq_srbd_threads_per_block)
        for probe in probes:
            probe.argtypes, probe.restype = [], ctypes.c_int
        built = tuple(probe() for probe in probes)
        want = (len(CONSTANTS), NODES_PER_BLOCK, NODES_PER_BLOCK * THREADS_PER_NODE)
        if built != want:
            raise RuntimeError(
                f"lq_srbd library and wrapper disagree: (constants, nodes a block, "
                f"threads a block) built {built}, wanted {want}")
        _LIBRARY = lib
    return _LIBRARY


def lq_srbd_cuda(xs, us, nodes: NodeInputs, weights: Weights,
                 constants: Sequence[float], hard_cone: bool = False) -> Results:
    """The LQ approximation of a batch, xs [B, N+1, 24], us [B, N, 24], on
    the card: one launch on the current stream, of the hard variant where
    ``hard_cone``."""
    global launch_count, last_launch_dims
    batch, n = check_inputs(xs, us, nodes, weights, constants)
    if not xs.is_cuda:
        raise ValueError("lq_srbd_cuda takes CUDA tensors")
    lib = _library()
    results = Results(*(None if s is None else torch.empty(s, dtype=torch.float32,
                                                            device=xs.device)
                        for s in result_shapes(batch, n, hard_cone)))
    host_constants = (ctypes.c_float * len(CONSTANTS))(*constants)
    with torch.cuda.device(xs.device):
        err = lib.lq_srbd_launch(
            *(None if t is None else t.data_ptr() for t in (xs, us, *nodes, *weights, *results)),
            batch, n, ctypes.addressof(host_constants), len(CONSTANTS),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lq_srbd kernel launch failed: CUDA error {err} (B={batch}, N={n})")
    launch_count += 1
    last_launch_dims = (batch, n)
    return results
