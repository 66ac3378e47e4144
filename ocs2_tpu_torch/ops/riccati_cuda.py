"""CUDA Riccati backward sweep: wrapper of ``csrc/riccati_backward.cu``.

Replaces the Pallas TPU kernel ``lqr_backward_pallas`` of
``ocs2_tpu/ops/riccati_pallas.py``.  The kernel runs the time loop inside,
a group of threads per scenario (one per matrix column) and the value
function in shared memory for the whole sweep; it is bound by bytes, so the
wrapper hands it the operands in the batch-minor layout ``[N, n, m, B]``
(neighbouring threads read neighbouring floats).  Its plain PyTorch version
is ``riccati._lqr_backward_batched``.

The state and input sizes are compile-time constants of the kernel: one
small library per ``(nx, nu)`` pair is built with ``nvcc`` at first use (see
``_build.py``) and bound through ``ctypes``.  There is no fallback: on a
CUDA tensor the wrapper launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Iterable, Tuple

import torch

from . import _build
from .riccati import LqrCoeffs, LqrSolution

SOURCE = "riccati_backward.cu"
# The sweep is written for small control-sized blocks (a thread per column,
# one scenario's matrices in shared memory).
MAX_DIM = 32

# Number of kernel launches made by launch_batch_minor (and by nothing else),
# and the (B, N, nx, nu) of the latest one.
launch_count = 0
last_launch_dims = None

_FIELD_NDIM = {
    "A": 4, "B": 4, "b": 3, "Qxx": 4, "qx": 3, "Quu": 4, "qu": 3, "Qux": 4,
    "Qf": 3, "qf": 2,
}


def _defines(nx: int, nu: int) -> Tuple[str, str]:
    return (f"-DNX={nx}", f"-DNU={nu}")


def build(pairs: Iterable[Tuple[int, int]], verbose: bool = False) -> None:
    """Build the libraries of several (nx, nu) pairs at once, in parallel."""
    _build.build_libraries(
        [(SOURCE, _defines(nx, nu)) for nx, nu in pairs], verbose=verbose
    )


def _library(nx: int, nu: int) -> ctypes.CDLL:
    lib = _build.load_library(SOURCE, _defines(nx, nu))
    fn = lib.riccati_backward_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        for probe in (lib.riccati_backward_nx, lib.riccati_backward_nu):
            probe.argtypes, probe.restype = [], ctypes.c_int
        if (lib.riccati_backward_nx(), lib.riccati_backward_nu()) != (nx, nu):
            raise RuntimeError(f"riccati library was not built for nx={nx}, nu={nu}")
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


def to_batch_minor(coeffs: LqrCoeffs, reg, batch: int):
    """The kernel's operands: time-leading, batch-minor copies [N, n, m, B]
    of the stage data, [n, m, B] of the terminal data, and reg as [B]."""
    stage4 = lambda t: t.permute(1, 2, 3, 0).contiguous()  # noqa: E731
    stage3 = lambda t: t.permute(1, 2, 0).contiguous()  # noqa: E731
    reg_b = torch.as_tensor(reg, dtype=torch.float32, device=coeffs.A.device)
    return (
        stage4(coeffs.A), stage4(coeffs.B), stage3(coeffs.b), stage4(coeffs.Qxx),
        stage3(coeffs.qx), stage4(coeffs.Quu), stage3(coeffs.qu), stage4(coeffs.Qux),
        stage3(coeffs.Qf), coeffs.qf.permute(1, 0).contiguous(),
        reg_b.expand(batch).contiguous(),
    )


def launch_batch_minor(operands, batch: int, n: int, nx: int, nu: int):
    """Launch the kernel on batch-minor operands (see to_batch_minor);
    returns the batch-minor results (gains [N, nu, nx, B], kff [N, nu, B],
    value_S [N+1, nx, nx, B], value_s [N+1, nx, B], dv1 [B], dv2 [B])."""
    global launch_count, last_launch_dims
    dev = operands[0].device
    lib = _library(nx, nu)
    new = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)  # noqa: E731
    results = (
        new(n, nu, nx, batch), new(n, nu, batch), new(n + 1, nx, nx, batch),
        new(n + 1, nx, batch), new(batch), new(batch),
    )
    with torch.cuda.device(dev):
        err = lib.riccati_backward_launch(
            *(t.data_ptr() for t in operands + results),
            batch, n, torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"riccati_backward kernel launch failed: CUDA error {err} "
            f"(B={batch}, N={n}, nx={nx}, nu={nu})"
        )
    launch_count += 1
    last_launch_dims = (batch, n, nx, nu)
    return results


def lqr_backward_cuda(coeffs: LqrCoeffs, reg) -> LqrSolution:
    """Batched backward pass on the card; coeffs leaves [B, N, ...], reg [B]
    or scalar (same contract as riccati._lqr_backward_batched).  The result's
    fields are views of batch-minor buffers, permuted to [B, N, ...]."""
    batch, n, nx, nu = check_inputs(coeffs, reg)
    if not coeffs.A.is_cuda:
        raise ValueError("lqr_backward_cuda takes CUDA tensors")
    gains, kff, v_s_mat, v_s_vec, dv1, dv2 = launch_batch_minor(
        to_batch_minor(coeffs, reg, batch), batch, n, nx, nu
    )
    return LqrSolution(
        gains=gains.permute(3, 0, 1, 2),
        kff=kff.permute(2, 0, 1),
        value_S=v_s_mat.permute(3, 0, 1, 2),
        value_s=v_s_vec.permute(2, 0, 1),
        dv1=dv1,
        dv2=dv2,
    )
