"""Builds the CUDA sources of ``csrc/`` into shared libraries with a plain C
interface and loads them with ``ctypes``.

Each library is compiled by ``nvcc`` from the sources in this package at
first use, into ``ocs2_tpu_torch/build/`` (git-ignored).  The file name
carries a hash of the source and of the flags, so an edited source is never
served from a stale library.  Nothing here runs when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOADED: Dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of ocs2_tpu_torch are built "
            "from source at first use and need the CUDA toolkit"
        )
    return nvcc


def library_path(source: str, defines: Sequence[str]) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS + tuple(defines)).encode()
    ).hexdigest()[:12]
    tag = "_".join(d[2:].replace("=", "").lower() for d in defines)
    return BUILD_DIR / f"lib{src.stem}_{tag}_{digest}.so"


def _command(source: str, defines: Sequence[str], out: Path, verbose: bool):
    cmd = [find_nvcc(), *NVCC_FLAGS, *defines]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", str(out), str(CSRC_DIR / source)]


def build_libraries(
    jobs: Iterable[Tuple[str, Sequence[str]]], verbose: bool = False,
    logs: Optional[Dict[Tuple[str, Tuple[str, ...]], str]] = None,
) -> Dict[Tuple[str, Tuple[str, ...]], Path]:
    """Compile every (source, defines) job that is not built yet, all nvcc
    processes started together.  Returns {(source, defines): library path};
    raises with the compiler's output if a build fails.  With ``verbose``
    ptxas' register and spill report of each build is printed; a ``logs``
    dict receives it per job built here."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, []
    for source, defines in jobs:
        key = (source, tuple(defines))
        out = library_path(source, defines)
        paths[key] = out
        if out.exists() or any(p[0] == out for p in procs):
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((out, tmp, key, subprocess.Popen(
            _command(source, defines, tmp, verbose or logs is not None),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    errors = []
    for out, tmp, key, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {out.name}:\n{log}")
            continue
        os.replace(tmp, out)
        if logs is not None:
            logs[key] = log
        if verbose and log:
            print(log, flush=True)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load_library(source: str, defines: Sequence[str]) -> ctypes.CDLL:
    """The ctypes handle of one (source, defines) library, built if needed."""
    path = build_libraries([(source, defines)])[(source, tuple(defines))]
    lib = _LOADED.get(path)
    if lib is None:
        lib = _LOADED[path] = ctypes.CDLL(str(path))
    return lib
