"""ctypes binding of the native real-time runtime (``native/ocs2rt.cpp``).

Counterpart of ``ocs2_tpu/runtime/native.py`` (the port's own copy): a
seqlock policy store in process or in POSIX shared memory, a
deadline-accurate rate loop, a monotonic clock and real-time priority.

The library is built from ``native/ocs2rt.cpp`` where it is, by
``native/Makefile``, at first use (never when this module is imported), into
``native/build/ocs2_tpu_torch/libocs2rt.so`` (git-ignored; the JAX package's
copy builds beside it, into ``native/build/``), and rebuilt when the source
is newer.  The build goes to a temporary directory and is moved into
place, so two processes building at once never load a half-written file. A
failed build raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

_REPO = Path(__file__).resolve().parent.parent.parent
NATIVE_DIR = _REPO / "native"
SOURCE = NATIVE_DIR / "ocs2rt.cpp"
LIB_PATH = NATIVE_DIR / "build" / "ocs2_tpu_torch" / "libocs2rt.so"

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> None:
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=LIB_PATH.parent) as tmp:
        proc = subprocess.run(
            ["make", "-C", str(NATIVE_DIR), f"BUILD={tmp}"],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {SOURCE} failed (make exit {proc.returncode}):\n"
                f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}"
            )
        os.replace(Path(tmp) / "libocs2rt.so", LIB_PATH)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if not LIB_PATH.exists() or LIB_PATH.stat().st_mtime < SOURCE.stat().st_mtime:
            _build_library()
        lib = ctypes.CDLL(str(LIB_PATH))
        lib.ocs2rt_store_create.restype = ctypes.c_void_p
        lib.ocs2rt_store_create.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
        ]
        lib.ocs2rt_store_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ocs2rt_store_write.restype = ctypes.c_int
        lib.ocs2rt_store_write.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ocs2rt_store_read.restype = ctypes.c_int64
        lib.ocs2rt_store_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ocs2rt_store_seq.restype = ctypes.c_uint64
        lib.ocs2rt_store_seq.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_store_capacity.restype = ctypes.c_uint64
        lib.ocs2rt_store_capacity.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_create.restype = ctypes.c_void_p
        lib.ocs2rt_rate_create.argtypes = [ctypes.c_double]
        lib.ocs2rt_rate_wait.restype = ctypes.c_int
        lib.ocs2rt_rate_wait.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_ticks.restype = ctypes.c_uint64
        lib.ocs2rt_rate_ticks.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_missed.restype = ctypes.c_uint64
        lib.ocs2rt_rate_missed.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_rate_destroy.argtypes = [ctypes.c_void_p]
        lib.ocs2rt_monotonic_time.restype = ctypes.c_double
        lib.ocs2rt_monotonic_time.argtypes = []
        lib.ocs2rt_set_realtime_priority.restype = ctypes.c_int
        lib.ocs2rt_set_realtime_priority.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


class PolicyStore:
    """Seqlock blob store for the MPC -> MRT policy handoff.

    In process (name=None) or across processes through POSIX shared memory
    (name='/ocs2_policy').  One writer (the MPC side), any readers (the MRT
    side)."""

    def __init__(self, capacity: int, name: Optional[str] = None,
                 create: bool = True):
        self._lib = load_library()
        self.capacity = capacity
        self.name = name
        self._h = self._lib.ocs2rt_store_create(
            name.encode() if name else None, capacity, 1 if create else 0
        )
        if not self._h:
            raise OSError(f"failed to create policy store (name={name!r})")
        # On attach the native layer adopts the creator's capacity (it
        # validates the shared-memory header before mapping the payload).
        self.capacity = int(self._lib.ocs2rt_store_capacity(self._h))
        self._owner = create
        self._last_seq = 0
        self._buf = ctypes.create_string_buffer(self.capacity)

    def write(self, blob: bytes) -> None:
        rc = self._lib.ocs2rt_store_write(self._h, blob, len(blob))
        if rc != 0:
            raise ValueError(
                f"blob of {len(blob)} bytes exceeds capacity {self.capacity}"
            )

    def read(self, only_new: bool = True) -> Optional[bytes]:
        """Latest blob, or None when empty / unchanged (only_new)."""
        seq = ctypes.c_uint64(0)
        size = self._lib.ocs2rt_store_read(
            self._h, self._buf, self.capacity,
            self._last_seq if only_new else 0,
            ctypes.byref(seq),
        )
        if size in (0, -2):
            return None
        if size < 0:
            raise OSError("policy store read failed")
        self._last_seq = seq.value
        return self._buf.raw[:size]

    def close(self, unlink: bool = False) -> None:
        if self._h:
            self._lib.ocs2rt_store_close(self._h, 1 if unlink else 0)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RateLoop:
    """Deadline-accurate rate loop."""

    def __init__(self, frequency_hz: float):
        self._lib = load_library()
        self._h = self._lib.ocs2rt_rate_create(1.0 / frequency_hz)

    def wait(self) -> int:
        """Sleep to the next tick; returns missed deadlines skipped."""
        return self._lib.ocs2rt_rate_wait(self._h)

    @property
    def ticks(self) -> int:
        return self._lib.ocs2rt_rate_ticks(self._h)

    @property
    def missed(self) -> int:
        return self._lib.ocs2rt_rate_missed(self._h)

    def __del__(self):
        try:
            if self._h:
                self._lib.ocs2rt_rate_destroy(self._h)
        except Exception:
            pass


def monotonic_time() -> float:
    return load_library().ocs2rt_monotonic_time()


def set_realtime_priority(priority: int = 50) -> bool:
    """Best-effort SCHED_FIFO; False when lacking CAP_SYS_NICE."""
    return load_library().ocs2rt_set_realtime_priority(priority) == 0
