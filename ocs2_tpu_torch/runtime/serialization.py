"""Policy flattening for transport.

Counterpart of ``ocs2_tpu/runtime/serialization.py`` (the port's own copy,
numpy only).  A policy is a dict of numpy arrays; flattening packs a small
header plus the raw array bytes, and the reader gets zero-copy views through
``numpy.frombuffer``.  This is the payload moved through
``runtime.native.PolicyStore`` between an MPC process and an MRT process.
A policy of tensors is flattened after ``.cpu().numpy()`` of its leaves.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = b"OC2P"
_DTYPE_CODES = {"<f4": 0, "<f8": 1, "<i4": 2, "<i8": 3}
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def flatten_policy(arrays: Dict[str, np.ndarray]) -> bytes:
    """Pack named arrays into one transportable blob."""
    parts: List[bytes] = []
    index: List[bytes] = []
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        code = _DTYPE_CODES[a.dtype.newbyteorder("<").str]
        name_b = name.encode()
        index.append(
            struct.pack(
                "<HBB", len(name_b), code, a.ndim
            )
            + name_b
            + struct.pack(f"<{a.ndim}q", *a.shape)
        )
        parts.append(a.astype(a.dtype.newbyteorder("<")).tobytes())
    header = _MAGIC + struct.pack("<I", len(arrays))
    blob = header
    for idx, payload in zip(index, parts):
        blob += idx + struct.pack("<q", len(payload)) + payload
    return blob


def unflatten_policy(blob: bytes) -> Dict[str, np.ndarray]:
    """Inverse of flatten_policy."""
    assert blob[:4] == _MAGIC, "bad policy blob"
    (count,) = struct.unpack_from("<I", blob, 4)
    off = 8
    out: Dict[str, np.ndarray] = {}
    for _ in range(count):
        name_len, code, ndim = struct.unpack_from("<HBB", blob, off)
        off += 4
        name = blob[off : off + name_len].decode()
        off += name_len
        shape: Tuple[int, ...] = struct.unpack_from(f"<{ndim}q", blob, off)
        off += 8 * ndim
        (nbytes,) = struct.unpack_from("<q", blob, off)
        off += 8
        arr = np.frombuffer(
            blob, dtype=_CODE_DTYPES[code], count=int(np.prod(shape)) if ndim else 1,
            offset=off,
        ).reshape(shape)
        out[name] = arr
        off += nbytes
    return out


def flatten_linear_policy(times, xs, us, gains, modes=None) -> bytes:
    """Packer of a linear policy: node times, states, inputs, gains and
    (optionally) the mode of every node."""
    arrays = {
        "times": np.asarray(times, np.float32),
        "xs": np.asarray(xs, np.float32),
        "us": np.asarray(us, np.float32),
        "gains": np.asarray(gains, np.float32),
    }
    if modes is not None:
        arrays["modes"] = np.asarray(modes, np.int32)
    return flatten_policy(arrays)
