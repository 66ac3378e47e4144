#!/usr/bin/env python3
"""Record the JAX package's side of the port's CPU parity tests.

    JAX_PLATFORMS=cpu python3 tools/torch_test_records.py --record [MODULE ...]
    JAX_PLATFORMS=cpu python3 tools/torch_test_records.py --check [MODULE ...]

Each test module named in ``MODULES`` (or on the command line, e.g.
``test_torch_sqp``) lists in ``JAX_RECORDS`` the JAX computations its tests
compare with: solves, LQ approximations, closed loops, each a function of
no arguments.  ``--record`` runs them, jitted as the tests ran them live, and
writes ``tests/torch_data/<module>_jax.npz`` (``tools/_records.py``);
``--check`` runs them again and prints the largest difference from the
stored record (0 on the same machine: the CPU solves are deterministic).
Several minutes, most of it XLA compiling; imports the test modules, hence
both packages.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

MODULES = [
    "test_torch_sqp",
    "test_torch_ipm",
    "test_torch_approx",
    "test_torch_segmented_planes",
    "test_torch_terrain",
    "test_torch_legged_model",
    "test_torch_manipulator",
    "test_torch_cartpole",
    "test_torch_comkino",
    "test_torch_mpc",
    "test_torch_pipg",
    "test_torch_ddp_ballbot",
    "test_torch_urdf",
    "test_torch_rollout_metrics",
    "test_torch_riccati_parallel",
    "test_torch_parallel",
    "test_torch_profiling",
    "test_torch_entry",
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--record", action="store_true", help="write the records")
    mode.add_argument("--check", action="store_true",
                      help="recompute and compare with the stored records")
    ap.add_argument("modules", nargs="*", default=MODULES, help="test modules (default: all)")
    args = ap.parse_args()

    import importlib

    # The tests' CPU of eight devices (tests/conftest.py), for the records
    # that run on a mesh.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from tools import _records

    for name in args.modules:
        t0 = time.perf_counter()
        module = importlib.import_module(name)
        results = {key: jax.tree.map(np.asarray, fn()) for key, fn in module.JAX_RECORDS.items()}
        path = _records.record_path(name)
        if args.record:
            _records.save(path, results)
            print(f"{name}: {len(results)} results -> {os.path.relpath(path, ROOT)} "
                  f"({os.path.getsize(path)} bytes) in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            continue
        stored = _records.Records(name)
        worst = 0.0
        for key, tree in results.items():
            mine = _records.flatten(tree, key)
            theirs = _records.flatten(stored[key], key)
            assert mine.keys() == theirs.keys(), (key, mine.keys() ^ theirs.keys())
            for leaf, val in mine.items():
                if val.dtype.kind in "fc":
                    diff = np.abs(val.astype(np.float64) - theirs[leaf]).astype(np.float64)
                    worst = max(worst, float(np.nanmax(diff)) if diff.size else 0.0)
                    assert np.array_equal(np.isnan(val), np.isnan(theirs[leaf])), leaf
                else:
                    assert np.array_equal(val, theirs[leaf]), leaf
        print(f"{name}: {len(results)} results, largest difference {worst:.3g} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
