"""The benchmark's own tests run on the CPU: ``python -m pytest benchmark/tests``
from the root of the repository.  They put the benchmark's directory first
on the import path, as ``benchmark/run.py`` does."""
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
for p in (str(BENCH_DIR), str(BENCH_DIR.parent)):
    if p not in sys.path:
        sys.path.insert(0 if p == str(BENCH_DIR) else len(sys.path), p)
