"""What a metric's reader is handed: the set-up time, the measured window,
the traced window, and a kernel's share of its roofline."""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

from .spec import BENCH_DIR, load_module, read_json
from .trace import Trace
from .window import Window


@dataclasses.dataclass
class Observation:
    window: Window  # the measured window, untraced
    trace: Optional[Trace]  # the traced window, or None
    peak_bytes: int  # torch.cuda.max_memory_allocated() over the measured window
    setup_s: float  # from the start of the process to the first timed solve

    def roofline_share(self, kernel: str) -> Optional[float]:
        """100 x the least time of the last launch's shapes (roofline/<kernel>.py)
        over the kernel's mean device time in the traced window; None where
        the trace holds no launch of it or the program has not launched it."""
        if self.trace is None:
            return None
        rf = load_module("roofline", kernel)
        seen = self.trace.kernel(rf.KERNEL)
        counters = sys.modules.get(rf.COUNTER_MODULE)
        dims = getattr(counters, "last_launch_dims", None)
        if not seen or not seen[0] or dims is None:
            return None
        flops, nbytes = rf.work(*dims)
        peaks = read_json(BENCH_DIR / "roofline" / "peaks.json")
        least_s = max(flops / peaks["float32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
        return 100.0 * least_s / (seen[1] / seen[0])


def read_metric(name: str, obs: Observation) -> Optional[float]:
    return load_module("metrics", name).read(obs)
