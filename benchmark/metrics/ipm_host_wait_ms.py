"""Solver entry (solvers/ipm.solve): host milliseconds per IPM loop iteration
in the span ``ipm.host_read``, the one host read of an iteration
(``bool(active.any())``), which waits until the card has run what the host
queued ahead of it.

The mean over the span's occurrences, one an iteration, read from the
program's recorder (``ocs2_tpu_torch.utils.timers.SPANS``); None where the
program has no recorder or recorded no such span."""
import sys


def read(obs):
    spans = getattr(sys.modules.get("ocs2_tpu_torch.utils.timers"), "SPANS", None)
    return None if spans is None else spans.mean_ms("ipm.host_read", "host")
