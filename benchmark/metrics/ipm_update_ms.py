"""Carry update under IPM (slacks, duals, mu, the AL outer update, the
convergence test, the carry merge and the history write): device
milliseconds per IPM loop iteration in the span ``ipm.update``, idle time
on the stream inside it included.

The mean over the span's occurrences, one an iteration, read from the
program's recorder (``ocs2_tpu_torch.utils.timers.SPANS``); None where the
program has no recorder or recorded no such span."""
import sys


def read(obs):
    spans = getattr(sys.modules.get("ocs2_tpu_torch.utils.timers"), "SPANS", None)
    return None if spans is None else spans.mean_ms("ipm.update", "device")
