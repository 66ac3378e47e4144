"""LQ approximation under IPM (oc/approx.approximate_lq, the generic path
for the hard cone, its linearization included): device milliseconds per
IPM loop iteration in the span ``ipm.approx``, idle time on the stream
inside it included.

The mean over the span's occurrences, one an iteration, read from the
program's recorder (``ocs2_tpu_torch.utils.timers.SPANS``); None where the
program has no recorder or recorded no such span."""
import sys


def read(obs):
    spans = getattr(sys.modules.get("ocs2_tpu_torch.utils.timers"), "SPANS", None)
    return None if spans is None else spans.mean_ms("ipm.approx", "device")
