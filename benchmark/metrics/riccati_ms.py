"""Backward sweep (ops/riccati.lqr_backward, K1, with the copies that make
its inputs contiguous): device milliseconds per SQP loop iteration in the
span ``sqp.riccati``, idle time on the stream inside it included.

The mean over the span's occurrences, one an iteration, read from the
program's recorder (``ocs2_tpu_torch.utils.timers.SPANS``); None where the
program has no recorder or recorded no such span."""
import sys


def read(obs):
    spans = getattr(sys.modules.get("ocs2_tpu_torch.utils.timers"), "SPANS", None)
    return None if spans is None else spans.mean_ms("sqp.riccati", "device")
