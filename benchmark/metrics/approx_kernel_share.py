"""LQ approximation (oc/approx.approximate_lq): the share, in percent, of
the run's calls of ``approximate_lq`` that the problem's hand-written kernel
(K10) computed, the rest taking the generic ``vmap`` of ``jacfwd``.

Read from the program's counter ``ocs2_tpu_torch.oc.approx.path_counts``
(calls by path, since the process started); None where the program has no
such counter or made no call."""
import sys


def read(obs):
    counts = getattr(sys.modules.get("ocs2_tpu_torch.oc.approx"), "path_counts", None)
    if not counts:
        return None
    calls = counts.get("kernel", 0) + counts.get("generic", 0)
    return 100.0 * counts.get("kernel", 0) / calls if calls else None
