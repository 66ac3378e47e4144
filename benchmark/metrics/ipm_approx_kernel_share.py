"""LQ approximation under IPM (oc/approx.approximate_lq): the share, in
percent, of the run's calls of ``approximate_lq`` that K10's hard-cone
variant computed, the rest taking another path (the generic ``vmap`` of
``jacfwd``, or K10's soft variant).

Read from the program's counters ``ocs2_tpu_torch.oc.approx.variant_counts``
(the kernel's calls by variant) and ``path_counts`` (all calls by path),
both since the process started; None where the program has no such
counters or made no call."""
import sys


def read(obs):
    approx = sys.modules.get("ocs2_tpu_torch.oc.approx")
    variants = getattr(approx, "variant_counts", None)
    paths = getattr(approx, "path_counts", None)
    if not variants or not paths:
        return None
    calls = paths.get("kernel", 0) + paths.get("generic", 0)
    return 100.0 * variants.get("hard", 0) / calls if calls else None
