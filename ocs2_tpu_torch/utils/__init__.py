"""ocs2_tpu_torch.utils — counterpart of ocs2_tpu.utils (all but profiling.py)."""
