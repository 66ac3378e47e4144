"""ocs2_tpu_torch.utils — counterpart of ocs2_tpu.utils (timers only so far)."""
