"""ocs2_tpu_torch.core — counterpart of ocs2_tpu.core."""
