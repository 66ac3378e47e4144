"""ocs2_tpu_torch.models — counterpart of ocs2_tpu.models."""
