"""ocs2_tpu_torch.ops — counterpart of ocs2_tpu.ops."""
