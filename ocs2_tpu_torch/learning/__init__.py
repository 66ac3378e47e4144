"""ocs2_tpu_torch.learning — counterpart of ocs2_tpu.learning (MPC-Net)."""
