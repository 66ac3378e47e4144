"""ocs2_tpu_torch.oc — counterpart of ocs2_tpu.oc."""
