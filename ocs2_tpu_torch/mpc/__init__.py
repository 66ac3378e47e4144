"""ocs2_tpu_torch.mpc — counterpart of ocs2_tpu.mpc: the receding-horizon
MPC runtime and the MRT (policy consumer) side."""
