"""ocs2_tpu_torch.solvers — counterpart of ocs2_tpu.solvers."""
