"""Legged-robot (quadruped) model: SRBD dynamics, gaits, swing references,
constraints and problem assembly.  Counterpart of
``ocs2_tpu/models/legged_robot``."""
