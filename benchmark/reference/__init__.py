"""Plain references of the benchmark's configurations.

Each module re-implements one configuration's problem and solver from its
configuration file, in plain PyTorch: no kernel, no code of the program under
test, nothing that the program has made.  ``solve(cfg, x0, arith)`` takes the
starts the benchmark drew and returns what the comparison reads.
"""
