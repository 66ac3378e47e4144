"""Solver entry: milliseconds of the measured window per solver loop
iteration run (a batch solve runs as many loop iterations as its slowest
scenario)."""


def read(obs):
    w = obs.window
    return 1e3 * w.seconds / w.iterations_run if w.iterations_run else None
