"""Solver entry: iterations of a scenario, the mean over every scenario the
measured window solved."""


def read(obs):
    w = obs.window
    return w.iterations_sum / w.scenarios if w.scenarios else None
