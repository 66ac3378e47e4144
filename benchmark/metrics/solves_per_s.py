"""End to end: scenarios solved in the measured window over its seconds, by
the host clock, every batch and all the time included."""


def read(obs):
    w = obs.window
    return w.scenarios / w.seconds if w.seconds > 0 else None
