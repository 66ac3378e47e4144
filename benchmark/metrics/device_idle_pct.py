"""Device: the share of the traced window in which no operation ran on the
device (100 minus the union of the device's operation intervals)."""


def read(obs):
    t = obs.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
