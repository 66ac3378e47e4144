"""Backward sweep K1: its share of the roofline, from its device time in the
traced window and its shapes (roofline/k1.py)."""


def read(obs):
    return obs.roofline_share("k1")
