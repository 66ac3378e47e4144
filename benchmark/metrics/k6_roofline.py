"""Backward sweep K6: its share of the roofline, from its device time in the
traced window and its shapes (roofline/k6.py)."""


def read(obs):
    return obs.roofline_share("k6")
