"""One reader a per-layer metric, ``<metric>.py`` with ``read(obs)``: the
metric's value from an ``harness.observe.Observation``, or None where there
is nothing to read (the harness then leaves the metric out of the line)."""
