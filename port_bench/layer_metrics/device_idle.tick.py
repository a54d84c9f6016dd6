"""The share of the traced ticks' wall time in which nothing ran on the
device, in %."""

from port_bench import trace


def read(r):
    return trace.idle_pct(r.steady)
