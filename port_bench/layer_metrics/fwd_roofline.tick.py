"""Forward field kernel (csrc/fused_field.cu): its calls' bounds over
their device time in one traced tick, in %."""

from port_bench import trace


def read(r):
    return trace.roofline_pct(r.calls, r.cfg, "forward")
