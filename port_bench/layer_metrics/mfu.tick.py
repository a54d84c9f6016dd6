"""A tick's operations (costs.tick_flops) over the window's mean tick
latency at the TF32 peak, in %."""

from port_bench import costs


def read(r):
    mean_s = float(r.window["latencies_ms"].mean()) / 1e3
    return 100.0 * costs.tick_flops(r.cfg, r.mix["series"]) / (mean_s * costs.TF32_FLOPS)
