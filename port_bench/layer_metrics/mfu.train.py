"""The training step's operations by its schedule (costs.train_step_flops)
over the window's mean step time at the TF32 peak, in %."""

from port_bench import costs


def read(r):
    w = r.window
    flops = costs.train_step_flops(r.cfg, r.mix["series"], r.mix["length"]) * w["units"]
    return 100.0 * flops / (w["window_s"] * costs.TF32_FLOPS)
