"""CPU milliseconds (every thread of the process) a training step over
the measured window of the traced run, before the profiler starts."""


def read(r):
    return 1e3 * r.window["cpu_s"] / r.window["units"]
