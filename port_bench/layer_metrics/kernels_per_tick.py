"""Device kernel events a traced tick."""


def read(r):
    n = len(r.steady.kernels())
    return n / r.steady.units if n else None
