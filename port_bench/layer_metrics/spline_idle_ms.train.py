"""Device idle milliseconds a traced training step whose gaps fell, at
their middle, in the spline built from its coefficients, and h0
(``oncde.spline.setup``): the ``spanned`` segment's ``spline`` group
(``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_idle_ms(getattr(r, "spanned", None), "spline")
