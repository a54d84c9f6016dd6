"""Device idle milliseconds a traced training step whose gaps fell, at
their middle, in the interval adjoint's reverse solve
(``oncde.cdeint.adjoint``): the ``spanned`` segment's ``adjoint`` group
(``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_idle_ms(getattr(r, "spanned", None), "adjoint")
