"""Device idle milliseconds a traced training step whose gaps fell, at
their middle, in the interval adjoint's forward piece scan
(``oncde.cdeint.scan``): the ``spanned`` segment's ``scan`` group
(``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_idle_ms(getattr(r, "spanned", None), "scan")
