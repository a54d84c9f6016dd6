"""Host milliseconds a traced training step spent in the interval adjoint's
forward piece scan (``oncde.cdeint.scan``), less their inner spans'
time: the ``spanned`` segment's ``scan`` group
(``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_self_ms(getattr(r, "spanned", None), "scan")
