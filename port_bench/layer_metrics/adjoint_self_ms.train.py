"""Host milliseconds a traced training step spent in the interval adjoint's
reverse solve (``oncde.cdeint.adjoint``), less their inner spans' time:
the ``spanned`` segment's ``adjoint`` group (``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_self_ms(getattr(r, "spanned", None), "adjoint")
