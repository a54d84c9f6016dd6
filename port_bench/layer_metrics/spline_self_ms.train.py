"""Host milliseconds a traced training step spent in the spline built from
its coefficients, and h0 (``oncde.spline.setup``), less their inner
spans' time: the ``spanned`` segment's ``spline`` group
(``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_self_ms(getattr(r, "spanned", None), "spline")
