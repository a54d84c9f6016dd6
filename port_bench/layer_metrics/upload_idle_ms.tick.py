"""Device idle milliseconds a traced tick whose gaps fell, at their middle,
in the copy of its observations to the device (``oncde.serve.upload``):
the ``spanned`` segment's ``upload`` group (``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_idle_ms(getattr(r, "spanned", None), "upload")
