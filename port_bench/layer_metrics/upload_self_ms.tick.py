"""Host milliseconds a traced tick spent copying its observations to the
device (``oncde.serve.upload``): the ``spanned`` segment's ``upload``
group (``port_bench/spans.py``)."""

from port_bench import spans


def read(r):
    return spans.span_self_ms(getattr(r, "spanned", None), "upload")
